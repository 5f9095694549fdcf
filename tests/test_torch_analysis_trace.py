"""The port's exchange audit (``repro_torch.analysis.trace``, TRACE001-005).

The cases of ``tests/test_analysis_trace.py`` in the port's terms: every
backend's operator audits clean (matvec and one CG chunk, batched nb = 3,
Jacobi and block-Jacobi); a plan that is not the one the operator was
built from is caught — a consistent round swap, which the plan verifier
accepts, gives exactly ``{"TRACE002"}``, a dropped round or an emptied
level TRACE001, no plan or the wrong schedule TRACE003; an injected cast
gives TRACE004 and an f64 leak TRACE005; and the recorded payload bytes
per level equal ``comm_volumes`` / ``tree_comm_volumes`` x itemsize x nb,
on the port's metrics and the reference's alike."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.core.metrics as rmet
import repro_torch.core.metrics as tmet
from repro_torch.analysis import (TRACE_RULES, audit_backend, audit_operator,
                                  verify_plan)
from repro_torch.core.topology import canonical_ancestors
from repro_torch.sparse.generators import GENERATORS, grid
from repro_torch.sparse.graph import laplacian_csr
from repro_torch.sparse.operator import (_HIER_BACKENDS, BACKENDS,
                                        make_operator)
from repro_torch.sparse.replan import (EdgeDelta, apply_delta_csr,
                                       apply_edge_delta)

CPU = "cpu"


def _system(n=144, seed=0, generator="grid_2d"):
    g = GENERATORS[generator](n, seed=seed)
    return (g, g.n) + laplacian_csr(g, shift=0.1)


def _rng_part(nv, k, seed=0):
    # a random partition gives every level several distinct non-empty
    # rounds — what the round-swap mutations need
    return np.random.default_rng(seed).integers(0, k, size=nv)


def _flat_op(backend="dist_halo", k=4, seed=0):
    _, nv, indptr, indices, data = _system(seed=seed)
    return make_operator(indptr, indices, data, backend,
                         part=_rng_part(nv, k, seed), k=k, device=CPU)


def _tree_op(fanouts=(2, 2), seed=0, backend="dist_hier"):
    _, nv, indptr, indices, data = _system(seed=seed)
    k = int(np.prod(fanouts))
    return make_operator(indptr, indices, data, backend,
                         part=_rng_part(nv, k, seed), k=k, device=CPU,
                         fanouts=fanouts)


# -- clean corpus -------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_clean_corpus_default_backends(backend):
    rep = audit_backend(backend, n=144, fanouts=(2, 2), device=CPU)
    assert rep.ok, str(rep)
    assert rep.info["matvec"]["finite"] and rep.info["cg"]["finite"]
    assert (rep.info["exchange"] is None) == (backend in ("coo", "bell"))


@pytest.mark.parametrize("backend", _HIER_BACKENDS)
def test_clean_corpus_depth3(backend):
    rep = audit_backend(backend, n=144, fanouts=(2, 2, 2), device=CPU)
    assert rep.ok, str(rep)


@pytest.mark.parametrize("backend", ["coo", "bell", "dist_halo",
                                     "dist_halo_seq", "dist_allgather",
                                     "dist_hier"])
def test_clean_corpus_batched(backend):
    rep = audit_backend(backend, n=144, fanouts=(2, 2), nb=3, device=CPU)
    assert rep.ok, str(rep)
    assert len(rep.info["cg"]["iters"]) == 3


@pytest.mark.parametrize("backend", ["dist_halo", "dist_bell", "dist_hier",
                                     "dist_hier_bell"])
@pytest.mark.parametrize("precondition", ["jacobi", "block_jacobi"])
def test_clean_corpus_preconditioned(backend, precondition):
    rep = audit_backend(backend, n=144, fanouts=(2, 2),
                        precondition=precondition, device=CPU)
    assert rep.ok, str(rep)


def test_random_partitions_audit_clean():
    for op in (_flat_op(), _flat_op("dist_halo_seq", k=8, seed=1),
               _tree_op(), _tree_op((2, 2, 2), seed=2)):
        rep = audit_operator(op)
        assert rep.ok, str(rep)


def test_rule_table_is_complete():
    assert set(TRACE_RULES) == {"TRACE001", "TRACE002", "TRACE003",
                                "TRACE004", "TRACE005"}


# -- TRACE001 -----------------------------------------------------------------

def test_trace001_dropped_round():
    op = _flat_op()
    mut = dataclasses.replace(op.plan,
                              round_perms=tuple(op.plan.round_perms[:-1]))
    rep = audit_operator(op, plan=mut, solver=False)
    assert rep.codes() == {"TRACE001"}, str(rep)


def test_trace001_level_with_no_rounds():
    op = _tree_op()
    lvl = next(l for l in range(op.plan.h)
               if any(p for p in op.plan.round_perms_lvl[l]))
    rp = list(op.plan.round_perms_lvl)
    rp[lvl] = ((),) * len(rp[lvl])
    mut = dataclasses.replace(op.plan, round_perms_lvl=tuple(rp))
    rep = audit_operator(op, plan=mut, solver=False)
    assert rep.codes() == {"TRACE001"}, str(rep)
    assert any(f"level {lvl}" in d.where for d in rep.diagnostics)


# -- TRACE002 -----------------------------------------------------------------

def _two_distinct_rounds(perms):
    """(c0, c1) of two non-empty rounds with different pair sets."""
    ne = [(c, frozenset(map(tuple, p))) for c, p in enumerate(perms) if p]
    for i, (c0, s0) in enumerate(ne):
        for c1, s1 in ne[i + 1:]:
            if s0 != s1:
                return c0, c1
    raise AssertionError("fixture has no two distinct rounds")


def test_trace002_swapped_permutation():
    op = _flat_op()
    c0, c1 = _two_distinct_rounds(op.plan.round_perms)
    pm = list(op.plan.round_perms)
    pm[c0], pm[c1] = pm[c1], pm[c0]
    mut = dataclasses.replace(op.plan, round_perms=tuple(pm))
    rep = audit_operator(op, plan=mut, solver=False)
    assert rep.codes() == {"TRACE002"}, str(rep)
    assert len(rep.diagnostics) == 2        # both swapped rounds named


def _swap_rounds_consistently(plan, lvl, c0, c1):
    """Exchange rounds c0 and c1 of tree level ``lvl`` consistently:
    perms, send schedule columns, and the halo slot ranges every edge
    reads move together, so the mutated plan satisfies every PLAN0xx
    invariant — a different, equally valid schedule than the one the
    operator was built from (``tests/test_analysis_trace.py``)."""
    offs = plan.level_offsets()
    S = int(plan.S_lvl[lvl])
    a0, a1 = int(offs[lvl]) + c0 * S, int(offs[lvl]) + c1 * S

    def remap(cols):
        cols = cols.clone()
        in0 = (cols >= a0) & (cols < a0 + S)
        in1 = (cols >= a1) & (cols < a1 + S)
        cols[in0] += a1 - a0
        cols[in1] += a0 - a1
        return cols

    perms = list(plan.round_perms_lvl[lvl])
    perms[c0], perms[c1] = perms[c1], perms[c0]
    si = plan.send_idx_lvl[lvl].clone()
    sm = plan.send_mask_lvl[lvl].clone()
    si[:, [c0, c1]] = si[:, [c1, c0]]
    sm[:, [c0, c1]] = sm[:, [c1, c0]]
    rp = list(plan.round_perms_lvl)
    rp[lvl] = tuple(perms)
    sil = list(plan.send_idx_lvl)
    sil[lvl] = si
    sml = list(plan.send_mask_lvl)
    sml[lvl] = sm
    return dataclasses.replace(
        plan, round_perms_lvl=tuple(rp), send_idx_lvl=tuple(sil),
        send_mask_lvl=tuple(sml), cols=remap(plan.cols),
        cols_bnd_lvl=tuple(remap(c) for c in plan.cols_bnd_lvl))


@pytest.mark.parametrize("backend", ["dist_hier", "dist_hier_bell"])
def test_trace002_drift_the_plan_verifier_cannot_catch(backend):
    """A consistent round swap passes the structural verifier (it is a
    valid plan, just not the one the operator runs) and only the exchange
    audit flags it."""
    op = _tree_op(backend=backend)
    lvl = next(l for l in range(op.plan.h)
               if sum(1 for p in op.plan.round_perms_lvl[l] if p) >= 2)
    c0, c1 = _two_distinct_rounds(op.plan.round_perms_lvl[lvl])
    mut = _swap_rounds_consistently(op.plan, lvl, c0, c1)
    vrep = verify_plan(mut)
    assert vrep.ok, str(vrep)
    rep = audit_operator(op, plan=mut)
    assert rep.codes() == {"TRACE002"}, str(rep)
    assert {d.where for d in rep.diagnostics} == {
        f"exchange: level {lvl} round {c0}",
        f"exchange: level {lvl} round {c1}"}


# -- TRACE003 -----------------------------------------------------------------

def test_trace003_exchange_held_against_no_plan():
    rep = audit_operator(_flat_op(), plan=None, solver=False)
    assert rep.codes() == {"TRACE003"}, str(rep)


def test_trace003_allgather_held_against_rounds():
    op = _flat_op("dist_allgather")
    assert audit_operator(op, solver=False).ok
    rep = audit_operator(op, comm="halo", solver=False)
    assert rep.codes() == {"TRACE003"}, str(rep)


def test_trace003_rounds_held_against_allgather():
    rep = audit_operator(_flat_op(), comm="allgather", solver=False)
    assert rep.codes() == {"TRACE003"}, str(rep)


def test_trace003_tree_exchange_against_a_flat_plan():
    """The tree operator's level-0 deliveries stay inside subtrees; held
    against a flat plan over all k blocks, its rounds are not the flat
    schedule's, and its outer levels have no flat level at all."""
    op = _tree_op()
    flat = _flat_op().plan
    rep = audit_operator(op, plan=flat, solver=False)
    assert not rep.ok
    assert rep.codes() <= {"TRACE001", "TRACE002", "TRACE003"}


def test_single_device_operator_against_a_plan_with_rounds():
    _, _, indptr, indices, data = _system()
    op = make_operator(indptr, indices, data, "coo", device=CPU)
    assert audit_operator(op).ok
    rep = audit_operator(op, plan=_flat_op().plan, solver=False)
    assert rep.codes() == {"TRACE001"}, str(rep)


# -- TRACE004 / TRACE005 ------------------------------------------------------

class _Wrapped:
    """An operator whose matvec runs ``fn`` around the inner one."""

    def __init__(self, op, fn):
        self.op, self.fn = op, fn
        self.n, self.vals, self.device = op.n, op.vals, op.device

    def matvec(self, x):
        return self.fn(self.op.matvec, x)

    def diag(self):
        return self.op.diag()


def _coo():
    _, _, indptr, indices, data = _system()
    return make_operator(indptr, indices, data, "coo", device=CPU)


def test_trace004_injected_bf16_roundtrip():
    op = _Wrapped(_coo(), lambda mv, x: mv(x.to(torch.bfloat16)
                                           .to(torch.float32)))
    rep = audit_operator(op)
    assert rep.codes() == {"TRACE004"}, str(rep)
    dirs = {(d.details["src"], d.details["dst"]) for d in rep.diagnostics}
    assert dirs == {("float32", "bfloat16"), ("bfloat16", "float32")}


def test_trace005_f64_leak():
    two = torch.tensor(2.0, dtype=torch.float64)
    op = _Wrapped(_coo(), lambda mv, x: mv(x) * two)
    rep = audit_operator(op, solver=False)
    assert rep.codes() == {"TRACE005"}, str(rep)


def test_upcast_in_the_solver_is_trace004_and_trace005():
    op = _Wrapped(_coo(), lambda mv, x: mv(x).double().float())
    rep = audit_operator(op)
    assert rep.codes() == {"TRACE004", "TRACE005"}, str(rep)
    assert {d.where.split(":")[0] for d in rep.diagnostics} == {"matvec",
                                                                "cg"}


# -- payload bytes: the comm-volume oracle ------------------------------------

def _stripes(shape, k):
    g = grid(shape)
    indptr, indices, data = laplacian_csr(g, shift=0.1)
    return g, indptr, indices, data, (np.arange(g.n) * k) // g.n


# the block-ELL backends are single-RHS, as in the reference
@pytest.mark.parametrize("backend,nb", [
    ("dist_halo", None), ("dist_halo", 3), ("dist_halo_seq", None),
    ("dist_halo_seq", 3), ("dist_bell", None), ("dist_allgather", None),
    ("dist_allgather", 3)])
def test_payload_bytes_match_flat_comm_volumes(backend, nb):
    k = 4
    g, indptr, indices, data, part = _stripes((32, 64), k)
    op = make_operator(indptr, indices, data, backend, part=part, k=k,
                       device=CPU)
    rep = audit_operator(op, nb=nb, solver=False)
    assert rep.ok, str(rep)
    vols = tmet.comm_volumes(g, part, k)
    np.testing.assert_array_equal(vols, rmet.comm_volumes(g, part, k))
    expect = float(vols.sum()) * 4 * (nb or 1)
    assert rep.info["exchange"].payload_bytes_lvl == (expect,)


@pytest.mark.parametrize("fanouts", [(2, 2), (2, 2, 2)])
@pytest.mark.parametrize("backend,nb", [
    ("dist_hier", None), ("dist_hier", 3), ("dist_hier_bell", None)])
def test_payload_bytes_match_tree_comm_volumes(backend, nb, fanouts):
    k = int(np.prod(fanouts))
    g, indptr, indices, data, part = _stripes((32, 64), k)
    op = make_operator(indptr, indices, data, backend, part=part, k=k,
                       device=CPU, fanouts=fanouts)
    rep = audit_operator(op, nb=nb, solver=False)
    assert rep.ok, str(rep)
    anc = canonical_ancestors(fanouts)
    vols = tmet.tree_comm_volumes(g, part, k, anc)
    for v, w in zip(vols, rmet.tree_comm_volumes(g, part, k, anc)):
        np.testing.assert_array_equal(v, w)
    assert rep.info["exchange"].payload_bytes_lvl == tuple(
        float(v.sum()) * 4 * (nb or 1) for v in vols)


def test_patched_plan_audits_like_fresh_build():
    """A delta-patched plan audits clean and records the fresh build's
    payload on the mutated matrix."""
    _, nv, indptr, indices, data = _system()
    part = _rng_part(nv, 4)
    op = make_operator(indptr, indices, data, "dist_hier", part=part, k=4,
                       fanouts=(2, 2), device=CPU)
    # a new symmetric corner-to-corner edge crosses every tree level
    delta = EdgeDelta(nv, set_rows=[0, nv - 1], set_cols=[nv - 1, 0],
                      set_vals=[-1.0, -1.0])
    op2 = dataclasses.replace(op, plan=apply_edge_delta(op.plan, delta))
    rep = audit_operator(op2, solver=False)
    assert rep.ok, str(rep)
    ip2, ix2, d2 = apply_delta_csr(indptr, indices, data, delta)
    fresh = make_operator(ip2, ix2, d2, "dist_hier", part=part, k=4,
                          fanouts=(2, 2), device=CPU)
    ref = audit_operator(fresh, solver=False)
    assert ref.ok, str(ref)
    assert rep.info["exchange"].payload_bytes_lvl == \
        ref.info["exchange"].payload_bytes_lvl


def test_report_is_jsonable():
    rep = audit_backend("dist_hier", n=144, fanouts=(2, 2), device=CPU)
    back = json.loads(json.dumps(rep.to_dict()))
    assert back["ok"] is True
    ex = back["info"]["exchange"]
    assert ex["comm"] == "hier" and len(ex["payload_bytes_lvl"]) == 2
    assert all(r["words"] > 0 for lvl in ex["rounds"].values()
               for r in lvl.values())
