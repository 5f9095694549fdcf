"""The port's plan and partition verifier (``repro_torch.analysis.verify``)
against the reference's (``repro.analysis.verify``).

Every corruption class of ``tests/test_analysis_verify.py`` is applied to
the same plan in both packages — the port's plan is built bit-equal to
the reference's (``tests/test_torch_plan.py``, ``test_torch_tree_plan.py``)
and corrupted in its own field types (tensors) — and both verifiers must
report the same diagnostics: the same codes, ``where`` and messages.  The
hypothesis cases of ``tests/test_analysis_properties.py`` become fixed
seeds.  Clean flat, pod and tree plans at several fanouts verify clean,
PART001-003 match, and ``partner_table`` equals the reference's."""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.analysis as ran
import repro.core.api as rapi
import repro.core.topology as rtop
import repro.sparse.distributed as rdist
import repro_torch.analysis as tan
import repro_torch.core.api as tapi
import repro_torch.core.topology as ttop
import repro_torch.sparse.distributed as tdist
from repro.sparse.generators import GENERATORS, grid
from repro.sparse.graph import laplacian_csr
from repro_torch.sparse.replan import EdgeDelta, apply_edge_delta

CPU = "cpu"


def _system(shape=(12, 12), k=8, seed=3):
    g = grid(shape)
    indptr, indices, data = laplacian_csr(g, shift=1e-2)
    part = np.random.default_rng(seed).integers(0, k, g.n).astype(np.int64)
    return indptr, indices, data, part


def _pair(kind, system):
    """(reference plan, port plan) built from the same inputs."""
    indptr, indices, data, part = system
    if kind == "flat":
        return (rdist.build_plan(indptr, indices, data, part, 8,
                                 validate=False),
                tdist.build_plan(indptr, indices, data, part, 8,
                                 device=CPU, validate=False))
    if kind == "pod":
        return (rdist.build_plan_hier(indptr, indices, data, part, 2, 8,
                                      validate=False),
                tdist.build_plan_hier(indptr, indices, data, part, 2, 8,
                                      device=CPU, validate=False))
    return (rdist.build_plan_tree(indptr, indices, data, part, None, 8,
                                  fanouts=(2, 2, 2), validate=False),
            tdist.build_plan_tree(indptr, indices, data, part, None, 8,
                                  fanouts=(2, 2, 2), device=CPU,
                                  validate=False))


@pytest.fixture(scope="module")
def flat_plans():
    return _pair("flat", _system())


@pytest.fixture(scope="module")
def tree_plans():
    return _pair("tree", _system())


def _np(a) -> np.ndarray:
    return (a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)).copy()


def _like(old, new: np.ndarray):
    """``new`` in ``old``'s field type: a tensor for the port's plan."""
    return torch.from_numpy(new) if isinstance(old, torch.Tensor) else new


def _diag(rep):
    return [(d.code, d.where, d.message) for d in rep.diagnostics]


def assert_same_report(ref_plan, port_plan, mutate):
    """Corrupt both plans alike; both verifiers report the same."""
    want = ran.verify_plan(mutate(ref_plan))
    got = tan.verify_plan(mutate(port_plan))
    assert got.subject == want.subject
    assert _diag(got) == _diag(want), f"port:\n{got}\nreference:\n{want}"
    return got


# -- the corruption classes of tests/test_analysis_verify.py -----------------

def _grown_n(plan):
    return dataclasses.replace(plan, n=plan.n + 1)


def _perm_not_injective(plan):
    perm = _np(plan.perm)
    perm[0] = perm[1]
    return dataclasses.replace(plan, perm=perm)


def _dropped_level(plan):
    return dataclasses.replace(plan, S_lvl=plan.S_lvl[:-1])


def _grown_slot_width(plan):
    s = list(plan.S_lvl)
    s[-1] += 1
    return dataclasses.replace(plan, S_lvl=tuple(s))


def _level_with_rounds(plan, r_min=2):
    return next(l for l in range(plan.h) if plan.n_rounds_lvl[l] >= r_min)


def _merged_colors(plan):
    l = _level_with_rounds(plan)
    perms = [list(r) for r in plan.round_perms_lvl[l]]
    new_lvl = list(plan.round_perms_lvl)
    new_lvl[l] = tuple([tuple(perms[0] + perms[1])]
                       + [tuple(r) for r in perms[1:]])
    return dataclasses.replace(plan, round_perms_lvl=tuple(new_lvl))


def _first_full(perms):
    return next(i for i, r in enumerate(perms) if r)


def _cycle_round(plan):
    perms = [list(r) for r in plan.round_perms]
    perms[_first_full(perms)] = [(0, 1), (1, 2), (2, 0)]
    return dataclasses.replace(plan,
                               round_perms=tuple(tuple(r) for r in perms))


def _one_directional(plan):
    perms = [list(r) for r in plan.round_perms]
    c = _first_full(perms)
    perms[c] = perms[c][:-1]
    return dataclasses.replace(plan,
                               round_perms=tuple(tuple(r) for r in perms))


def _duplicate_destination(plan):
    perms = [list(r) for r in plan.round_perms]
    c = _first_full(perms)
    perms[c] = perms[c] + [perms[c][0]]
    return dataclasses.replace(plan,
                               round_perms=tuple(tuple(r) for r in perms))


def _permuted_rounds(plan):
    perms = [list(r) for r in plan.round_perms]
    full = [i for i, r in enumerate(perms) if r]
    i, j = full[0], full[1]
    perms[i], perms[j] = perms[j], perms[i]
    return dataclasses.replace(plan,
                               round_perms=tuple(tuple(r) for r in perms))


def _ghost_row_send(plan):
    sizes = np.asarray(plan.sizes)
    for l in range(plan.h):
        live = np.argwhere(_np(plan.send_mask_lvl[l]) > 0)
        if len(live):
            b, c, s = live[0]
            idx = _np(plan.send_idx_lvl[l])
            idx[b, c, s] = sizes[b]
            si = list(plan.send_idx_lvl)
            si[l] = _like(plan.send_idx_lvl[l], idx)
            return dataclasses.replace(plan, send_idx_lvl=tuple(si))
    raise AssertionError("no live send entries")


def _aliased_slot(plan):
    cols = _np(plan.cols)
    nnz = np.asarray(plan.nnz_blk)
    for b in range(plan.k):
        ext = np.flatnonzero(cols[b, :nnz[b]] >= plan.B)
        two = np.unique(cols[b, ext])
        if len(two) >= 2:
            cols[b, ext[cols[b, ext] == two[0]][0]] = two[1]
            return dataclasses.replace(plan, cols=_like(plan.cols, cols))
    raise AssertionError("no block reads two distinct halo slots")


def _unwritten_slot_read(plan):
    cols = _np(plan.cols)
    ext_len = plan.B + plan.n_rounds * plan.S
    cols[int(np.argmax(np.asarray(plan.nnz_blk))), 0] = ext_len - 1
    return dataclasses.replace(plan, cols=_like(plan.cols, cols))


def _segment_ordering(plan):
    offs = plan.level_offsets()
    live = np.argwhere(_np(plan.vals_bnd_lvl[0]) != 0)
    b, e = live[0]
    cols0 = _np(plan.cols_bnd_lvl[0])
    cols0[b, e] = offs[-1] - 1
    cb = list(plan.cols_bnd_lvl)
    cb[0] = _like(plan.cols_bnd_lvl[0], cols0)
    return dataclasses.replace(plan, cols_bnd_lvl=tuple(cb))


def _segment_multiset(plan):
    for l in range(plan.h):
        vals = _np(plan.vals_bnd_lvl[l])
        live = np.argwhere(vals != 0)
        if len(live):
            b, e = live[0]
            vals[b, e] += 1.0
            vb = list(plan.vals_bnd_lvl)
            vb[l] = _like(plan.vals_bnd_lvl[l], vals)
            return dataclasses.replace(plan, vals_bnd_lvl=tuple(vb))
    raise AssertionError("no boundary edges at any level")


def _interior_mask(plan):
    m = _np(plan.interior_mask)
    m[0, 0] = 1.0 - m[0, 0]
    return dataclasses.replace(plan, interior_mask=_like(plan.interior_mask,
                                                         m))


def _stale_cache_blocks(plan):
    cache = plan._replan
    return dataclasses.replace(plan, _replan=dataclasses.replace(
        cache, per_blk=cache.per_blk + 1))


def _stale_cache_keys(plan):
    cache = plan._replan
    return dataclasses.replace(plan, _replan=dataclasses.replace(
        cache, keys=cache.keys[::-1].copy()))


def _stale_cache_offsets(plan):
    cache = plan._replan
    return dataclasses.replace(plan, _replan=dataclasses.replace(
        cache, offs=cache.offs + 1))


CORRUPTIONS = {
    # name: (plan kind, corruption, codes the reference suite asserts)
    "grown_n": ("flat", _grown_n, {"PLAN001"}),
    "perm_not_injective": ("flat", _perm_not_injective, {"PLAN001"}),
    "dropped_level": ("tree", _dropped_level, {"PLAN002"}),
    "grown_slot_width": ("tree", _grown_slot_width, {"PLAN002"}),
    "merged_colors": ("tree", _merged_colors, {"PLAN003", "PLAN004"}),
    "cycle_round": ("flat", _cycle_round, {"PLAN003"}),
    "one_directional_pair": ("flat", _one_directional, {"PLAN003"}),
    "duplicate_destination": ("flat", _duplicate_destination, {"PLAN004"}),
    "permuted_rounds": ("flat", _permuted_rounds,
                        {"PLAN009", "PLAN006", "PLAN007"}),
    "ghost_row_send": ("tree", _ghost_row_send, {"PLAN005"}),
    "aliased_slot": ("flat", _aliased_slot, {"PLAN009"}),
    "unwritten_slot_read": ("flat", _unwritten_slot_read, {"PLAN007"}),
    "segment_ordering": ("tree", _segment_ordering, {"PLAN007"}),
    "segment_multiset": ("tree", _segment_multiset, {"PLAN008"}),
    "interior_mask": ("flat", _interior_mask, {"PLAN008"}),
    "stale_cache_blocks": ("tree", _stale_cache_blocks, {"PLAN010"}),
    "stale_cache_keys": ("tree", _stale_cache_keys, {"PLAN010"}),
    "stale_cache_offsets": ("tree", _stale_cache_offsets, {"PLAN010"}),
}


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_corruption_gives_the_reference_report(name, flat_plans,
                                               tree_plans):
    kind, mutate, codes = CORRUPTIONS[name]
    ref, port = flat_plans if kind == "flat" else tree_plans
    got = assert_same_report(ref, port, mutate)
    assert got.codes() & codes, str(got)


def test_raise_for_errors_carries_report(flat_plans):
    rep = tan.verify_plan(_grown_n(flat_plans[1]))
    with pytest.raises(tan.PlanVerificationError) as ei:
        rep.raise_for_errors()
    assert ei.value.report is rep
    assert isinstance(ei.value, ValueError)


# -- clean corpus -------------------------------------------------------------

@pytest.mark.parametrize("generator", ["grid_2d", "rgg_2d"])
@pytest.mark.parametrize("fanouts", [(4,), (2, 2), (2, 2, 2), (2, 3),
                                     (2, 2, 2, 2)],
                         ids=lambda f: "x".join(map(str, f)))
def test_clean_corpus_verifies(generator, fanouts):
    g = GENERATORS[generator](196, seed=0)
    indptr, indices, data = laplacian_csr(g, shift=0.1)
    k = int(np.prod(fanouts))
    part = np.random.default_rng(0).integers(0, k, g.n)
    plans = [tdist.build_plan(indptr, indices, data, part, k, device=CPU,
                              validate=False),
             tdist.build_plan_reference(indptr, indices, data, part, k,
                                        device=CPU)]
    if len(fanouts) > 1:
        plans.append(tdist.build_plan_tree(
            indptr, indices, data, part, ttop.canonical_ancestors(fanouts),
            k, device=CPU, validate=False))
        plans.append(tdist.build_plan_hier(indptr, indices, data, part,
                                           fanouts[0], k, device=CPU,
                                           validate=False))
    for plan in plans:
        rep = tan.verify_plan(plan)
        assert rep.ok, str(rep)
        assert rep.subject == ran.verify_plan(plan).subject


def test_plan_builds_verify_their_host_arrays(monkeypatch):
    """``validate=True`` checks the host arrays before the upload: the
    verifier sees numpy arrays, never a tensor."""
    seen = []

    def spy(plan):
        seen.append(all(not isinstance(v, torch.Tensor)
                        for v in vars(plan).values()))
        return tan.Report(subject="spy")

    monkeypatch.setattr(tdist, "verify_plan", spy)
    indptr, indices, data, part = _system()
    tdist.build_plan(indptr, indices, data, part, 8, device=CPU,
                     validate=True)
    tdist.build_plan_tree(indptr, indices, data, part, None, 8,
                          fanouts=(2, 2, 2), device=CPU, validate=True)
    assert seen == [True, True]


def test_builds_keep_their_verify_report(tree_plans):
    """A validated build keeps the verifier's report, with its host
    seconds, as ``verify_report``; an unverified one keeps None, and
    ``dataclasses.replace`` (a mutated plan) never carries a report over."""
    indptr, indices, data, part = _system()
    flat = tdist.build_plan(indptr, indices, data, part, 8, device=CPU,
                            validate=True)
    tree = tdist.build_plan_tree(indptr, indices, data, part, None, 8,
                                 fanouts=(2, 2, 2), device=CPU,
                                 validate=True)
    for plan in (flat, tree):
        rep = plan.verify_report
        assert rep.ok and rep.subject == tan.verify_plan(plan).subject
        assert rep.info["seconds"] > 0
        assert dataclasses.replace(plan, n=plan.n).verify_report is None
    assert tree_plans[1].verify_report is None          # validate=False
    # both patch paths keep the report of their own check
    nv = len(indptr) - 1
    for delta in (EdgeDelta(nv, set_rows=[0], set_cols=[0], set_vals=[5.0]),
                  EdgeDelta(nv, set_rows=[0, nv - 1], set_cols=[nv - 1, 0],
                            set_vals=[-1.0, -1.0])):
        patched = apply_edge_delta(tree, delta, validate=True)
        assert patched.verify_report is not tree.verify_report
        assert patched.verify_report.ok
        assert apply_edge_delta(tree, delta,
                                validate=False).verify_report is None


def test_validate_on_a_relabelled_tree():
    """A tree whose blocks are not in mixed-radix order verifies: the
    ``build_plan_tree`` checks the relabelled (tree-major) plan it returns."""
    indptr, indices, data, part = _system()
    anc = ttop.canonical_ancestors((2, 2, 2))[:, ::-1].copy()
    plan = tdist.build_plan_tree(indptr, indices, data, part, anc, 8,
                                 device=CPU, validate=True)
    assert tan.verify_plan(plan).ok


# -- the hypothesis cases of tests/test_analysis_properties.py, fixed seeds ---

FANOUTS = [(2,), (4,), (2, 2), (2, 3), (3, 2), (2, 2, 2), (1, 2, 2),
           (2, 2, 2, 2)]


def _random_system(seed):
    """The property module's ``tree_csr_system`` draw, from one seed."""
    rng = np.random.default_rng(seed)
    fanouts = FANOUTS[seed % len(FANOUTS)]
    k = int(np.prod(fanouts))
    n = int(rng.integers(1, 49))
    density = float(rng.uniform(0.0, 0.3))
    blocks_used = int(rng.integers(1, k + 1))
    m = int(round(density * n * n))
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    vals = rng.uniform(0.5, 2.0, size=m)
    A = sp.csr_matrix((vals, (src, dst)), shape=(n, n))
    A.sum_duplicates()
    part = rng.permutation(k)[:blocks_used][rng.integers(0, blocks_used,
                                                         size=n)]
    anc = ttop.canonical_ancestors(fanouts)[:, rng.permutation(k)]
    return (A.indptr.astype(np.int64), A.indices.astype(np.int64),
            A.data.astype(np.float32), part.astype(np.int64), k, anc)


@pytest.mark.parametrize("seed", range(12))
def test_random_systems_verify_clean(seed):
    indptr, indices, data, part, k, anc = _random_system(seed)
    for plan in (tdist.build_plan_tree(indptr, indices, data, part, anc, k,
                                       device=CPU, validate=False),
                 tdist.build_plan(indptr, indices, data, part, k,
                                  device=CPU, validate=False)):
        rep = tan.verify_plan(plan)
        assert rep.ok, str(rep)
        assert _diag(ran.verify_plan(plan)) == []


def _c_send_idx(plan, rng):
    sizes = np.asarray(plan.sizes)
    for l in rng.permutation(plan.h):
        live = np.argwhere(_np(plan.send_mask_lvl[l]) > 0)
        if len(live):
            b, c, s = live[rng.integers(len(live))]
            idx = _np(plan.send_idx_lvl[l])
            idx[b, c, s] = sizes[b]
            si = list(plan.send_idx_lvl)
            si[l] = _like(plan.send_idx_lvl[l], idx)
            return (dataclasses.replace(plan, send_idx_lvl=tuple(si)),
                    {"PLAN005", "PLAN009"})
    return None


def _c_round_perm(plan, rng):
    for l in rng.permutation(plan.h):
        perms = [list(r) for r in plan.round_perms_lvl[l]]
        full = [i for i, r in enumerate(perms) if r]
        if not full:
            continue
        c = full[rng.integers(len(full))]
        perms[c] = perms[c] + [perms[c][rng.integers(len(perms[c]))]]
        new = list(plan.round_perms_lvl)
        new[l] = tuple(tuple(r) for r in perms)
        return (dataclasses.replace(plan, round_perms_lvl=tuple(new)),
                {"PLAN004"})
    return None


def _c_drop_level(plan, rng):
    if plan.h < 2:
        return None
    return dataclasses.replace(plan, S_lvl=plan.S_lvl[:-1]), {"PLAN002"}


def _c_alias_slot(plan, rng):
    cols = _np(plan.cols)
    nnz = np.asarray(plan.nnz_blk)
    for b in rng.permutation(plan.k):
        ext = np.flatnonzero(cols[b, :nnz[b]] >= plan.B)
        two = np.unique(cols[b, ext])
        if len(two) >= 2:
            cols[b, ext[cols[b, ext] == two[0]][0]] = two[1]
            return (dataclasses.replace(plan, cols=_like(plan.cols, cols)),
                    {"PLAN009", "PLAN008"})
    return None


def _c_segment_value(plan, rng):
    for l in rng.permutation(plan.h):
        vals = _np(plan.vals_bnd_lvl[l])
        live = np.argwhere(vals != 0)
        if len(live):
            b, e = live[rng.integers(len(live))]
            vals[b, e] += 1.0
            vb = list(plan.vals_bnd_lvl)
            vb[l] = _like(plan.vals_bnd_lvl[l], vals)
            return (dataclasses.replace(plan, vals_bnd_lvl=tuple(vb)),
                    {"PLAN008"})
    return None


SEEDED = [_c_send_idx, _c_round_perm, _c_drop_level, _c_alias_slot,
          _c_segment_value]


def _expressible_cases():
    """(system seed, corruption) pairs where the corruption applies, the
    first three per corruption over seeds 0..63."""
    cases = []
    for which, fn in enumerate(SEEDED):
        found = 0
        for seed in range(64):
            indptr, indices, data, part, k, anc = _random_system(seed)
            plan = rdist.build_plan_tree(indptr, indices, data, part, anc,
                                         k, validate=False)
            if fn(plan, np.random.default_rng(seed)) is not None:
                cases.append((seed, which))
                found += 1
                if found == 3:
                    break
    return cases


@pytest.mark.parametrize("seed,which", _expressible_cases(),
                         ids=lambda v: str(v))
def test_seeded_corruption_is_caught_like_the_reference(seed, which):
    indptr, indices, data, part, k, anc = _random_system(seed)
    ref = rdist.build_plan_tree(indptr, indices, data, part, anc, k,
                                validate=False)
    port = tdist.build_plan_tree(indptr, indices, data, part, anc, k,
                                 device=CPU, validate=False)
    assert tan.verify_plan(port).ok
    bad_ref, expected = SEEDED[which](ref, np.random.default_rng(seed))
    bad_port, _ = SEEDED[which](port, np.random.default_rng(seed))
    got, want = tan.verify_plan(bad_port), ran.verify_plan(bad_ref)
    assert _diag(got) == _diag(want)
    assert got.codes() & expected, str(got)


# -- partner table ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["flat", "pod", "tree"])
def test_partner_table_equals_the_reference(kind):
    ref, port = _pair(kind, _system())
    assert tan.partner_table(port) == ran.partner_table(ref)


# -- partition verifier (PART001-003) -----------------------------------------

@pytest.fixture(scope="module")
def partitions():
    g = grid((12, 12))
    out = []
    for top, api, kw in ((rtop, rapi, {}), (ttop, tapi, {"device": CPU})):
        topo = top.Topology.homogeneous(8, memory=2.0 * g.n / 8,
                                        fanouts=(2, 2, 2))
        out.append(api.partition_tree(g, topo, "sfc", fanouts=(2, 2, 2),
                                      validate=True, **kw))
    return g, out[0], out[1]


def _broken_nesting(res):
    anc = res.anc.copy()
    anc[0, 0] = 1 - anc[0, 0]
    return dataclasses.replace(res, anc=anc)


def _out_of_range(res):
    part = res.part.copy()
    part[0] = 8
    return dataclasses.replace(res, part=part)


def _short_lams(res):
    return dataclasses.replace(res, lams=res.lams[:-1])


def _flat_table(res):
    return dataclasses.replace(res, anc=res.anc[0])


@pytest.mark.parametrize("mutate,code", [
    (lambda r: r, None), (_out_of_range, "PART001"),
    (_broken_nesting, "PART002"), (_flat_table, "PART002"),
    (_short_lams, "PART003")],
    ids=["clean", "part001", "part002_nesting", "part002_shape",
         "part003"])
def test_partition_report_equals_the_reference(partitions, mutate, code):
    g, ref, port = partitions
    got = tan.verify_partition(mutate(port), g.n)
    want = ran.verify_partition(mutate(ref), g.n)
    assert got.subject == want.subject
    assert _diag(got) == _diag(want)
    assert got.codes() == ({code} if code else set()), str(got)


def test_partition_validate_raises_on_a_corrupt_result(monkeypatch):
    """``partition_tree(validate=True)`` raises the verifier's error when
    the pipeline hands it a result the checks reject."""
    g = grid((8, 8))
    topo = ttop.Topology.homogeneous(8, memory=2.0 * g.n / 8,
                                     fanouts=(2, 2, 2))
    real = tapi.HierPartition
    monkeypatch.setattr(tapi, "HierPartition",
                        lambda **kw: _out_of_range(real(**kw)))
    with pytest.raises(tan.PlanVerificationError, match="PART001"):
        tapi.partition_tree(g, topo, "sfc", fanouts=(2, 2, 2),
                            validate=True, device=CPU)
    monkeypatch.setattr(tapi, "HierPartition", real)
    res = tapi.partition_tree(g, topo, "sfc", fanouts=(2, 2, 2),
                              validate=True, device=CPU)
    assert tan.verify_partition(res, g.n).ok
    assert res.verify_report.ok and res.verify_report.info["seconds"] > 0
    assert tapi.partition_tree(g, topo, "sfc", fanouts=(2, 2, 2),
                               validate=False,
                               device=CPU).verify_report is None
