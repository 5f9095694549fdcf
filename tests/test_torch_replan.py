"""Streaming matrix updates in the port against the JAX package: the
copied host code of ``sparse/replan.py``, ``sparse/graph.py``'s edit
methods, ``core/costmodel.py``, ``core/replan_policy.py`` and the
cost-model metrics, all bit-equal.

A patched port plan must equal the port's fresh plan on the mutated CSR
field by field (``tests/replan_equiv.py``'s contract, its helpers imported
as they are), and the fresh port plan must equal the reference's.  The
patch chains use fixed seeds, not hypothesis draws: ``random_delta`` can
mirror a drop onto an entry that an earlier asymmetric step removed (the
reference's flaky ``test_random_patch_chains_stay_exact``), and a port
test must not inherit that flake."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.costmodel as rcost
import repro.core.metrics as rmet
import repro.core.replan_policy as rpol
import repro.sparse.distributed as rdist
import repro.sparse.graph as rgraph
import repro.sparse.replan as rrep
import repro_torch.core.costmodel as tcost
import repro_torch.core.metrics as tmet
import repro_torch.core.replan_policy as tpol
import repro_torch.sparse.distributed as tdist
import repro_torch.sparse.graph as tgraph
import repro_torch.sparse.replan as trep
from repro.core.topology import Topology
from repro.sparse.generators import grid

from replan_equiv import assert_plan_equal, random_csr, random_delta

DEPTHS = [(4, (4,)), (4, (2, 2)), (8, (2, 2, 2)), (8, (2, 4))]
CASES = [
    ("reweight", dict(n_reweight=6)),
    ("add", dict(n_add=4)),
    ("drop", dict(n_drop=4)),
    ("mixed", dict(n_reweight=5, n_add=3, n_drop=3)),
    ("asymmetric", dict(n_add=3, n_drop=2, symmetric=False)),
]


def as_np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def assert_port_equals_reference(port, ref):
    """Every field the reference's TreePlan has, bit-equal (lazy caches
    and the replan cache aside)."""
    for f in dataclasses.fields(ref):
        if f.name in ("_bell", "_bj_inv", "_cols_global", "_replan"):
            continue
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if f.name.endswith("_lvl") and f.name not in ("S_lvl",
                                                      "n_rounds_lvl",
                                                      "round_perms_lvl"):
            assert len(a) == len(b), f.name
            for x, y in zip(a, b):
                assert as_np(x).dtype == np.asarray(y).dtype, f.name
                np.testing.assert_array_equal(as_np(x), np.asarray(y),
                                              err_msg=f.name)
        elif a is None or isinstance(a, (int, tuple)):
            assert a == b, f.name
        else:
            assert as_np(a).dtype == np.asarray(b).dtype, f.name
            np.testing.assert_array_equal(as_np(a), np.asarray(b),
                                          err_msg=f.name)


@pytest.mark.parametrize("k,fanouts", DEPTHS)
@pytest.mark.parametrize("case,kwargs", CASES)
def test_patch_equals_fresh_equals_reference(k, fanouts, case, kwargs):
    seed = 1000 * k + len(fanouts) * 10 + [c for c, _ in CASES].index(case)
    rng = np.random.default_rng(seed)
    n = 48 if k == 4 else 64
    ip, ix, d = random_csr(rng, n, density=0.08)
    part = rng.integers(0, k, size=n).astype(np.int32)
    delta = random_delta(rng, ip, ix, n, **kwargs)
    assert len(delta)
    base = tdist.build_plan_tree(ip, ix, d, part, None, k, fanouts=fanouts,
                                 device="cpu")
    patched = trep.apply_edge_delta(base, delta)
    ip2, ix2, d2 = trep.apply_delta_csr(ip, ix, d, delta)
    fresh = tdist.build_plan_tree(ip2, ix2, d2, part, None, k,
                                  fanouts=fanouts, device="cpu")
    assert_plan_equal(patched, fresh)
    ref = rdist.build_plan_tree(ip2, ix2, d2, part, None, k,
                                fanouts=fanouts, validate=False)
    assert_port_equals_reference(fresh, ref)
    assert_port_equals_reference(patched, rrep.apply_edge_delta(
        rdist.build_plan_tree(ip, ix, d, part, None, k, fanouts=fanouts,
                              validate=False), delta, validate=False))


@pytest.mark.parametrize("seed", [7, 8])
def test_chained_patches_stay_exact(seed):
    rng = np.random.default_rng(seed)
    n, k, fanouts = 64, 8, (2, 4)
    ip, ix, d = random_csr(rng, n, density=0.08)
    part = rng.integers(0, k, size=n).astype(np.int32)
    plan = tdist.build_plan_tree(ip, ix, d, part, None, k, fanouts=fanouts,
                                 device="cpu")
    for _ in range(5):
        delta = random_delta(rng, ip, ix, n, n_reweight=4, n_add=3,
                             n_drop=2)
        plan = trep.apply_edge_delta(plan, delta)
        ip, ix, d = trep.apply_delta_csr(ip, ix, d, delta)
        fresh = tdist.build_plan_tree(ip, ix, d, part, None, k,
                                      fanouts=fanouts, device="cpu")
        assert_plan_equal(plan, fresh)
    assert plan._replan is not None


@pytest.mark.parametrize("seed", range(4))
def test_apply_delta_csr_bit_equal(seed):
    rng = np.random.default_rng(100 + seed)
    n = 40
    ip, ix, d = random_csr(rng, n, density=0.1)
    delta = random_delta(rng, ip, ix, n, n_reweight=3, n_add=3, n_drop=3,
                         symmetric=bool(seed % 2))
    got = trep.apply_delta_csr(ip, ix, d, delta)
    want = rrep.apply_delta_csr(ip, ix, d, rrep.EdgeDelta(
        n, delta.set_rows, delta.set_cols, delta.set_vals,
        delta.drop_rows, delta.drop_cols))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ip2, ix2, d2 = got
    back = trep.EdgeDelta.diff(ip, ix, d, ip2, ix2, d2)
    rback = rrep.EdgeDelta.diff(ip, ix, d, ip2, ix2, d2)
    for f in ("set_rows", "set_cols", "set_vals", "drop_rows", "drop_cols"):
        np.testing.assert_array_equal(getattr(back, f), getattr(rback, f))


@pytest.mark.parametrize("kw,err", [
    (dict(set_rows=[0], set_cols=[1], set_vals=[]), ValueError),
    (dict(set_rows=[0, 0], set_cols=[1, 1], set_vals=[1, 2]), ValueError),
    (dict(set_rows=[0], set_cols=[1], set_vals=[1], drop_rows=[0],
          drop_cols=[1]), ValueError),
    (dict(set_rows=[9], set_cols=[0], set_vals=[1]), ValueError)])
def test_edge_delta_validation_matches_reference(kw, err):
    msgs = []
    for mod in (trep, rrep):
        with pytest.raises(err) as info:
            mod.EdgeDelta(9, **kw)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_missing_drop_and_uncached_plan_raise():
    rng = np.random.default_rng(3)
    n = 32
    ip, ix, d = random_csr(rng, n, density=0.1)
    part = (np.arange(n) * 4 // n).astype(np.int32)
    plan = tdist.build_plan_tree(ip, ix, d, part, None, 4, fanouts=(4,),
                                 device="cpu", cache=False)
    assert plan._replan is None
    delta = trep.EdgeDelta(n, set_rows=[0], set_cols=[0], set_vals=[5.0])
    with pytest.raises(ValueError, match="no replan cache"):
        trep.apply_edge_delta(plan, delta)
    absent = np.setdiff1d(np.arange(n), ix[ip[0]:ip[1]])[0]
    with pytest.raises(KeyError, match="not present"):
        trep.apply_delta_csr(ip, ix, d, trep.EdgeDelta(
            n, drop_rows=[0], drop_cols=[absent]))


def test_migrate_state_round_trips():
    g = grid((12, 12))
    ip, ix, d = tgraph.laplacian_csr(g, shift=0.1)
    n = g.n
    part_a = (np.arange(n) * 8 // n).astype(np.int32)
    part_b = np.random.default_rng(5).integers(0, 8, n).astype(np.int32)
    old = tdist.build_plan_tree(ip, ix, d, part_a, None, 8, fanouts=(2, 4),
                                device="cpu")
    new = tdist.build_plan_tree(ip, ix, d, part_b, 2, 8, device="cpu")
    x = np.random.default_rng(6).normal(size=(n, 3)).astype(np.float32)
    xs = torch.from_numpy(old.scatter_vec(x))
    moved = trep.migrate_state(old, new, xs)
    assert isinstance(moved, torch.Tensor) and moved.shape == (8, new.B, 3)
    np.testing.assert_array_equal(new.gather_vec(moved), x)
    a, b = trep.migrate_state(old, new, xs, old.scatter_vec(x[:, 0]))
    np.testing.assert_array_equal(new.gather_vec(b), x[:, 0])
    np.testing.assert_array_equal(old.gather_vec(trep.migrate_state(
        new, old, a)), x)
    g5 = grid((5, 5))
    ip5, ix5, d5 = tgraph.laplacian_csr(g5, shift=0.1)
    small = tdist.build_plan_tree(ip5, ix5, d5, _stripes(g5.n, 8), 2, 8,
                                  device="cpu")
    with pytest.raises(ValueError, match="cannot migrate"):
        trep.migrate_state(old, small, xs)


def _graphs():
    g = grid((9, 7))
    return (rgraph.Graph(g.indptr, g.indices, g.weights, g.coords),
            tgraph.Graph(g.indptr, g.indices, g.weights, g.coords))


def assert_graphs_equal(a, b):
    for f in ("indptr", "indices", "weights"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_graph_edits_bit_equal():
    rg, tg = _graphs()
    u, v = np.array([0, 5, 17]), np.array([40, 6, 60])
    assert_graphs_equal(tg.add_edges(u, v, [0.5, 2.0, 1.5]),
                        rg.add_edges(u, v, [0.5, 2.0, 1.5]))
    assert_graphs_equal(tg.add_edges(u, v), rg.add_edges(u, v))
    eu, ev = np.array([0, 7]), np.array([1, 8])
    assert_graphs_equal(tg.remove_edges(eu, ev), rg.remove_edges(eu, ev))
    assert_graphs_equal(tg.reweight_edges(eu, ev, [3.0, 0.25]),
                        rg.reweight_edges(eu, ev, [3.0, 0.25]))
    mask = np.arange(tg.n) % 3 != 0
    (ts, tids), (rs, rids) = tg.subgraph(mask), rg.subgraph(mask)
    assert_graphs_equal(ts, rs)
    np.testing.assert_array_equal(tids, rids)
    np.testing.assert_array_equal(ts.coords, rs.coords)
    with pytest.raises(KeyError):
        tg.remove_edges([0], [30])
    ip, ix, d = tgraph.laplacian_csr(tg, shift=0.1)
    for data in (d, None):
        assert_graphs_equal(tgraph.structure_graph(ip, ix, data),
                            rgraph.structure_graph(ip, ix, data))


# the inputs of tests/test_replan_policy.py and tests/test_costmodel.py
def _path_graph(mod, n=24, w=1.0):
    src = np.arange(n - 1)
    return mod.from_edges(n, src, src + 1, np.full(n - 1, w, np.float32),
                          symmetrize=True)


def _stripes(n, k):
    return ((np.arange(n) * k) // n).astype(np.int32)


def _policy_cases():
    """(name, graphs before/after per package, part, anc, policy kw)."""
    out = []
    for mod_pair in [(rgraph, tgraph)]:
        r0, t0 = (_path_graph(m) for m in mod_pair)
        part = _stripes(24, 4)
        cross_u, cross_v = np.arange(4), 24 - 1 - np.arange(4)
        out.append(("objective", (r0, r0.add_edges(cross_u, cross_v)),
                    (t0, t0.add_edges(cross_u, cross_v)), part, None,
                    dict(max_objective_ratio=1.5)))
        iu = np.array([0, 0, 1, 2, 3, 4])
        iv = np.array([2, 3, 4, 5, 5, 1])
        out.append(("imbalance", (r0, r0.add_edges(iu, iv)),
                    (t0, t0.add_edges(iu, iv)), part, None,
                    dict(max_objective_ratio=1e9, max_imbalance_ratio=1.05)))
        out.append(("count", (r0, r0), (t0, t0), part, None,
                    dict(max_deltas=1)))
        anc = np.array([[0, 0, 1, 1]])
        out.append(("hier", (r0, r0.add_edges(cross_u, cross_v)),
                    (t0, t0.add_edges(cross_u, cross_v)), part, anc,
                    dict(objective="bottleneck", lams=(1.0, 4.0),
                         max_objective_ratio=1.2)))
    return out


@pytest.mark.parametrize("case", _policy_cases(), ids=lambda c: c[0])
def test_drift_monitor_bit_equal(case):
    _, (r0, r1), (t0, t1), part, anc, kw = case
    rm = rpol.DriftMonitor(rpol.DriftPolicy(**kw))
    tm = tpol.DriftMonitor(tpol.DriftPolicy(**kw))
    rm.reset(r0, part, anc)
    tm.reset(t0, part, anc)
    assert tm.baseline == rm.baseline
    for _ in range(2):
        want, got = rm.observe(r1, part, anc), tm.observe(t1, part, anc)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(RuntimeError):
        tpol.DriftMonitor().observe(t0, part)


@pytest.mark.parametrize("objective", ["cut", "bottleneck"])
@pytest.mark.parametrize("anc", [None, [[0, 0, 1, 1]],
                                 [[0, 0, 0, 0], [0, 0, 1, 1]]])
def test_cost_models_and_metrics_bit_equal(objective, anc):
    rg, tg = _graphs()
    part = _stripes(rg.n, 4)
    anc = np.zeros((0, 4), np.int64) if anc is None else np.asarray(anc)
    topo = Topology.homogeneous(4)
    for lams in (None, tuple(float(2 ** l) for l in range(anc.shape[0]
                                                          + 1))):
        rm = rcost.cost_model_for(objective, topo=topo, lams=lams,
                                  c_comp=0.5)
        tm = tcost.cost_model_for(objective, lams=lams, c_comp=0.5)
        tm = dataclasses.replace(tm, speeds=rm.speeds)
        assert tm.price(tg, part, anc) == rm.price(rg, part, anc)
        assert tm.summary(tg, part, anc) == rm.summary(rg, part, anc)
    h = anc.shape[0] + 1
    assert tmet.resolve_lams(None, h) == rmet.resolve_lams(None, h)
    if h > 1:
        assert tmet.tree_objective(tg, part, anc) == \
            rmet.tree_objective(rg, part, anc)
    got = tmet.per_pu_model_costs(tg, part, anc, speeds=[1, 2, 3, 4])
    want = rmet.per_pu_model_costs(rg, part, anc, speeds=[1, 2, 3, 4])
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert tmet.bottleneck_objective(tg, part, anc, c_comp=2.0) == \
        rmet.bottleneck_objective(rg, part, anc, c_comp=2.0)
    with pytest.raises(ValueError):
        tcost.cost_model_for("nope")
