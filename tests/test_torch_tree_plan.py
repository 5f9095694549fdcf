"""The port's host plan code against the JAX package, bit-equal: the tree
and pod helpers of ``core/topology.py``, the tree/pod metric splits, the
flat oracle ``build_plan_reference``, ``cols_global`` and
``block_jacobi_inv``, and the tree plans of ``build_plan_tree`` /
``build_plan_hier`` field by field (the tests/replan_equiv.py contract),
on rdg(600, seed=11) with k = 8 (k = 4 for fanouts (1, 2, 2))."""
import numpy as np
import pytest

import repro.core.metrics as rmet
import repro.core.topology as rtop
import repro.sparse.distributed as rdist
from repro.core import partition_tree, scale_to_load
from repro.sparse.generators import grid, rdg
from repro.sparse.graph import laplacian_csr
import repro_torch.core.metrics as tmet
import repro_torch.core.topology as ttop
import repro_torch.sparse.distributed as tdist
import repro_torch.sparse.generators as tgen

FLAT_ARRAYS = tdist.DEVICE_FIELDS + tdist.HOST_FIELDS
TREE_ARRAYS = (tdist.TREE_DEVICE_FIELDS + tdist.HOST_FIELDS
               + tdist.TREE_HOST_FIELDS)
# (tree keyword for the plan builders, k)
TREES = {
    "pods2": ({"tree": 2}, 8),
    "pods4": ({"tree": 4}, 8),
    "tree222": ({"tree": None, "fanouts": (2, 2, 2)}, 8),
    "tree122": ({"tree": None, "fanouts": (1, 2, 2)}, 4),
}


@pytest.fixture(scope="module")
def graphs():
    return rdg(600, seed=11), tgen.rdg(600, seed=11)


@pytest.fixture(scope="module")
def lap(graphs):
    g, _ = graphs
    return laplacian_csr(g, shift=1e-2)


def anc_of(name):
    kw, k = TREES[name]
    return rtop.normalize_tree_of(kw["tree"], k, kw.get("fanouts"))


def as_np(v):
    return v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)


def assert_arrays_equal(port, ref, err_msg=""):
    a, b = as_np(port), np.asarray(ref)
    assert a.dtype == b.dtype, (err_msg, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=err_msg)


def assert_flat_plans_equal(port, ref):
    for f in tdist.SCALAR_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    assert port.round_perms == ref.round_perms
    for f in FLAT_ARRAYS:
        assert_arrays_equal(getattr(port, f), getattr(ref, f), f)
    assert_arrays_equal(port.cols_global, ref.cols_global, "cols_global")


def assert_tree_plans_equal(port, ref):
    assert type(port).__name__ == "TreePlan"
    for f in tdist.SCALAR_FIELDS + tdist.TREE_TUPLE_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    assert port.round_perms == ref.round_perms == ()
    assert port.round_perms_lvl == ref.round_perms_lvl
    for f in TREE_ARRAYS:
        assert_arrays_equal(getattr(port, f), getattr(ref, f), f)
    for f in tdist.TREE_LEVEL_FIELDS:
        assert len(getattr(port, f)) == len(getattr(ref, f)) == port.h, f
        for lvl, (a, b) in enumerate(zip(getattr(port, f),
                                         getattr(ref, f))):
            assert_arrays_equal(a, b, f"{f}[{lvl}]")
    for f in ("send_idx", "send_mask", "rows_bnd", "cols_bnd", "vals_bnd"):
        assert getattr(port, f) is None and getattr(ref, f) is None, f
    np.testing.assert_array_equal(port.level_offsets(), ref.level_offsets())
    assert_arrays_equal(port.cols_global, ref.cols_global, "cols_global")
    if port.h == 2:                     # the two-level views
        for f in ("pods", "k_local", "S_intra", "S_inter",
                  "n_rounds_intra", "n_rounds_inter", "round_perms_intra",
                  "round_perms_inter"):
            assert getattr(port, f) == getattr(ref, f), f
        np.testing.assert_array_equal(port.pod_of, ref.pod_of)
        for f in ("send_idx_intra", "send_mask_inter", "rows_bnd_intra",
                  "cols_bnd_inter", "vals_bnd_inter"):
            assert_arrays_equal(getattr(port, f), getattr(ref, f), f)


# -- topology and metrics ---------------------------------------------------

@pytest.mark.parametrize("name", list(TREES))
def test_topology_tree_helpers_bit_equal(name):
    kw, k = TREES[name]
    fan = kw.get("fanouts") or (kw["tree"], k // kw["tree"])
    rt = rtop.Topology.homogeneous(k, fanouts=fan)
    tt = ttop.Topology.homogeneous(k, fanouts=fan)
    assert_arrays_equal(tt.ancestor_table(), rt.ancestor_table())
    assert_arrays_equal(tt.ancestor_table((k,)), rt.ancestor_table((k,)))
    i, j = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    assert_arrays_equal(tt.level_of(i, j), rt.level_of(i, j))
    assert tt.level_of(0, k - 1) == rt.level_of(0, k - 1)
    assert tt.level_of(1, 1) == rt.level_of(1, 1) == -1
    anc = rt.ancestor_table()
    for row in anc:
        a, b = tt.tree_aggregate(row), rt.tree_aggregate(row)
        assert a.fanouts == b.fanouts
        assert_arrays_equal(a.speeds, b.speeds)
        assert_arrays_equal(a.memories, b.memories)
        assert [p.name for p in a.pus] == [p.name for p in b.pus]
    for pods in (1, 2, 4):
        if k % pods == 0:
            assert_arrays_equal(tt.pod_assignment(pods),
                                rt.pod_assignment(pods))
            assert_arrays_equal(tt.pod_aggregate(pods).speeds,
                                rt.pod_aggregate(pods).speeds)
    topo1 = ttop.Topology.topo1(k, 2 / 8, 8.0, 8.5)
    rtopo1 = rtop.Topology.topo1(k, 2 / 8, 8.0, 8.5)
    pod_arr = np.arange(k) % 2
    assert_arrays_equal(topo1.pod_aggregate(pod_arr).memories,
                        rtopo1.pod_aggregate(pod_arr).memories)
    for args in ({}, {"intra": 2.0, "inter": 5.0}, {"levels": 3},
                 {"costs": (1.0, 3.0, 9.0)}):
        assert tt.link_costs(**args).costs == rt.link_costs(**args).costs
    lc, rlc = ttop.LinkCosts(1.5, 6.0), rtop.LinkCosts(1.5, 6.0)
    assert (lc.levels, lc.intra, lc.inter, lc.lam, lc.lams) == \
        (rlc.levels, rlc.intra, rlc.inter, rlc.lam, rlc.lams)
    assert_arrays_equal(lc.matrix(pod_arr), rlc.matrix(pod_arr))
    tree_costs = ttop.LinkCosts(costs=(1.0, 2.0, 4.0))
    assert_arrays_equal(tree_costs.tree_matrix(anc),
                        rtop.LinkCosts(costs=(1.0, 2.0, 4.0))
                        .tree_matrix(anc))
    assert_arrays_equal(ttop.canonical_ancestors(fan),
                        rtop.canonical_ancestors(fan))
    assert_arrays_equal(ttop.level_matrix(anc), rtop.level_matrix(anc))
    assert_arrays_equal(ttop.normalize_tree_of(kw["tree"], k,
                                               kw.get("fanouts")),
                        anc_of(name))
    assert_arrays_equal(ttop.normalize_pod_of(pod_arr, k),
                        rtop.normalize_pod_of(pod_arr, k))
    assert_arrays_equal(ttop.contiguous_pods(k, 2),
                        rtop.contiguous_pods(k, 2))


@pytest.mark.parametrize("name", list(TREES))
def test_tree_metrics_bit_equal(graphs, name):
    g, tg = graphs
    _, k = TREES[name]
    anc = anc_of(name)
    part = np.random.default_rng(31).integers(0, k, g.n)
    a = tmet.tree_cut_split(tg, part, anc)
    assert_arrays_equal(a, rmet.tree_cut_split(g, part, anc))
    assert a.sum() == tmet.edge_cut(tg, part)
    v = tmet.tree_comm_volumes(tg, part, k, anc)
    assert_arrays_equal(v, rmet.tree_comm_volumes(g, part, k, anc))
    assert_arrays_equal(v.sum(axis=0), tmet.comm_volumes(tg, part, k))
    pod_of = anc[0] if len(anc) else np.zeros(k, np.int64)
    assert tmet.pod_cut_split(tg, part, pod_of) == \
        rmet.pod_cut_split(g, part, pod_of)
    for x, y in zip(tmet.pod_comm_volumes(tg, part, k, pod_of),
                    rmet.pod_comm_volumes(g, part, k, pod_of)):
        assert_arrays_equal(x, y)


INVALID_TREES = [   # tests/test_tree_plan.py::test_tree_validation_errors
    (None, 8, (2, 2)),                                   # prod != k
    (np.array([[0, 0, 1, 1], [0, 1, 0, 1]]), 4, None),   # not nested
    (np.array([[0, 0, 0, 1]]), 4, None),                 # unequal groups
    (None, 4, None),                                     # no tree, fanouts
    (np.array([[0, 0, 1, 1]]), 4, (2, 2, 1)),            # rows != h-1
    (np.array([[0, 0, 1, 1]]), 4, (4, 1)),               # groups != fanouts
    (np.array([[0, 0, -1, -1]]), 4, None),               # negative id
    (np.zeros((1, 6), int), 4, None),                    # columns != k
    (3, 8, None),                                        # pods do not
    (np.array([0, 0, 1]), 4, None),                      # pod array length
]


def raised(fn, *args):
    try:
        fn(*args)
    except Exception as e:                   # the type is what is compared
        return type(e)
    return None


@pytest.mark.parametrize("case", range(len(INVALID_TREES)))
def test_tree_validation_errors_match_reference(lap, case):
    tree, k, fanouts = INVALID_TREES[case]
    want = raised(rtop.normalize_tree_of, tree, k, fanouts)
    assert want is ValueError
    assert raised(ttop.normalize_tree_of, tree, k, fanouts) is want
    indptr, indices, data = lap
    part = np.zeros(len(indptr) - 1, dtype=np.int64)
    assert raised(lambda: tdist.build_plan_tree(
        indptr, indices, data, part, tree, k, fanouts=fanouts,
        device="cpu")) is want
    if np.ndim(tree) <= 1 and tree is not None:
        assert raised(ttop.normalize_pod_of, tree, k) is \
            raised(rtop.normalize_pod_of, tree, k) is ValueError


@pytest.mark.parametrize("pods", [np.array([0, 0, 1, 2]),
                                  np.array([-1, 0, 0, -1]), 0])
def test_pod_validation_errors_match_reference(pods):
    assert raised(ttop.normalize_pod_of, pods, 4) is \
        raised(rtop.normalize_pod_of, pods, 4) is ValueError


# -- flat plans ---------------------------------------------------------------

@pytest.mark.parametrize("k", [4, 8])
def test_build_plan_reference_bit_equal(lap, k):
    indptr, indices, data = lap
    part = np.random.default_rng(300 + k).integers(0, k, len(indptr) - 1)
    ref = rdist.build_plan_reference(indptr, indices, data, part, k)
    port_ref = tdist.build_plan_reference(indptr, indices, data, part, k,
                                          device="cpu")
    assert_flat_plans_equal(port_ref, ref)
    port = tdist.build_plan(indptr, indices, data, part, k, device="cpu")
    assert_flat_plans_equal(port, port_ref)
    assert_arrays_equal(port.block_jacobi_inv(), ref.block_jacobi_inv())


def test_cols_global_and_block_jacobi_with_an_empty_block():
    g = grid((16, 16))
    indptr, indices, data = laplacian_csr(g, shift=1e-2)
    part = np.where(np.arange(g.n) < g.n // 2, 0, 2)
    ref = rdist.build_plan(indptr, indices, data, part, 4, validate=False)
    for port in (tdist.build_plan(indptr, indices, data, part, 4,
                                  device="cpu"),
                 tdist.build_plan_reference(indptr, indices, data, part, 4,
                                            device="cpu")):
        assert_flat_plans_equal(port, ref)
        minv = port.block_jacobi_inv()
        assert minv.shape == (4, ref.B, ref.B)
        assert_arrays_equal(minv, ref.block_jacobi_inv())
        # the empty blocks are identity
        assert_arrays_equal(minv[1], np.eye(ref.B, dtype=np.float32))


def test_plan_from_arrays_carries_cols_global(lap):
    indptr, indices, data = lap
    part = np.random.default_rng(9).integers(0, 8, len(indptr) - 1)
    ref = rdist.build_plan(indptr, indices, data, part, 8, validate=False)
    fields = {f: getattr(ref, f) for f in tdist.SCALAR_FIELDS}
    fields.update({f: np.asarray(getattr(ref, f)) for f in FLAT_ARRAYS})
    fields["round_perms"] = ref.round_perms
    fields["cols_global"] = np.asarray(ref.cols_global)
    assert_flat_plans_equal(tdist.plan_from_arrays(fields, "cpu"), ref)
    fields.pop("cols_global")
    fields.update({f: getattr(ref, f) for f in tdist.PACK_FIELDS})
    assert_flat_plans_equal(tdist.plan_from_arrays(fields, "cpu"), ref)
    fields = {f: v for f, v in fields.items()
              if f not in tdist.PACK_FIELDS}
    with pytest.raises(ValueError, match="packing order"):
        tdist.plan_from_arrays(fields, "cpu").cols_global


# -- tree plans ---------------------------------------------------------------

@pytest.fixture(scope="module")
def swept(graphs):
    """The reference's tree-aware partition: a non-contiguous (2, 8)
    ancestor table after its per-level sweep."""
    g, _ = graphs
    topo = scale_to_load(rtop.Topology.homogeneous(8, fanouts=(2, 2, 2)),
                         g.n)
    res = partition_tree(g, topo, "greedyRef", seed=2)
    assert not np.array_equal(res.anc, rtop.canonical_ancestors((2, 2, 2)))
    return res


TREE_CASES = ["pods2", "pods_noncontiguous", "tree222", "anc_swept",
              "tree122", "tree222_sharded", "pods2_sharded"]


@pytest.mark.parametrize("case", TREE_CASES)
def test_tree_plans_bit_equal(lap, swept, case, monkeypatch):
    indptr, indices, data = lap
    n = len(indptr) - 1
    k = 4 if case == "tree122" else 8
    part = np.random.default_rng(400 + k).integers(0, k, n)
    tree, fanouts = None, None
    if case.startswith("pods2"):
        tree = 2
    elif case == "pods_noncontiguous":
        tree = np.array([1, 0, 0, 1, 1, 0, 0, 1])
    elif case == "anc_swept":
        tree, part = swept.anc, swept.part
    else:
        fanouts = (1, 2, 2) if case == "tree122" else (2, 2, 2)
    if case.endswith("sharded"):
        # the port's vertex-sharded bitmaps against the reference's dense
        monkeypatch.setattr(tdist, "DENSE_PLAN_LIMIT", 1000)
        assert k * n > tdist.DENSE_PLAN_LIMIT
    ref = rdist.build_plan_tree(indptr, indices, data, part, tree, k,
                                fanouts=fanouts, validate=False, cache=False)
    port = tdist.build_plan_tree(indptr, indices, data, part, tree, k,
                                 fanouts=fanouts, device="cpu")
    assert_tree_plans_equal(port, ref)
    if np.ndim(tree) <= 1 and tree is not None:
        assert_tree_plans_equal(tdist.build_plan_hier(
            indptr, indices, data, part, tree, k, device="cpu"), ref)
        assert_tree_plans_equal(port, rdist.build_plan_hier(
            indptr, indices, data, part, tree, k, validate=False))
    if case in ("pods_noncontiguous", "tree122"):
        assert_arrays_equal(port.block_jacobi_inv(), ref.block_jacobi_inv())


def test_depth3_plan_hides_the_two_level_views(lap):
    indptr, indices, data = lap
    part = np.random.default_rng(7).integers(0, 8, len(indptr) - 1)
    tp = tdist.build_plan_tree(indptr, indices, data, part, None, 8,
                               fanouts=(2, 2, 2), device="cpu")
    for name in ("n_rounds_intra", "send_idx_inter", "S_intra"):
        with pytest.raises(AttributeError):
            getattr(tp, name)
    assert tdist.HierPlan is tdist.TreePlan
