"""The port's exchange schedules and block-Jacobi PCG against the JAX
package's own distributed backends.

The reference runs once, in a subprocess on 8 forced host devices
(``XLA_FLAGS`` is set in the child only, as tests/test_operator.py's
CROSS_SCRIPT does), on grid((24, 24)) with ``laplacian_csr(shift=0.1)``, a
random 8-way partition and ``b`` from ``default_rng(1)``; it writes each
backend's solution at tol 1e-7 and its iteration count at tol 1e-6 to an
``.npz``.  The port runs the same backends on the CPU, through both
``op.solve`` and ``cg_solve_global``.  Tolerances are the reference's:
matvecs within 1e-4 of scipy (tests/test_operator.py:65), solutions within
1e-5 relative to the largest entry (:78), iteration counts within 1."""
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.sparse.distributed import build_plan_tree as ref_build_plan_tree
from repro.sparse.generators import grid
from repro.sparse.graph import laplacian_csr
from repro_torch.core.balanced_kmeans import centroid_sums
from repro_torch.sparse.cg import cg_solve
from repro_torch.sparse.distributed import (
    TREE_DEVICE_FIELDS, TREE_HOST_FIELDS, TREE_LEVEL_FIELDS,
    TREE_TUPLE_FIELDS, HOST_FIELDS, SCALAR_FIELDS, build_plan,
    build_plan_tree, make_dist_cg, make_dist_spmv, tree_plan_from_arrays)
from repro_torch.sparse.operator import (DistributedOperator,
                                         cg_solve_global, make_operator)
import repro_torch.sparse.generators as tgen

SIDE = 24
# name -> (backend, tree keywords, precondition)
BACKENDS = {
    "dist_halo_seq": ("dist_halo_seq", {}, None),
    "dist_allgather": ("dist_allgather", {}, None),
    "dist_hier_pods2": ("dist_hier", {"pods": 2}, None),
    "dist_hier_tree222": ("dist_hier", {"fanouts": (2, 2, 2)}, None),
    "dist_hier_bell_pods2": ("dist_hier_bell", {"pods": 2}, None),
    "dist_halo+block_jacobi": ("dist_halo", {}, "block_jacobi"),
    "dist_hier_pods2+block_jacobi": ("dist_hier", {"pods": 2},
                                     "block_jacobi"),
}

SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import sys
    import numpy as np
    import jax
    from repro.launch.mesh import make_test_mesh
    from repro.sparse import make_operator
    from repro.sparse.generators import grid
    from repro.sparse.graph import laplacian_csr

    side, out_path = int(sys.argv[1]), sys.argv[2]
    backends = json.loads(sys.argv[3])
    g = grid((side, side))
    indptr, indices, data = laplacian_csr(g, shift=0.1)
    part = np.random.default_rng(0).integers(0, 8, g.n)
    b = np.random.default_rng(1).normal(size=g.n).astype(np.float32)
    flat = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("pu",))
    meshes = {"pods": make_test_mesh(8, pods=2),
              "fanouts": make_test_mesh(8, fanouts=(2, 2, 2))}
    out = {}
    for name, (backend, tree_kw, pre) in backends.items():
        mesh = meshes[next(iter(tree_kw))] if tree_kw else flat
        op = make_operator(indptr, indices, data, backend, part=part, k=8,
                           mesh=mesh, **tree_kw)
        res = op.solve(b, tol=1e-7, max_iters=2000, precondition=pre)
        out[name] = op.gather(res.x)
        out[name + ":iters"] = int(op.solve(
            b, tol=1e-6, max_iters=2000, precondition=pre).iters)
    np.savez(out_path, **out)
""")


@pytest.fixture(scope="module")
def system():
    g = grid((SIDE, SIDE))
    indptr, indices, data = laplacian_csr(g, shift=0.1)
    A = sp.csr_matrix((data, indices, indptr), shape=(g.n, g.n))
    part = np.random.default_rng(0).integers(0, 8, g.n)
    b = np.random.default_rng(1).normal(size=g.n).astype(np.float32)
    return g, (indptr, indices, data), A, part, b


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_backends") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(SIDE), str(out),
         json.dumps(BACKENDS)],
        capture_output=True, text=True, timeout=900, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as f:
        return {key: f[key] for key in f.files}


def rel_err(x, ref):
    return float(np.abs(x - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("name", list(BACKENDS))
def test_backend_matches_reference_distributed_solve(system, reference,
                                                     name):
    g, (indptr, indices, data), A, part, b = system
    backend, tree_kw, pre = BACKENDS[name]
    op = make_operator(indptr, indices, data, backend, part=part, k=8,
                       device="cpu", **tree_kw)
    x = np.random.default_rng(2).normal(size=g.n).astype(np.float32)
    np.testing.assert_allclose(op.gather(op.matvec(op.scatter(x))), A @ x,
                               atol=1e-4, rtol=1e-4)
    want, want_it = reference[name], int(reference[name + ":iters"])
    res = op.solve(b, tol=1e-7, max_iters=2000, precondition=pre)
    assert rel_err(op.gather(res.x), want) < 1e-5
    x2, _, _ = cg_solve_global(op, b, tol=1e-7, max_iters=2000,
                               precondition=pre, device="cpu")
    assert rel_err(x2, want) < 1e-5
    assert np.linalg.norm(A @ x2 - b) / np.linalg.norm(b) < 1e-4
    it = int(op.solve(b, tol=1e-6, max_iters=2000,
                      precondition=pre).iters)
    _, it2, _ = cg_solve_global(op, b, tol=1e-6, max_iters=2000,
                                precondition=pre, device="cpu")
    assert abs(it - want_it) <= 1 and abs(it2 - want_it) <= 1


def ref_tree_fields(plan) -> dict:
    """A reference TreePlan's fields as numpy arrays and tuples."""
    out = {f: getattr(plan, f) for f in SCALAR_FIELDS + TREE_TUPLE_FIELDS}
    arrays = HOST_FIELDS + TREE_HOST_FIELDS + TREE_DEVICE_FIELDS
    out.update({f: np.asarray(getattr(plan, f)) for f in arrays})
    out.update({f: tuple(np.asarray(a) for a in getattr(plan, f))
                for f in TREE_LEVEL_FIELDS})
    out["round_perms_lvl"] = plan.round_perms_lvl
    return out


@pytest.mark.parametrize("tree_kw", [{"pods": 2}, {"fanouts": (2, 2, 2)},
                                     {"tree": np.array([1, 0, 0, 1, 1, 0,
                                                        0, 1])}])
@pytest.mark.parametrize("local_format", ["coo", "bell"])
def test_carried_reference_tree_plan_gives_the_same_matvec(system, tree_kw,
                                                           local_format):
    g, (indptr, indices, data), A, part, b = system
    tree = tree_kw.get("pods", tree_kw.get("tree"))
    ref = ref_build_plan_tree(indptr, indices, data, part, tree, 8,
                              fanouts=tree_kw.get("fanouts"),
                              validate=False, cache=False)
    carried = DistributedOperator(
        plan=tree_plan_from_arrays(ref_tree_fields(ref), "cpu"),
        comm="hier", local_format=local_format)
    own = DistributedOperator(
        plan=build_plan_tree(indptr, indices, data, part, tree, 8,
                             fanouts=tree_kw.get("fanouts"), device="cpu"),
        comm="hier", local_format=local_format)
    x = np.random.default_rng(4).normal(size=g.n).astype(np.float32)
    got = carried.gather(carried.matvec(carried.scatter(x)))
    np.testing.assert_array_equal(got,
                                  own.gather(own.matvec(own.scatter(x))))
    np.testing.assert_allclose(got, A @ x, atol=1e-4, rtol=1e-4)


def test_degenerate_level_sends_zero_buffers(system):
    """fanouts=(1, 2, 2): the outermost level has one subtree, so no pair
    crosses it; its schedule is empty and adds no slot."""
    g, (indptr, indices, data), A, part, b = system
    op = make_operator(indptr, indices, data, "dist_hier", part=part % 4,
                       k=4, fanouts=(1, 2, 2), device="cpu")
    plan = op.plan
    assert plan.n_rounds_lvl[2] == 0 and plan.round_perms_lvl[2] == ()
    assert plan.level_offsets()[3] == plan.level_offsets()[2]
    x = np.random.default_rng(5).normal(size=g.n).astype(np.float32)
    np.testing.assert_allclose(op.gather(op.matvec(op.scatter(x))), A @ x,
                               atol=1e-4, rtol=1e-4)


def test_suffix_rounds_fire_in_every_subtree(system):
    """A level-0 pair of a depth-3 plan is a pair of suffix indices: it
    must deliver in each of the four subtrees, not only in the first."""
    g, (indptr, indices, data), A, part, b = system
    op = make_operator(indptr, indices, data, "dist_hier", part=part, k=8,
                       fanouts=(2, 2, 2), device="cpu")
    plan = op.plan
    assert plan.level_sizes() == (2, 4, 8)
    sends = plan.send_mask_lvl[0].sum(dim=(1, 2))       # words per block
    assert bool((sends.view(4, 2) > 0).all())           # every subtree
    x = np.random.default_rng(6).normal(size=g.n).astype(np.float32)
    np.testing.assert_allclose(op.gather(op.matvec(op.scatter(x))), A @ x,
                               atol=1e-4, rtol=1e-4)


def test_hier_partition_namespace_is_unpacked(system):
    g, (indptr, indices, data), A, part, b = system
    anc = np.array([[1, 1, 0, 0, 0, 1, 0, 1],
                    [2, 3, 0, 1, 0, 3, 1, 2]])
    hp = types.SimpleNamespace(part=part, pod_of=anc[0], anc=anc, k=8)
    op = make_operator(indptr, indices, data, "dist_hier", part=hp,
                       device="cpu")
    want = build_plan_tree(indptr, indices, data, part, anc, 8,
                           device="cpu")
    np.testing.assert_array_equal(op.plan.block_map, want.block_map)
    np.testing.assert_array_equal(op.plan.anc, want.anc)
    assert op.plan.fanouts == (2, 2, 2)
    x = np.random.default_rng(7).normal(size=g.n).astype(np.float32)
    np.testing.assert_allclose(op.gather(op.matvec(op.scatter(x))), A @ x,
                               atol=1e-4, rtol=1e-4)
    # pods= given explicitly wins over the namespace's table
    op2 = make_operator(indptr, indices, data, "dist_hier", part=hp,
                        pods=2, device="cpu")
    assert op2.plan.fanouts == (2, 4)
    # a flat backend takes only the block partition
    op3 = make_operator(indptr, indices, data, "dist_halo", part=hp,
                        device="cpu")
    np.testing.assert_array_equal(op3.plan.perm, build_plan(
        indptr, indices, data, part, 8, device="cpu").perm)


def test_mode_errors_carry_the_reference_types(system):
    g, (indptr, indices, data), A, part, b = system
    flat = build_plan(indptr, indices, data, part, 8, device="cpu")
    tree = build_plan_tree(indptr, indices, data, part, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="TreePlan"):
        make_dist_spmv(flat, comm="hier")
    with pytest.raises(ValueError, match="TreePlan"):
        make_dist_spmv(tree, comm="halo")
    with pytest.raises(ValueError, match="TreePlan"):
        make_dist_cg(tree, comm="allgather")
    with pytest.raises(ValueError, match="bell"):
        make_dist_spmv(flat, comm="halo_seq", local_format="bell")
    with pytest.raises(ValueError, match="bell"):
        DistributedOperator(plan=flat, comm="allgather",
                            local_format="bell")
    with pytest.raises(ValueError, match="comm"):
        make_dist_spmv(flat, comm="ring")
    with pytest.raises(ValueError, match="precondition"):
        make_dist_cg(flat, precondition="ilu")
    with pytest.raises(ValueError, match="pods="):
        make_operator(indptr, indices, data, "dist_hier", part=part, k=8,
                      device="cpu")
    with pytest.raises(ValueError, match="either"):
        make_operator(indptr, indices, data, "dist_hier", part=part, k=8,
                      pods=2, tree=np.zeros((1, 8), int), device="cpu")
    with pytest.raises(ValueError, match="only apply"):
        make_operator(indptr, indices, data, "dist_halo", part=part, k=8,
                      pods=2, device="cpu")


def test_block_jacobi_needs_a_distributed_operator(system):
    g, (indptr, indices, data), A, part, b = system
    coo = make_operator(indptr, indices, data, "coo", device="cpu")
    with pytest.raises(ValueError, match="block_jacobi"):
        cg_solve(coo, coo.scatter(b), precondition="block_jacobi")
    with pytest.raises(ValueError, match="block_jacobi"):
        cg_solve_global(coo, b, precondition="block_jacobi", device="cpu")
    with pytest.raises(ValueError, match="block_jacobi"):
        cg_solve(coo.matvec, coo.scatter(b), precondition="block_jacobi")


@pytest.mark.parametrize("backend,tree_kw", [
    ("dist_halo_seq", {}), ("dist_allgather", {}),
    ("dist_hier", {"pods": 2}), ("dist_hier_bell", {"fanouts": (2, 2, 2)})])
def test_batched_rhs_names_its_roadmap_item(system, backend, tree_kw):
    """A batched RHS (queue 1 item 7, ported): the COO schedules carry it
    through matvec, the fused solve and ``cg_solve_global``; the block-ELL
    interior is single-RHS and raises ``ValueError``, as the reference's
    does."""
    g, (indptr, indices, data), A, part, b = system
    op = make_operator(indptr, indices, data, backend, part=part, k=8,
                       device="cpu", **tree_kw)
    bb = np.stack([b, 2 * b], axis=1)
    if backend.endswith("_bell"):
        for call in (lambda: op.solve(bb),
                     lambda: cg_solve_global(op, bb, device="cpu"),
                     lambda: op.matvec(op.scatter(bb))):
            with pytest.raises(ValueError, match="single-RHS"):
                call()
    else:
        np.testing.assert_allclose(op.gather(op.matvec(op.scatter(bb))),
                                   A @ bb, rtol=1e-4, atol=1e-4)
        x, iters, _ = cg_solve_global(op, bb, device="cpu")
        res = op.solve(bb)
        assert iters.shape == tuple(res.iters.shape) == (2,)
        for j in range(2):
            xs, it, _ = cg_solve_global(op, bb[:, j], device="cpu")
            scale = np.abs(xs).max()
            assert np.abs(x[:, j] - xs).max() / scale < 1e-5
            assert np.abs(op.gather(res.x)[:, j] - xs).max() / scale < 1e-5
            assert abs(int(iters[j]) - it) <= 2
    with pytest.raises(ValueError, match="not"):
        op.matvec(torch.zeros(op.plan.k, op.plan.B + 1))


def test_centroid_sums_match_float64_add_at():
    """geoKM's centroid sums are masked reductions (one order of sums on
    the card); they agree with a float64 np.add.at within 1e-6 relative."""
    g = tgen.rdg(2000, seed=0)
    k = 8
    part = np.random.default_rng(3).integers(0, k, g.n)
    coords = np.asarray(g.coords, dtype=np.float32)
    want = np.zeros((k, coords.shape[1]), dtype=np.float64)
    np.add.at(want, part, coords.astype(np.float64))
    sums, counts = centroid_sums(torch.from_numpy(coords),
                                 torch.from_numpy(part), k)
    assert sums.dtype == torch.float32 and sums.shape == (k, 2)
    np.testing.assert_allclose(sums.numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(part, minlength=k))
