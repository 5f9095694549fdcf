"""Batched multi-RHS CG in the port against per-column solves and against
the JAX package's ``cg_solve(batched=True)``.

The system is grid((16, 16)) with ``laplacian_csr(shift=0.05)`` (n = 256,
small enough for the reference's Pallas block-ELL kernel in interpret
mode) and a random 8-way partition; the RHS batch mixes a hard column, an
easy one (``A e_3``, which converges in a few iterations), a zero column
(which takes none) and a second hard one.  The reference's distributed
backends run once, in a subprocess on 8 forced host devices.  Tolerances
are the reference's (``tests/test_serving.py``, ``tests/test_cg_batched
.py``): solutions within 1e-5 of the column's largest entry, iteration
counts within 2, matvecs within 1e-4 of scipy."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.sparse import cg_solve as ref_cg_solve
from repro.sparse import make_operator as ref_make_operator
from repro.sparse.generators import grid
from repro.sparse.graph import laplacian_csr
import repro_torch.sparse.cg as tcg
from repro_torch.kernels.ref import (spmv_block_ell_multi_ref,
                                     spmv_block_ell_ref)
from repro_torch.kernels.spmv_bell import csr_to_block_ell, spmv_block_ell
from repro_torch.sparse.cg import cg_solve
from repro_torch.sparse.operator import cg_solve_global, make_operator

SIDE = 16
K = 8
DIST = {
    "dist_halo": ("dist_halo", {}),
    "dist_halo_seq": ("dist_halo_seq", {}),
    "dist_allgather": ("dist_allgather", {}),
    "dist_hier_pods2": ("dist_hier", {"pods": 2}),
    "dist_hier_tree222": ("dist_hier", {"fanouts": (2, 2, 2)}),
}
BACKENDS = {"coo": ("coo", {}), "bell": ("bell", {}), **DIST}

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
    bb = np.load(sys.argv[4])
    g = grid((side, side))
    indptr, indices, data = laplacian_csr(g, shift=0.05)
    part = np.random.default_rng(0).integers(0, 8, g.n)
    flat = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("pu",))
    meshes = {"pods": make_test_mesh(8, pods=2),
              "fanouts": make_test_mesh(8, fanouts=(2, 2, 2))}
    out = {}
    for name, (backend, tree_kw) in backends.items():
        mesh = meshes[next(iter(tree_kw))] if tree_kw else flat
        op = make_operator(indptr, indices, data, backend, part=part, k=8,
                           mesh=mesh, **tree_kw)
        res = op.solve(bb, tol=1e-6, max_iters=1000)
        out[name] = op.gather(res.x)
        out[name + ":iters"] = np.asarray(res.iters)
    np.savez(out_path, **out)
""")


def _system():
    g = grid((SIDE, SIDE))
    indptr, indices, data = laplacian_csr(g, shift=0.05)
    A = sp.csr_matrix((data, indices, indptr), shape=(g.n, g.n))
    part = np.random.default_rng(0).integers(0, K, g.n)
    rng = np.random.default_rng(1)
    e3 = np.zeros(g.n, np.float32)
    e3[3] = 1.0
    bb = np.stack([rng.normal(size=g.n), A @ e3, np.zeros(g.n),
                   rng.normal(size=g.n)], axis=1).astype(np.float32)
    return (indptr, indices, data), A, part, bb


@pytest.fixture(scope="module")
def system():
    return _system()


@pytest.fixture(scope="module")
def reference(tmp_path_factory, system):
    _, _, _, bb = system
    tmp = tmp_path_factory.mktemp("cg_batched")
    np.save(tmp / "bb.npy", bb)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(SIDE), str(tmp / "ref.npz"),
         json.dumps(DIST), str(tmp / "bb.npy")],
        capture_output=True, text=True, timeout=900, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(tmp / "ref.npz") as f:
        return {key: f[key] for key in f.files}


def port_op(system, name):
    (indptr, indices, data), _, part, _ = system
    backend, kw = BACKENDS[name]
    if backend.startswith("dist"):
        kw = dict(kw, part=part, k=K)
    return make_operator(indptr, indices, data, backend, device="cpu", **kw)


def assert_columns_close(x, want, iters, want_iters):
    for j in range(want.shape[1]):
        scale = max(float(np.abs(want[:, j]).max()), 1.0)
        assert np.abs(x[:, j] - want[:, j]).max() / scale < 1e-5, j
        assert abs(int(iters[j]) - int(want_iters[j])) <= 2, j


@pytest.mark.parametrize("name", list(BACKENDS))
def test_batched_matches_per_column_sequential(system, name):
    _, _, _, bb = system
    op = port_op(system, name)
    x, iters, res = cg_solve_global(op, bb, tol=1e-6, max_iters=1000,
                                    device="cpu")
    assert x.shape == bb.shape and iters.shape == res.shape == (4,)
    seq = [cg_solve_global(op, bb[:, j], tol=1e-6, max_iters=1000,
                           device="cpu") for j in range(4)]
    assert_columns_close(x, np.stack([s[0] for s in seq], axis=1), iters,
                         [s[1] for s in seq])
    assert int(iters[2]) == 0                     # the zero column is free
    assert np.all(x[:, 2] == 0)
    assert int(iters[1]) < int(iters[0])          # A e_3 is easy


@pytest.mark.parametrize("name", list(DIST))
def test_fused_batched_solve_matches_composable(system, name):
    _, _, _, bb = system
    op = port_op(system, name)
    fused = op.solve(bb, tol=1e-6, max_iters=1000)
    x, iters, _ = cg_solve_global(op, bb, tol=1e-6, max_iters=1000,
                                  device="cpu")
    assert tuple(fused.x.shape) == (op.plan.k, op.plan.B, 4)
    assert_columns_close(op.gather(fused.x), x, fused.iters.numpy(), iters)


@pytest.mark.parametrize("name,precondition", [
    ("coo", "jacobi"), ("bell", "jacobi"), ("dist_halo", "jacobi"),
    ("dist_halo", "block_jacobi"), ("dist_hier_pods2", "block_jacobi")])
def test_preconditioned_batched_matches_per_column(system, name,
                                                    precondition):
    _, _, _, bb = system
    op = port_op(system, name)
    res = cg_solve(op, op.scatter(bb), tol=1e-6, max_iters=1000,
                   precondition=precondition, batched=True)
    want, want_it = [], []
    for j in range(4):
        r = cg_solve(op, op.scatter(bb[:, j]), tol=1e-6, max_iters=1000,
                     precondition=precondition)
        want.append(op.gather(r.x))
        want_it.append(int(r.iters))
    assert_columns_close(op.gather(res.x), np.stack(want, axis=1),
                         res.iters.numpy(), want_it)
    assert int(res.iters[2]) == 0


@pytest.mark.parametrize("name", ["coo", "bell"])
def test_batched_matches_reference_single_device(system, name):
    (indptr, indices, data), _, _, bb = system
    ref_op = ref_make_operator(indptr, indices, data, name)
    want = ref_cg_solve(ref_op, ref_op.scatter(bb), tol=1e-6,
                        max_iters=1000, batched=True)
    op = port_op(system, name)
    x, iters, _ = cg_solve_global(op, bb, tol=1e-6, max_iters=1000,
                                  device="cpu")
    assert_columns_close(x, np.asarray(want.x), iters,
                         np.asarray(want.iters))


@pytest.mark.parametrize("name", list(DIST))
def test_batched_matches_reference_distributed(system, reference, name):
    _, _, _, bb = system
    op = port_op(system, name)
    res = op.solve(bb, tol=1e-6, max_iters=1000)
    assert_columns_close(op.gather(res.x), reference[name],
                         res.iters.numpy(), reference[name + ":iters"])


@pytest.mark.parametrize("backend,kw", [("dist_bell", {}),
                                        ("dist_hier_bell", {"pods": 2})])
def test_block_ell_distributed_backends_stay_single_rhs(system, backend,
                                                        kw):
    (indptr, indices, data), _, part, bb = system
    op = make_operator(indptr, indices, data, backend, part=part, k=K,
                       device="cpu", **kw)
    for call in (lambda: op.solve(bb),
                 lambda: cg_solve(op, op.scatter(bb), batched=True),
                 lambda: cg_solve_global(op, bb, device="cpu")):
        with pytest.raises(ValueError, match="local_format='bell' is "
                                             "single-RHS"):
            call()
    res = op.solve(bb[:, 0])                      # one column still works
    assert int(res.iters) > 0


def test_bare_callable_is_applied_per_column(system):
    """A matvec without ``batch_native`` is applied column by column (the
    reference's vmap); the result equals the batch-native path's."""
    _, _, _, bb = system
    op = port_op(system, "coo")
    b = op.scatter(bb)
    calls = []

    def single(x):
        calls.append(tuple(x.shape))
        return op.matvec(x)

    res = cg_solve(single, b, tol=1e-6, max_iters=1000, batched=True)
    want = cg_solve(op, b, tol=1e-6, max_iters=1000, batched=True)
    assert set(calls) == {(op.n,)}
    torch.testing.assert_close(res.x, want.x, rtol=1e-5, atol=1e-6)
    assert torch.equal(res.iters, want.iters)


def test_batched_result_does_not_depend_on_chunk(system, monkeypatch):
    _, _, _, bb = system
    op = port_op(system, "dist_halo")
    want = op.solve(bb, tol=1e-6, max_iters=1000)
    monkeypatch.setattr(tcg, "CHUNK", 1)
    got = op.solve(bb, tol=1e-6, max_iters=1000)
    assert torch.equal(got.iters, want.iters)
    torch.testing.assert_close(got.x, want.x, rtol=0, atol=0)


def test_zero_batch_and_max_iters_cap(system):
    _, _, _, bb = system
    op = port_op(system, "coo")
    res = cg_solve(op, op.scatter(np.zeros_like(bb)), batched=True)
    assert res.iters.tolist() == [0, 0, 0, 0]
    assert bool(torch.isfinite(res.residual).all())
    capped = cg_solve(op, op.scatter(bb), max_iters=5, batched=True)
    assert capped.iters.tolist() == [5, 5, 0, 5]


@pytest.mark.parametrize("bm,bk", [(8, 128), (16, 128), (8, 256),
                                   (16, 256)])
@pytest.mark.parametrize("nb", [1, 3, 16, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_multi_column_plain_version(bm, bk, nb, dtype):
    """``spmv_block_ell_multi_ref`` (the CPU path of ``spmv_bell_multi``)
    equals per-column ``spmv_block_ell_ref`` and scipy within 1e-4."""
    g = grid((20, 20))
    indptr, indices, data = laplacian_csr(g, shift=1e-2)
    A = sp.csr_matrix((data, indices, indptr), shape=(g.n, g.n))
    blocks, cols, _ = csr_to_block_ell(indptr, indices, data, g.n, bm=bm,
                                       bk=bk)
    bt = torch.from_numpy(blocks).to(dtype)
    ct = torch.from_numpy(cols)
    x = np.random.default_rng(nb).normal(size=(g.n, nb))
    xt = torch.from_numpy(x).to(dtype)
    got = spmv_block_ell(bt, ct, xt)
    assert got.shape == (g.n, nb) and got.dtype == dtype
    per_col = torch.stack([spmv_block_ell_ref(bt, ct, xt[:, j])
                           for j in range(nb)], dim=1)
    torch.testing.assert_close(got, per_col, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(spmv_block_ell_multi_ref(bt, ct, xt), got,
                               rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), A @ x.astype(
        np.float32 if dtype == torch.float32 else np.float64),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_multi_column_non_finite_as_reference(bad):
    """An Inf or NaN in X spreads as the reference's vmapped block-ELL
    kernel spreads it (a dense product: a zero block entry under an Inf
    gives NaN), in the column that holds it only.  ``spmv_bell_multi`` is
    held to the same pattern on the card by ``chip_smoke.py`` phase 3."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.spmv_bell import spmv_block_ell as ref_spmv

    g = grid((12, 12))
    indptr, indices, data = laplacian_csr(g, shift=1e-2)
    blocks, cols, _ = csr_to_block_ell(indptr, indices, data, g.n, bm=8,
                                       bk=128)
    x = np.random.default_rng(7).normal(size=(g.n, 3)).astype(np.float32)
    x[5, 1] = bad
    want = np.asarray(jax.vmap(
        lambda v: ref_spmv(jnp.asarray(blocks), jnp.asarray(cols), v,
                           interpret=True), in_axes=1, out_axes=1)(
        jnp.asarray(x)))
    got = spmv_block_ell(torch.from_numpy(blocks), torch.from_numpy(cols),
                         torch.from_numpy(x)).numpy()
    assert not np.isfinite(want[:, 1]).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-4)
