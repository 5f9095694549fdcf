"""The port's single-device SpMV and chunked CG against the JAX package on
the tests/test_operator.py system: rdg(300, seed=5), laplacian_csr(shift=
0.1).

Tolerances: spmv_coo within 1e-6 relative (float32 sums in another order);
CG solutions within 1e-5 relative to the largest entry and iteration counts
within 1 (tests/test_operator.py:78 and tests/test_cg_batched.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.sparse import cg_solve as ref_cg_solve
from repro.sparse import cg_solve_global as ref_cg_solve_global
from repro.sparse import make_operator as ref_make_operator
from repro.sparse.generators import rdg
from repro.sparse.graph import laplacian_csr
from repro.sparse.spmv import spmv_coo as ref_spmv_coo
from repro_torch.sparse.cg import cg_solve
from repro_torch.sparse.operator import (BlockEllOperator, CooOperator,
                                         Operator, cg_solve_global,
                                         make_operator)
from repro_torch.sparse.spmv import csr_to_padded_coo, spmv_coo


@pytest.fixture(scope="module")
def system():
    g = rdg(300, seed=5)
    indptr, indices, data = laplacian_csr(g, shift=0.1)
    A = sp.csr_matrix((data, indices, indptr), shape=(g.n, g.n))
    b = np.random.default_rng(1).normal(size=g.n).astype(np.float32)
    return (indptr, indices, data), A, b


def rel_err(x, ref):
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def test_spmv_coo_matches_jax(system):
    (indptr, indices, data), A, b = system
    r, c, v = csr_to_padded_coo(indptr, indices, data, len(indices) + 9)
    x = np.random.default_rng(0).normal(size=A.shape[0]).astype(np.float32)
    want = np.asarray(ref_spmv_coo(jnp.asarray(r), jnp.asarray(c),
                                   jnp.asarray(v), jnp.asarray(x),
                                   n=A.shape[0]))
    got = spmv_coo(torch.from_numpy(r.astype(np.int64)),
                   torch.from_numpy(c.astype(np.int64)),
                   torch.from_numpy(v), torch.from_numpy(x), n=A.shape[0])
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want) < 1e-6
    # trailing RHS-batch axis rides along
    xb = np.stack([x, 2 * x], axis=1)
    gotb = spmv_coo(torch.from_numpy(r.astype(np.int64)),
                    torch.from_numpy(c.astype(np.int64)),
                    torch.from_numpy(v), torch.from_numpy(xb))
    np.testing.assert_allclose(gotb.numpy()[:, 1], 2 * got.numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("backend", ["coo", "bell"])
def test_operator_matvec_and_diag(system, backend):
    (indptr, indices, data), A, b = system
    op = make_operator(indptr, indices, data, backend, device="cpu")
    assert isinstance(op, Operator) and op.n == A.shape[0]
    assert isinstance(op, {"coo": CooOperator,
                           "bell": BlockEllOperator}[backend])
    x = np.random.default_rng(0).normal(size=op.n)      # float64 host data
    xs = op.scatter(x)
    assert xs.dtype == torch.float32                     # x64-off cast
    np.testing.assert_allclose(op.gather(op.matvec(xs)),
                               A @ x.astype(np.float32), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(op.diag().numpy(), A.diagonal(), rtol=1e-6)


@pytest.mark.parametrize("precondition", [None, "jacobi"])
def test_cg_solve_matches_jax(system, precondition):
    (indptr, indices, data), A, b = system
    ref_op = ref_make_operator(indptr, indices, data, "coo")
    want = ref_cg_solve(ref_op, jnp.asarray(b), tol=1e-7, max_iters=2000,
                        precondition=precondition)
    op = make_operator(indptr, indices, data, "coo", device="cpu")
    got = cg_solve(op, op.scatter(b), tol=1e-7, max_iters=2000,
                   precondition=precondition)
    assert rel_err(got.x.numpy(), np.asarray(want.x)) < 1e-5
    assert abs(int(got.iters) - int(want.iters)) <= 1
    assert got.iters.dtype == torch.int32


@pytest.mark.parametrize("backend", ["coo", "bell"])
@pytest.mark.parametrize("precondition", [None, "jacobi"])
def test_cg_solve_global_matches_jax_coo(system, backend, precondition):
    (indptr, indices, data), A, b = system
    ref_x, ref_it, _ = ref_cg_solve_global(
        ref_make_operator(indptr, indices, data, "coo"), b, tol=1e-7,
        max_iters=2000, precondition=precondition)
    op = make_operator(indptr, indices, data, backend, device="cpu")
    x, it, res = cg_solve_global(op, b, tol=1e-7, max_iters=2000,
                                 precondition=precondition, device="cpu")
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-4
    assert rel_err(x, ref_x) < 1e-5
    assert abs(it - ref_it) <= 1


@pytest.mark.parametrize("precondition", [None, "jacobi"])
def test_chunk_size_does_not_change_the_result(system, precondition,
                                               monkeypatch):
    """Iterations after convergence inside a chunk are exact no-ops."""
    from repro_torch.sparse import cg as tcg
    (indptr, indices, data), A, b = system
    op = make_operator(indptr, indices, data, "coo", device="cpu")
    runs = []
    for m in (1, 8, 64):
        monkeypatch.setattr(tcg, "CHUNK", m)
        runs.append(cg_solve(op, op.scatter(b), tol=1e-6, max_iters=2000,
                             precondition=precondition))
    for r in runs[1:]:
        assert int(r.iters) == int(runs[0].iters)
        assert torch.equal(r.x, runs[0].x)
        assert torch.equal(r.residual, runs[0].residual)


def test_max_iters_caps_the_count(system):
    (indptr, indices, data), A, b = system
    op = make_operator(indptr, indices, data, "coo", device="cpu")
    got = cg_solve(op, op.scatter(b), tol=1e-12, max_iters=5)
    want = ref_cg_solve(ref_make_operator(indptr, indices, data, "coo"),
                        jnp.asarray(b), tol=1e-12, max_iters=5)
    assert int(got.iters) == int(want.iters) == 5
    assert rel_err(got.x.numpy(), np.asarray(want.x)) < 1e-5


def test_zero_rhs_takes_no_iterations(system):
    (indptr, indices, data), A, b = system
    op = make_operator(indptr, indices, data, "coo", device="cpu")
    res = cg_solve(op, op.scatter(np.zeros(op.n, np.float32)), tol=1e-6,
                   max_iters=50)
    assert int(res.iters) == 0
    assert torch.all(res.x == 0)
    assert torch.isfinite(res.residual)


def test_float32_tiny_scale_converges():
    """A = 1e-35 * I in float32: the dtype-aware safe division takes the
    exact Newton step, as in the reference (tests/test_serving.py)."""
    n = 8
    s = np.float32(1e-35)
    indptr = np.arange(n + 1, dtype=np.int64)
    indices = np.arange(n, dtype=np.int32)
    data = np.full(n, s, dtype=np.float32)
    b = np.ones(n, np.float32)
    op = CooOperator.from_csr(indptr, indices, data, device="cpu")
    res = cg_solve(op, op.scatter(b), tol=1e-6, max_iters=50)
    ref_op = ref_make_operator(indptr, indices, data, "coo")
    want = ref_cg_solve(ref_op, ref_op.scatter(b), tol=1e-6, max_iters=50)
    assert int(res.iters) <= 2
    assert int(res.iters) == int(want.iters)
    np.testing.assert_allclose(res.x.numpy(), np.full(n, 1.0 / s),
                               rtol=1e-5)


def test_unported_modes_name_their_roadmap_item(system):
    """Batched multi-RHS CG (queue 1 item 7) is ported: a batched RHS
    solves on ``coo``, ``dist_halo`` and ``dist_hier`` through every entry
    point, with per-column iterations.  Every reference backend and
    preconditioner is ported, so only unknown names and missing arguments
    raise."""
    (indptr, indices, data), A, b = system
    bb = np.stack([b, 2 * b], axis=1)
    op = make_operator(indptr, indices, data, "coo", device="cpu")
    res = cg_solve(op, op.scatter(b)[:, None], batched=True)
    assert res.iters.shape == (1,) and res.x.shape == (op.n, 1)
    x, iters, resid = cg_solve_global(op, bb, device="cpu")
    assert x.shape == (op.n, 2) and iters.shape == resid.shape == (2,)
    np.testing.assert_allclose(x[:, 1], 2 * x[:, 0], rtol=1e-4, atol=1e-6)
    part = np.arange(op.n) % 4
    for backend, kw in (("dist_halo", {}), ("dist_hier", {"pods": 2})):
        dop = make_operator(indptr, indices, data, backend, part=part, k=4,
                            device="cpu", **kw)
        fused = dop.solve(bb)
        composed = cg_solve(dop, dop.scatter(bb), batched=True)
        for res in (fused, composed):
            assert res.iters.shape == (2,)
            np.testing.assert_allclose(dop.gather(res.x), x, rtol=1e-4,
                                       atol=1e-5)
    with pytest.raises(ValueError):
        make_operator(indptr, indices, data, "nope", device="cpu")
    with pytest.raises(ValueError):
        make_operator(indptr, indices, data, "dist_halo", device="cpu")
