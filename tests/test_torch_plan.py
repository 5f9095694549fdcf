"""The port's distributed plan and stacked runtime against the JAX package.

``build_plan`` is host NumPy copied from the reference: every field is
bit-equal (dtypes included) on the tests/test_dist_plan.py configurations,
and the reference plan passes ``repro.analysis.verify_plan``.
``plan_from_arrays`` carries a reference plan into the port, where the
stacked ``dist_halo`` / ``dist_bell`` matvecs agree with scipy within 1e-4
(tests/test_operator.py:65) and the fused solves with the JAX ``coo``
solve within 1e-5 (tests/test_operator.py:78)."""
import numpy as np
import pytest
import scipy.sparse as sp

from repro.analysis import verify_plan
from repro.sparse import cg_solve_global as ref_cg_solve_global
from repro.sparse import make_operator as ref_make_operator
from repro.sparse.distributed import build_plan as ref_build_plan
from repro.sparse.generators import grid, rdg
from repro.sparse.graph import laplacian_csr
from repro_torch.sparse.distributed import (DEVICE_FIELDS, HOST_FIELDS,
                                            SCALAR_FIELDS, build_plan,
                                            plan_from_arrays)
from repro_torch.sparse.operator import (DistributedOperator,
                                         cg_solve_global, make_operator)

ALL_ARRAYS = DEVICE_FIELDS + HOST_FIELDS


def ref_fields(plan) -> dict:
    """A reference DistPlan's fields as numpy arrays."""
    out = {f: getattr(plan, f) for f in SCALAR_FIELDS}
    out.update({f: np.asarray(getattr(plan, f)) for f in ALL_ARRAYS})
    out["round_perms"] = plan.round_perms
    return out


def port_array(plan, f):
    v = getattr(plan, f)
    return v if isinstance(v, np.ndarray) else v.cpu().numpy()


def assert_plans_equal(port, ref):
    for f in SCALAR_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    assert port.round_perms == ref.round_perms
    for f in ALL_ARRAYS:
        a, b = port_array(port, f), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture(scope="module")
def lap():
    g = rdg(800, seed=7)
    indptr, indices, data = laplacian_csr(g, shift=1e-2)
    A = sp.csr_matrix((data, indices, indptr), shape=(g.n, g.n))
    return g, (indptr, indices, data), A


@pytest.mark.parametrize("k", [4, 8])
def test_build_plan_bit_equal(lap, k):
    g, (indptr, indices, data), _ = lap
    part = np.random.default_rng(200 + k).integers(0, k, g.n)
    ref = ref_build_plan(indptr, indices, data, part, k, validate=False)
    assert verify_plan(ref).ok
    port = build_plan(indptr, indices, data, part, k, device="cpu")
    assert_plans_equal(port, ref)
    assert_plans_equal(plan_from_arrays(ref_fields(ref), "cpu"), ref)
    x = np.random.default_rng(1).normal(size=g.n).astype(np.float32)
    np.testing.assert_array_equal(port.scatter_vec(x), ref.scatter_vec(x))
    np.testing.assert_array_equal(port.gather_vec(port.scatter_vec(x)), x)


def test_build_plan_bit_equal_with_empty_blocks():
    g = grid((16, 16))
    indptr, indices, data = laplacian_csr(g, shift=1e-2)
    part = np.where(np.arange(g.n) < g.n // 2, 0, 2)
    ref = ref_build_plan(indptr, indices, data, part, 4, validate=False)
    assert_plans_equal(build_plan(indptr, indices, data, part, 4,
                                  device="cpu"), ref)


def test_bell_local_bit_equal(lap):
    g, (indptr, indices, data), _ = lap
    part = np.random.default_rng(5).integers(0, 4, g.n)
    ref = ref_build_plan(indptr, indices, data, part, 4, validate=False)
    port = plan_from_arrays(ref_fields(ref), "cpu")
    for bm, bk in ((8, 128), (16, 256)):
        rb, rc = ref.bell_local(bm, bk)
        pb, pc = port.bell_local(bm, bk)
        for a, b in ((pb, rb), (pc, rc)):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("backend", ["dist_halo", "dist_bell"])
def test_stacked_matvec_on_reference_plan_matches_scipy(lap, k, backend):
    g, (indptr, indices, data), A = lap
    part = np.random.default_rng(100 + k).integers(0, k, g.n)
    ref = ref_build_plan(indptr, indices, data, part, k, validate=False)
    plan = plan_from_arrays(ref_fields(ref), "cpu")
    op = DistributedOperator(
        plan=plan, local_format="bell" if backend == "dist_bell" else "coo")
    x = np.random.default_rng(2).normal(size=g.n).astype(np.float32)
    y = op.gather(op.matvec(op.scatter(x)))
    np.testing.assert_allclose(y, A @ x, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("backend", ["dist_halo", "dist_bell"])
@pytest.mark.parametrize("precondition", [None, "jacobi"])
def test_fused_solve_matches_jax_coo(lap, backend, precondition):
    """Solutions at tol=1e-7 within 1e-5; iteration counts within 1 at
    tol=1e-6.  At 1e-7 the float32 residual sits at its rounding floor,
    where the count depends on the order of the sums (ROADMAP queue 3)."""
    g, (indptr, indices, data), A = lap
    b = np.random.default_rng(1).normal(size=g.n).astype(np.float32)
    part = np.random.default_rng(0).integers(0, 8, g.n)
    op = make_operator(indptr, indices, data, backend, part=part, k=8,
                       device="cpu")
    ref_op = ref_make_operator(indptr, indices, data, "coo")
    for tol in (1e-7, 1e-6):
        ref_x, ref_it, _ = ref_cg_solve_global(
            ref_op, b, tol=tol, max_iters=2000, precondition=precondition)
        res = op.solve(b, tol=tol, max_iters=2000,
                       precondition=precondition)
        x = op.gather(res.x)
        assert np.abs(x - ref_x).max() / np.abs(ref_x).max() < 1e-5
        # the composable path (cg_solve over the Operator) agrees too
        x2, it2, _ = cg_solve_global(op, b, tol=tol, max_iters=2000,
                                     precondition=precondition,
                                     device="cpu")
        assert np.abs(x2 - ref_x).max() / np.abs(ref_x).max() < 1e-5
    assert abs(int(res.iters) - ref_it) <= 1
    assert abs(it2 - ref_it) <= 1


def test_one_block_plan_has_no_halo(lap):
    g, (indptr, indices, data), A = lap
    op = make_operator(indptr, indices, data, "dist_bell",
                       part=np.zeros(g.n, int), k=1, device="cpu")
    x = np.random.default_rng(3).normal(size=g.n).astype(np.float32)
    np.testing.assert_allclose(op.gather(op.matvec(op.scatter(x))), A @ x,
                               atol=1e-4, rtol=1e-4)
