"""The port's kernels on the CPU against the JAX package's Pallas kernels
(interpret mode), on the shapes of tests/test_kernels.py.

On the CPU each wrapper takes its plain PyTorch version, so this holds the
plain versions — the yardsticks the CUDA kernels are held against on the
card by chip_smoke.py — against the TPU kernels.  Tolerances are those of
tests/test_kernels.py: pdist 1e-4 in float32 and 3e-2 in bfloat16 (inputs
rounded to bf16, the sum in f32 in another order); block-ELL SpMV 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pdist import pairwise_sqdist_pallas
from repro.kernels.spmv_bell import csr_to_block_ell as ref_csr_to_bell
from repro.kernels.spmv_bell import spmv_block_ell as ref_spmv_bell
from repro_torch.kernels import _build
from repro_torch.kernels.pdist import pairwise_sqdist
from repro_torch.kernels.ref import spmv_block_ell_ref
from repro_torch.kernels.spmv_bell import csr_to_block_ell, spmv_block_ell

_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("n,k,d", [(32, 8, 2), (100, 7, 3), (257, 33, 2),
                                   (512, 128, 3), (65, 1, 2)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_pdist_matches_pallas(n, k, d, dtype):
    rng = np.random.default_rng(n + k)
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    want = np.asarray(pairwise_sqdist_pallas(jnp.asarray(x, dtype),
                                             jnp.asarray(c, dtype),
                                             interpret=True))
    # the same rounded inputs on both sides
    xt = torch.from_numpy(x).to(_TORCH[dtype])
    ct = torch.from_numpy(c).to(_TORCH[dtype])
    got = pairwise_sqdist(xt, ct)
    assert got.dtype == torch.float32 and got.shape == (n, k)
    tol = 1e-4 if dtype == jnp.float32 else 3e-2
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


def _sym_csr(n, density):
    from scipy.sparse import random as sprand
    A = sprand(n, n, density=density, random_state=n, format="csr")
    return (A + A.T).tocsr()


@pytest.mark.parametrize("n,density,bm,bk", [
    (64, 0.1, 8, 128), (300, 0.02, 8, 128), (513, 0.01, 8, 128),
    (128, 0.05, 16, 128), (200, 0.03, 8, 256),
])
def test_spmv_block_ell_matches_pallas(n, density, bm, bk):
    A = _sym_csr(n, density)
    data = A.data.astype(np.float32)
    blocks, cols, meta = csr_to_block_ell(A.indptr, A.indices, data, n,
                                          bm=bm, bk=bk)
    rb, rc, rmeta = ref_csr_to_bell(A.indptr, A.indices, data, n, bm=bm,
                                    bk=bk)
    # the host converter is a copy: bit-equal, dtypes included
    np.testing.assert_array_equal(blocks, rb)
    np.testing.assert_array_equal(cols, rc)
    assert blocks.dtype == rb.dtype and cols.dtype == rc.dtype
    assert meta == rmeta and meta["fill"] == 1.0
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    want = np.asarray(ref_spmv_bell(jnp.asarray(blocks), jnp.asarray(cols),
                                    jnp.asarray(x), interpret=True))
    got = spmv_block_ell(torch.from_numpy(blocks), torch.from_numpy(cols),
                         torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), A @ x, atol=1e-4, rtol=1e-4)


def test_spmv_empty_rows_are_exact_zeros():
    n = 40
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[2:] = 3                           # only row 1 has entries
    indices = np.array([0, 5, 7], dtype=np.int32)
    data = np.array([1.0, 2.0, 3.0], dtype=np.float32)
    blocks, cols, _ = csr_to_block_ell(indptr, indices, data, n)
    x = np.arange(n, dtype=np.float32)
    want = np.asarray(ref_spmv_bell(jnp.asarray(blocks), jnp.asarray(cols),
                                    jnp.asarray(x), interpret=True))
    y = spmv_block_ell(torch.from_numpy(blocks), torch.from_numpy(cols),
                       torch.from_numpy(x)).numpy()
    assert y[1] == pytest.approx(0 * 1 + 5 * 2 + 7 * 3)
    assert np.all(y[2:] == 0) and y[0] == 0
    np.testing.assert_allclose(y, want, atol=1e-4, rtol=1e-4)


def test_spmv_accumulates_in_the_blocks_dtype():
    """float64 blocks keep float64 accumulation, as the TPU kernel does
    (the JAX oracle ``kernels/ref.py`` casts to float32; the kernel and
    the port do not)."""
    A = _sym_csr(300, 0.02)
    blocks, cols, _ = csr_to_block_ell(A.indptr, A.indices, A.data, 300)
    assert blocks.dtype == np.float64
    x = np.random.default_rng(0).normal(size=300)
    y = spmv_block_ell(torch.from_numpy(blocks), torch.from_numpy(cols),
                       torch.from_numpy(x))
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), A @ x, rtol=1e-12, atol=1e-12)


def test_stacked_form_is_one_single_form_per_block():
    rng = np.random.default_rng(3)
    K, S, NNZB, BM, BK, n = 3, 7, 2, 8, 128, 50
    blocks = torch.from_numpy(
        rng.normal(size=(K, S, NNZB, BM, BK)).astype(np.float32))
    cols = torch.zeros((K, S, NNZB), dtype=torch.int32)
    x = torch.from_numpy(rng.normal(size=(K, n)).astype(np.float32))
    y = spmv_block_ell(blocks, cols, x)
    assert y.shape == (K, n)
    for kk in range(K):
        torch.testing.assert_close(
            y[kk], spmv_block_ell_ref(blocks[kk], cols[kk], x[kk]))


def test_cpu_path_launches_nothing():
    _build.reset_launches()
    x = torch.ones(10, 2)
    pairwise_sqdist(x, x)
    A = _sym_csr(64, 0.1)
    blocks, cols, _ = csr_to_block_ell(A.indptr, A.indices,
                                       A.data.astype(np.float32), 64)
    spmv_block_ell(torch.from_numpy(blocks), torch.from_numpy(cols),
                   torch.ones(64))
    assert _build.launches() == {"pdist": 0, "spmv_bell": 0}


def test_kernel_build_is_keyed_by_source_hash():
    p1 = _build.library_path("pdist")
    p2 = _build.library_path("spmv_bell")
    assert p1.parent == p2.parent == _build.BUILD_DIR
    assert p1.name.startswith("libpdist-") and p1 != p2
    assert _build.library_path("pdist") == p1          # stable
