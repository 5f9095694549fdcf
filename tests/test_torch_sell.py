"""The sell route of the port's block-ELL SpMV on the CPU: the nonzero-entry
index (``kernels/spmv_bell.py::bell_index``) and the route's plain version
(``kernels/ref.py::spmv_sell_ref``), which the CUDA kernel ``spmv_sell`` is
held against on the card by chip_smoke.py.

The index must list exactly the blocks' nonzero entries, values bit for
bit.  The plain version is held against the dense plain versions and the
JAX package's Pallas kernel (interpret mode, float32 only: the reference
runs without x64, which this file must not switch on) within 1e-5 relative
in float32 (another order of the same sums) and 1e-12 in float64.  Inputs
come from numpy generators with fixed seeds; n stays at or below 512 (the
interpreted Pallas grid is stripes x NNZB).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.sparse import random as sprand

from replan_equiv import random_csr, random_delta
from repro.kernels.spmv_bell import _spmv_block_ell as ref_kernel
from repro_torch.kernels.ref import (spmv_block_ell_multi_ref,
                                     spmv_block_ell_ref, spmv_sell_ref)
from repro_torch.kernels import spmv_bell as sb
from repro_torch.kernels.spmv_bell import (SLICE, BellIndex, bell_index,
                                           csr_to_block_ell, spmv_block_ell)
from repro_torch.sparse import distributed as tdist
from repro_torch.sparse import operator as top
from repro_torch.sparse import replan as trep

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.float64: dict(rtol=1e-12, atol=1e-12)}
NP = {torch.float32: np.float32, torch.float64: np.float64}


def _csr(n, density, seed):
    A = sprand(n, n, density=density, random_state=seed, format="csr")
    return (A + A.T).tocsr()


def _blocks(n, bm, bk, dtype, seed, density=0.03, nnzb=None):
    A = _csr(n, density, seed)
    blocks, cols, _ = csr_to_block_ell(A.indptr, A.indices,
                                       A.data.astype(NP[dtype]), n, bm=bm,
                                       bk=bk, nnzb=nnzb)
    return torch.from_numpy(blocks), torch.from_numpy(cols), A


def _stack(blocks, cols, seed):
    """Three PU blocks: the matrix, a scaled copy, an empty one."""
    rng = np.random.default_rng(seed)
    scale = float(rng.uniform(0.5, 2.0))
    return (torch.stack([blocks, -scale * blocks, torch.zeros_like(blocks)]),
            torch.stack([cols, cols, cols]))


def _expected_entries(blocks, cols, n):
    """(row, col, value) of every nonzero block entry with row and column
    below n, in the index's order: rows ascending, then (block, column)."""
    b = blocks.numpy()
    if b.ndim == 4:
        b, c = b[None], cols.numpy()[None]
    else:
        c = cols.numpy()
    K, S, NNZB, BM, BK = b.shape
    rows, cs, vals = [], [], []
    for k in range(K):
        s, bb, m, t = np.nonzero(b[k])
        row = s * BM + m
        col = c[k][s, bb].astype(np.int64) * BK + t
        order = np.lexsort((t, bb, row))
        keep = (row[order] < n) & (col[order] < n)
        rows.append(row[order][keep] + k * n)
        cs.append(col[order][keep])
        vals.append(b[k][s, bb, m, t][order][keep])
    return np.concatenate(rows), np.concatenate(cs), np.concatenate(vals)


def _decode(index: BellIndex):
    """(row, col, value) of the index's entries, in slice order, and the
    padding entries' columns and values."""
    ptr = index.ptr.numpy().astype(np.int64)
    rows, cs, vals, pad_c, pad_v = [], [], [], [], []
    ic, iv = index.cols.numpy(), index.vals.numpy()
    for sl in range(len(ptr) - 1):
        w = (ptr[sl + 1] - ptr[sl]) // SLICE
        assert (ptr[sl + 1] - ptr[sl]) % SLICE == 0
        for lane in range(SLICE):
            pos = ptr[sl] + SLICE * np.arange(w) + lane
            live = ic[pos] >= 0
            # a row's entries come first, its padding after them
            assert live[:live.sum()].all()
            rows.append(np.full(int(live.sum()), sl * SLICE + lane))
            cs.append(ic[pos][live])
            vals.append(iv[pos][live])
            pad_c.append(ic[pos][~live])
            pad_v.append(iv[pos][~live])
    return (np.concatenate(rows), np.concatenate(cs), np.concatenate(vals),
            np.concatenate(pad_c), np.concatenate(pad_v))


def _assert_index_is_the_nonzeros(index, blocks, cols, n):
    K = blocks.shape[0] if blocks.dim() == 5 else 1
    assert (index.n, index.k) == (n, K)
    assert index.ptr.dtype == index.cols.dtype == torch.int32
    assert index.vals.dtype == blocks.dtype
    assert len(index.ptr) == -(-K * n // SLICE) + 1
    want = _expected_entries(blocks, cols, n)
    got = _decode(index)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # bit for bit
    np.testing.assert_array_equal(got[2].view(np.uint8),
                                  want[2].view(np.uint8))
    assert index.nnz == len(want[0])
    assert np.all(got[3] == -1) and np.all(got[4] == 0)
    # each slice as wide as its longest row
    counts = np.bincount(want[0], minlength=K * n)
    counts = np.pad(counts, (0, (-len(counts)) % SLICE))
    widths = np.diff(index.ptr.numpy().astype(np.int64)) // SLICE
    np.testing.assert_array_equal(widths, counts.reshape(-1, SLICE).max(1))


@pytest.mark.parametrize("bm,bk", [(1, 32), (8, 128), (32, 128), (8, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_index_is_the_blocks_nonzeros(bm, bk, dtype, monkeypatch):
    n = 300                              # not a multiple of BK: panels
    blocks, cols, _ = _blocks(n, bm, bk, dtype, seed=bm + bk)   # past n
    index = bell_index(blocks, cols, n)
    _assert_index_is_the_nonzeros(index, blocks, cols, n)
    b3, c3 = _stack(blocks, cols, seed=bm)
    i3 = bell_index(b3, c3, n)
    _assert_index_is_the_nonzeros(i3, b3, c3, n)
    # built over runs of stripes (a run of three, and of one stripe where
    # the limit is below one stripe's entries): the same index
    stripe = blocks[0].numel()
    for limit in (3 * stripe, 1):
        monkeypatch.setattr(sb, "MAX_NONZERO_ELEMS", limit)
        for blk, cl, want in ((blocks, cols, index), (b3, c3, i3)):
            got = bell_index(blk, cl, n)
            assert got.nnz == want.nnz
            for a, b in zip(got[:3], want[:3]):
                assert torch.equal(a, b)


def test_index_with_empty_rows_columns_past_n_and_a_lossy_nnzb():
    n, bm, bk = 200, 8, 32
    rng = np.random.default_rng(5)
    S = -(-n // bm)
    blocks = rng.normal(size=(S, 3, bm, bk)) * (rng.random((S, 3, bm, bk))
                                                < 0.05)
    blocks[:, :, 2] = 0                  # every stripe's row 2 is empty
    blocks[4] = 0                        # so is stripe 4
    cols = rng.integers(0, -(-n // bk), size=(S, 3)).astype(np.int32)
    bt, ct = torch.from_numpy(blocks), torch.from_numpy(cols)
    # nonzero entries in the last panel's columns at or past n, which the
    # product reads as zero
    col = ct.long()[:, :, None, None] * bk + torch.arange(bk)
    assert ((bt != 0) & (col >= n)).any()
    index = bell_index(bt, ct, n)
    _assert_index_is_the_nonzeros(index, bt, ct, n)
    x = torch.from_numpy(rng.normal(size=n))
    torch.testing.assert_close(spmv_block_ell(bt, ct, x, index=index),
                               spmv_block_ell_ref(bt, ct, x),
                               **TOL[torch.float64])
    # nnzb below the widest stripe drops panels: the index follows the
    # blocks that were kept
    blocks, cols, A = _blocks(256, 8, 32, torch.float32, seed=9,
                              density=0.06, nnzb=2)
    full = csr_to_block_ell(A.indptr, A.indices, A.data.astype(np.float32),
                            256, bm=8, bk=32)[0]
    assert full.shape[1] > 2
    _assert_index_is_the_nonzeros(bell_index(blocks, cols, 256), blocks,
                                  cols, 256)


def test_index_of_a_plan_has_empty_padding_rows():
    rng = np.random.default_rng(11)
    n, k = 120, 4
    ip, ix, d = random_csr(rng, n, density=0.06)
    part = np.repeat(np.arange(k), [60, 30, 20, 10]).astype(np.int32)
    plan = tdist.build_plan(ip, ix, d, part, k, device="cpu")
    blocks, cols = plan.bell_local(bm=8, bk=32)
    index = plan.bell_index(bm=8, bk=32)
    assert plan.bell_index(bm=8, bk=32) is index        # cached
    _assert_index_is_the_nonzeros(index, blocks, cols, plan.B)
    rows = _decode(index)[0]
    mask = plan.row_mask.numpy().reshape(-1)
    assert np.all(mask[rows] == 1)       # no entry in a padding row
    assert (mask == 0).any()


def _jax(blocks, cols, x):
    return np.asarray(ref_kernel(jnp.asarray(blocks.numpy()),
                                 jnp.asarray(cols.numpy()),
                                 jnp.asarray(x.numpy()), interpret=True))


@pytest.mark.parametrize("bm,bk,n", [(1, 32, 96), (8, 32, 300), (8, 128, 512),
                                     (32, 128, 400)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_version_single_and_stacked(bm, bk, n, dtype):
    blocks, cols, A = _blocks(n, bm, bk, dtype, seed=n + bm)
    x = torch.from_numpy(np.random.default_rng(n).normal(size=n)
                         .astype(NP[dtype]))
    index = bell_index(blocks, cols, n)
    got = spmv_block_ell(blocks, cols, x, index=index)
    assert got.dtype == dtype and got.shape == (n,)
    torch.testing.assert_close(got, spmv_block_ell_ref(blocks, cols, x),
                               **TOL[dtype])
    torch.testing.assert_close(got, torch.from_numpy(A.astype(NP[dtype])
                                                     @ x.numpy()),
                               **TOL[dtype])
    b3, c3 = _stack(blocks, cols, seed=n)
    x3 = torch.from_numpy(np.random.default_rng(n + 1).normal(size=(3, n))
                          .astype(NP[dtype]))
    i3 = bell_index(b3, c3, n)
    got3 = spmv_block_ell(b3, c3, x3, index=i3)
    assert got3.shape == (3, n)
    torch.testing.assert_close(got3, spmv_block_ell_ref(b3, c3, x3),
                               **TOL[dtype])
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), _jax(blocks, cols, x),
                                   **TOL[dtype])
        for k in range(3):
            np.testing.assert_allclose(got3[k].numpy(),
                                       _jax(b3[k], c3[k], x3[k]),
                                       **TOL[dtype])


@pytest.mark.parametrize("bm,bk", [(1, 32), (8, 128), (32, 128)])
@pytest.mark.parametrize("nb", [1, 3, 16, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_version_batched(bm, bk, nb, dtype):
    n = 160
    blocks, cols, A = _blocks(n, bm, bk, dtype, seed=nb + bm)
    xm = torch.from_numpy(np.random.default_rng(nb).normal(size=(n, nb))
                          .astype(NP[dtype]))
    got = spmv_block_ell(blocks, cols, xm, index=bell_index(blocks, cols,
                                                            n))
    assert got.dtype == dtype and got.shape == (n, nb)
    torch.testing.assert_close(got, spmv_block_ell_multi_ref(blocks, cols,
                                                             xm),
                               **TOL[dtype])
    if dtype == torch.float32 and nb in (1, 3):
        # the TPU kernel under the reference's jax.vmap over columns
        mv = jax.vmap(lambda v: ref_kernel(jnp.asarray(blocks.numpy()),
                                           jnp.asarray(cols.numpy()), v,
                                           interpret=True),
                      in_axes=-1, out_axes=-1)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(mv(jnp.asarray(xm.numpy()))),
                                   **TOL[dtype])


@pytest.mark.parametrize("form", ["single", "stacked", "batched"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_non_finite_x_spreads_as_in_the_dense_product(form, dtype):
    n = 256
    blocks, cols, _ = _blocks(n, 8, 128, dtype, seed=3)
    rng = np.random.default_rng(4)
    if form == "stacked":
        blocks, cols = _stack(blocks, cols, seed=4)
        x = rng.normal(size=(3, n))
        x[1, 5], x[0, 200] = np.inf, np.nan
        dense = spmv_block_ell_ref
    elif form == "batched":
        x = rng.normal(size=(n, 4))
        x[5, 1], x[200, 3] = np.inf, np.nan
        dense = spmv_block_ell_multi_ref
    else:
        x = rng.normal(size=n)
        x[5], x[200] = np.inf, -np.inf
        dense = spmv_block_ell_ref
    x = torch.from_numpy(x.astype(NP[dtype]))
    got = spmv_block_ell(blocks, cols, x, index=bell_index(blocks, cols, n))
    want = dense(blocks, cols, x)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert (~torch.isfinite(want)).any()
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], **TOL[dtype])
    # a zero entry under the Inf gives NaN: reading only the nonzeros
    # would leave those rows finite
    index = bell_index(blocks, cols, n)
    x0 = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    assert torch.isfinite(spmv_sell_ref(index, blocks, cols, x0)).all()


def test_an_index_that_does_not_fit_raises():
    blocks, cols, _ = _blocks(128, 8, 32, torch.float32, seed=1)
    index = bell_index(blocks, cols, 128)
    with pytest.raises(ValueError, match="index covers"):
        spmv_block_ell(blocks[:15], cols[:15], torch.ones(120),
                       index=index)
    with pytest.raises(ValueError, match="dtype"):
        spmv_block_ell(blocks.double(), cols, torch.ones(128), index=index)
    with pytest.raises(ValueError, match="do not fit"):
        spmv_block_ell(blocks, cols, torch.ones(100), index=index)


@pytest.mark.parametrize("seed", [21, 22])
def test_patched_plan_index_equals_a_fresh_plans(seed):
    rng = np.random.default_rng(seed)
    n, k = 64, 4
    ip, ix, d = random_csr(rng, n, density=0.08)
    part = rng.integers(0, k, size=n).astype(np.int32)
    base = tdist.build_plan_tree(ip, ix, d, part, None, k, fanouts=(2, 2),
                                 device="cpu")
    before = base.bell_index(bm=8, bk=32)
    delta = random_delta(rng, ip, ix, n, n_reweight=4, n_add=3, n_drop=2)
    patched = trep.apply_edge_delta(base, delta)
    fresh = tdist.build_plan_tree(*trep.apply_delta_csr(ip, ix, d, delta),
                                  part, None, k, fanouts=(2, 2),
                                  device="cpu")
    got = patched.bell_index(bm=8, bk=32)
    want = fresh.bell_index(bm=8, bk=32)
    assert got is not before
    assert (got.n, got.k, got.nnz) == (want.n, want.k, want.nnz)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    _assert_index_is_the_nonzeros(got, *patched.bell_local(bm=8, bk=32),
                                  patched.B)


def test_block_ell_operators_pass_the_index(monkeypatch):
    """bell, dist_bell and dist_hier_bell hand their index to every
    matvec, so on the card they reach the sell kernel."""
    seen = []
    real = spmv_block_ell

    def record(blocks, cols, x, index=None):
        seen.append(index)
        return real(blocks, cols, x, index=index)

    monkeypatch.setattr(top, "spmv_block_ell", record)
    monkeypatch.setattr(tdist, "spmv_block_ell", record)
    rng = np.random.default_rng(2)
    n, k = 96, 4
    ip, ix, d = random_csr(rng, n, density=0.06)
    part = rng.integers(0, k, size=n).astype(np.int32)
    ops = {"bell": top.make_operator(ip, ix, d, "bell", device="cpu"),
           "dist_bell": top.make_operator(ip, ix, d, "dist_bell", part=part,
                                          k=k, device="cpu"),
           "dist_hier_bell": top.make_operator(ip, ix, d, "dist_hier_bell",
                                               part=part, k=k, pods=2,
                                               device="cpu")}
    b = rng.normal(size=n).astype(np.float32)
    for name, op in ops.items():
        seen.clear()
        y = op.gather(op.matvec(op.scatter(b)))
        want = (op.index if name == "bell" else op.plan.bell_index())
        assert seen and all(i is want for i in seen), name
        Ad = np.zeros((n, n))
        Ad[np.repeat(np.arange(n), np.diff(ip)), ix] = d
        np.testing.assert_allclose(y, Ad @ b, rtol=1e-4, atol=1e-4)
    seen.clear()
    ops["bell"].matvec(torch.from_numpy(np.stack([b, 2 * b], 1)))
    assert seen == [ops["bell"].index]
