"""Block-ELL SpMV: host converters, the nonzero-entry index and the CUDA
kernel's wrapper.

Block-ELL groups rows into stripes of BM rows and columns into panels of BK
columns; each stripe stores exactly NNZB dense (BM, BK) blocks plus their
panel indices:

    y[stripe] = sum_b  blocks[stripe, b] @ x[cols[stripe, b]]

The converters are host NumPy, copied from
``src/repro/kernels/spmv_bell.py`` and bit-equal to it.
``spmv_block_ell`` launches the hand-written CUDA kernel ``spmv_sell`` of
``csrc/spmv_bell.cu`` for tensors on the card; it replaces the Pallas TPU
kernel ``src/repro/kernels/spmv_bell.py::_spmv_block_ell``, alone and
under the reference's ``jax.vmap`` (batched CG on ``bell``).  The
reference's blocks are mostly zero padding (99% of the bm 8 x bk 128
blocks of a 5-point Laplacian), so the kernel reads only their nonzero
entries, which :func:`bell_index` lists once per operator (a
:class:`BellIndex`, sliced ELL), in any of three forms: one vector, one
per PU block of a stacked plan (counted as ``spmv_bell:sell``), an (n, nb)
batch (``spmv_bell_multi:sell``).

The design notes are in the source.  Tensors on the CPU go to the plain
versions (:func:`.ref.spmv_sell_ref` with an index, else
:func:`.ref.spmv_block_ell_ref` / :func:`.ref.spmv_block_ell_multi_ref`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .ref import spmv_block_ell_multi_ref, spmv_block_ell_ref, spmv_sell_ref

_FN_SELL = {torch.float32: "spmv_sell_f32", torch.float64: "spmv_sell_f64"}
SLICE = 32                        # rows per slice of the sliced-ELL index
MAX_NONZERO_ELEMS = 1 << 30       # mask elements per nonzero() in bell_index


# --------------------------------------------------------------------------
# Format conversion (host-side, NumPy): CSR -> block-ELL
# --------------------------------------------------------------------------

def csr_to_block_ell(indptr: np.ndarray, indices: np.ndarray,
                     data: np.ndarray, n: int, bm: int = 8, bk: int = 128,
                     nnzb: int | None = None):
    """Convert CSR to block-ELL.

    Returns (blocks, cols, meta) where
      blocks: (S, NNZB, BM, BK) — dense blocks per stripe, in the dtype
              of ``data`` (float dtypes preserved, else float32)
      cols:   (S, NNZB) int32 — column-panel index of each block
      meta:   dict(n=n, bm=bm, bk=bk, fill=fraction of nonzero cells kept)
    If nnzb is None it is set to the max #panels touched by any stripe
    (lossless).  Smaller nnzb drops the sparsest panels (lossy — for
    preconditioner-style use; tests use lossless).
    """
    data = np.asarray(data)
    vdt = data.dtype if np.issubdtype(data.dtype, np.floating) \
        else np.float32
    S = -(-n // bm)
    per_stripe: list[dict[int, np.ndarray]] = [dict() for _ in range(S)]
    for i in range(n):
        s = i // bm
        row = slice(indptr[i], indptr[i + 1])
        for j, v in zip(indices[row], data[row]):
            p = int(j) // bk
            blk = per_stripe[s].get(p)
            if blk is None:
                blk = np.zeros((bm, bk), dtype=vdt)
                per_stripe[s][p] = blk
            blk[i % bm, int(j) % bk] += v
    max_panels = max((len(d) for d in per_stripe), default=1) or 1
    if nnzb is None:
        nnzb = max_panels
    blocks = np.zeros((S, nnzb, bm, bk), dtype=vdt)
    cols = np.zeros((S, nnzb), dtype=np.int32)
    kept = total = 0
    for s, panels in enumerate(per_stripe):
        items = sorted(panels.items(),
                       key=lambda kv: -np.count_nonzero(kv[1]))
        total += sum(np.count_nonzero(b) for _, b in items)
        for b, (p, blk) in enumerate(items[:nnzb]):
            blocks[s, b] = blk
            cols[s, b] = p
            kept += np.count_nonzero(blk)
    meta = dict(n=n, bm=bm, bk=bk, nnzb=nnzb,
                fill=kept / max(total, 1))
    return blocks, cols, meta


def padded_coo_to_block_ell(rows: np.ndarray, cols: np.ndarray,
                            vals: np.ndarray, n: int, bm: int = 8,
                            bk: int = 128, nnzb: int | None = None):
    """Convert padded COO (one PU block's local matrix) to block-ELL.

    Fully vectorized NumPy.  Zero-valued entries (the padding convention of
    the packed plan layouts) are dropped before blocking, so padded slots
    never allocate a panel.  Returns (blocks, cols, meta) with the shapes of
    :func:`csr_to_block_ell`; panels within a stripe are ordered by panel
    index, and NNZB defaults to the max #panels of any stripe (lossless).
    """
    rows = np.asarray(rows).ravel()
    cols = np.asarray(cols).ravel()
    vals = np.asarray(vals).ravel()
    if not np.issubdtype(vals.dtype, np.floating):
        vals = vals.astype(np.float32)
    live = vals != 0
    rows, cols, vals = rows[live], cols[live], vals[live]
    S = max(-(-n // bm), 1)
    stripe = rows // bm
    panel = cols // bk
    Pn = max(-(-int(cols.max() + 1) // bk), 1) if len(cols) else 1
    key = stripe.astype(np.int64) * Pn + panel
    uniq, inv = np.unique(key, return_inverse=True)
    u_stripe = (uniq // Pn).astype(np.int64)
    u_panel = (uniq % Pn).astype(np.int32)
    per_stripe = np.bincount(u_stripe, minlength=S)
    max_panels = max(int(per_stripe.max()) if len(per_stripe) else 0, 1)
    if nnzb is None:
        nnzb = max_panels
    # slot of each unique (stripe, panel) within its stripe: uniq is sorted
    # by (stripe, panel), so the slot is the rank inside the stripe group
    grp_start = np.repeat(np.cumsum(per_stripe) - per_stripe, per_stripe)
    slot = (np.arange(len(uniq)) - grp_start).astype(np.int64)
    blocks = np.zeros((S, nnzb, bm, bk), dtype=vals.dtype)
    colsb = np.zeros((S, nnzb), dtype=np.int32)
    u_keep = slot < nnzb
    colsb[u_stripe[u_keep], slot[u_keep]] = u_panel[u_keep]
    e_slot = slot[inv]
    keep = e_slot < nnzb
    np.add.at(blocks, (stripe[keep], e_slot[keep],
                       rows[keep] % bm, cols[keep] % bk), vals[keep])
    kept = int(keep.sum())
    meta = dict(n=n, bm=bm, bk=bk, nnzb=nnzb,
                fill=kept / max(len(vals), 1))
    return blocks, colsb, meta


# --------------------------------------------------------------------------
# The nonzero-entry index (sliced ELL), built on the device
# --------------------------------------------------------------------------

class BellIndex(NamedTuple):
    """The nonzero entries of a block-ELL matrix in sliced ELL.

    Rows are the K * n rows of the K PU blocks (K = 1 for the single and
    batched forms), PU block k's row i being row k * n + i, in slices of
    ``SLICE`` consecutive rows; each slice is padded to its longest row and
    stored column-major, so entry j of row r lies at
    ``ptr[r // 32] + 32 * j + r % 32``.  An entry is one block entry that
    is not zero, with its column ``cols[k, s, b] * BK + t`` within its PU
    block (kept only when < n) and its value bit for bit; padding entries
    have column -1 and value 0."""

    ptr: torch.Tensor    # (ceil(K n / 32) + 1,) int32 first entry per slice
    cols: torch.Tensor   # (E,) int32 column within the row's PU block
    vals: torch.Tensor   # (E,) the blocks' dtype
    n: int               # rows of a PU block, the length of its x
    k: int               # PU blocks
    nnz: int             # entries that are not padding


def bell_index(blocks: torch.Tensor, cols: torch.Tensor,
               n: int) -> BellIndex:
    """The :class:`BellIndex` of ``blocks`` (S, NNZB, BM, BK) or (K, S,
    NNZB, BM, BK) and ``cols``, whose rows and x have length ``n``.

    A format conversion, paid once per operator: plain tensor ops on the
    blocks' device, over runs of stripes of at most
    ``MAX_NONZERO_ELEMS`` block entries each (one stripe at least), since
    ``nonzero`` may refuse a tensor of more than 2^31 elements on the
    card."""
    if blocks.dim() == 4:
        blocks, cols = blocks[None], cols[None]
    K, S, NNZB, BM, BK = blocks.shape
    if S != -(-n // BM):
        raise ValueError(f"bell_index: {S} stripes of {BM} rows do not fit "
                         f"n={n}")
    dev = blocks.device
    step = max(MAX_NONZERO_ELEMS // max(NNZB * BM * BK, 1), 1)
    rows_k, cols_k, vals_k = [], [], []
    counts = torch.zeros(K * n, dtype=torch.long, device=dev)
    for kk in range(K):
        for s0 in range(0, S, step):
            blk = blocks[kk, s0:s0 + step]
            # (s, m, b, t) in row-major order: rows ascending, and the
            # entries of a row in (block, column) order
            s, m, b, t = (blk != 0).permute(0, 2, 1, 3).nonzero().unbind(1)
            row = (s + s0) * BM + m
            col = cols[kk, s0:s0 + step].long()[s, b] * BK + t
            keep = (row < n) & (col < n)
            s, m, b, t = s[keep], m[keep], b[keep], t[keep]
            row = row[keep] + kk * n
            counts += torch.bincount(row, minlength=K * n)
            rows_k.append(row)
            cols_k.append(col[keep])
            vals_k.append(blk[s, b, m, t])
    rows = K * n
    row = torch.cat(rows_k) if rows_k else torch.zeros(0, dtype=torch.long,
                                                       device=dev)
    n_sl = -(-rows // SLICE)
    cnt = torch.zeros(n_sl * SLICE, dtype=torch.long, device=dev)
    cnt[:rows] = counts
    width = cnt.view(n_sl, SLICE).amax(1)
    ptr = torch.zeros(n_sl + 1, dtype=torch.long, device=dev)
    ptr[1:] = torch.cumsum(width * SLICE, 0)
    total = int(ptr[-1])
    if total >= 2 ** 31:
        raise ValueError(f"bell_index: {total} entries overflow int32")
    start = torch.cumsum(cnt, 0) - cnt                  # first entry of a row
    j = torch.arange(len(row), device=dev) - start[row]
    pos = ptr[row // SLICE] + SLICE * j + row % SLICE
    icols = torch.full((total,), -1, dtype=torch.int32, device=dev)
    ivals = torch.zeros(total, dtype=blocks.dtype, device=dev)
    if rows_k:
        icols[pos] = torch.cat(cols_k).int()
        ivals[pos] = torch.cat(vals_k)
    return BellIndex(ptr=ptr.int(), cols=icols, vals=ivals, n=n, k=K,
                     nnz=len(row))


# --------------------------------------------------------------------------
# Kernel wrapper
# --------------------------------------------------------------------------

def spmv_block_ell(blocks: torch.Tensor, cols: torch.Tensor,
                   x: torch.Tensor,
                   index: BellIndex | None = None) -> torch.Tensor:
    """y = A @ x with A in block-ELL, in the blocks' dtype (float32 or
    float64); x is cast to it, as the TPU kernel does.

    Single form: blocks (S, NNZB, BM, BK), cols (S, NNZB) int32, x (n,)
    -> (n,).  Batched form: the same blocks, x (n, nb) -> (n, nb), column
    j being A @ x[:, j].  Stacked form (one launch for every PU block of a
    distributed plan): blocks (K, S, NNZB, BM, BK), cols (K, S, NNZB), x
    (K, n) -> (K, n).  S must be ceil(n / BM).

    ``index`` is :func:`bell_index` of these blocks, which the operators
    build once and pass to every call; on the card a call without one
    builds it first."""
    multi = blocks.dim() == 4 and x.dim() == 2
    if blocks.device.type == "cpu" and cols.device.type == "cpu" \
            and x.device.type == "cpu":
        if index is None:
            return (spmv_block_ell_multi_ref(blocks, cols, x) if multi
                    else spmv_block_ell_ref(blocks, cols, x))
        _check_sell(blocks, cols, x, index, multi)
        return spmv_sell_ref(index, blocks, cols, x)
    dev = blocks.device
    if dev.type != "cuda" or cols.device != dev or x.device != dev:
        raise ValueError(f"spmv_block_ell: blocks, cols and x must lie on "
                         f"one CUDA device (got {blocks.device}, "
                         f"{cols.device}, {x.device})")
    if index is None:
        if blocks.dim() not in (4, 5):
            raise ValueError(f"spmv_block_ell: blocks of shape "
                             f"{tuple(blocks.shape)} is neither (S, NNZB, "
                             f"BM, BK) nor (K, S, NNZB, BM, BK)")
        index = bell_index(blocks, cols, x.shape[-2] if multi
                           else x.shape[-1])
    return _spmv_sell(blocks, cols, x, index, multi)


def _check_sell(blocks: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                index: BellIndex, multi: bool) -> tuple:
    """Check that ``index`` and x fit the blocks, on either device;
    returns (K, S, NNZB, BM, BK, n, nb)."""
    stacked = blocks.dim() == 5
    K = blocks.shape[0] if stacked else 1
    S, NNZB, BM, BK = blocks.shape[-4:]
    if blocks.dtype not in _FN_SELL:
        raise TypeError(f"spmv_block_ell takes float32 or float64 blocks, "
                        f"got {blocks.dtype}")
    if cols.dtype != torch.int32:
        raise TypeError(f"spmv_block_ell: cols must be int32, got "
                        f"{cols.dtype}")
    n = x.shape[-2] if multi else x.shape[-1]
    nb = x.shape[1] if multi else 1
    if (x.dim() != (2 if stacked or multi else 1)
            or (stacked and x.shape[0] != K)
            or cols.shape != blocks.shape[:-2] or S != -(-n // BM)):
        raise ValueError(f"spmv_block_ell: blocks {tuple(blocks.shape)} / "
                         f"cols {tuple(cols.shape)} do not fit x of shape "
                         f"{tuple(x.shape)}")
    if index.n != n or index.k != K:
        raise ValueError(f"spmv_block_ell: the index covers {index.k} PU "
                         f"blocks of {index.n} rows, x {K} of {n}")
    dev = blocks.device
    if (index.vals.dtype != blocks.dtype or index.vals.device != dev
            or index.cols.device != dev or index.ptr.device != dev):
        raise ValueError("spmv_block_ell: the index must hold the blocks' "
                         "dtype on their device")
    return K, S, NNZB, BM, BK, n, nb


def _spmv_sell(blocks: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
               index: BellIndex, multi: bool) -> torch.Tensor:
    """Launch ``spmv_sell`` on the index, any form; the blocks and cols
    serve its dense branch (an Inf or NaN in x).  The product takes a few
    tens of microseconds on the card, so the host work per call is kept
    small: the device is switched only when x is not on the current one,
    and the stream is read as a raw handle (``torch.cuda.current_stream``
    builds a Stream object, 6 us a call on the H100's host)."""
    K, S, NNZB, BM, BK, n, nb = _check_sell(blocks, cols, x, index, multi)
    dev = blocks.device
    if not (blocks.is_contiguous() and cols.is_contiguous()):
        raise ValueError("spmv_block_ell: blocks and cols must be "
                         "contiguous")
    if x.dtype != blocks.dtype or not x.is_contiguous():
        x = x.to(blocks.dtype).contiguous()
    y = torch.empty(x.shape, dtype=blocks.dtype, device=dev)
    flag = torch.empty(1, dtype=torch.int32, device=dev)
    fn_name = _FN_SELL[blocks.dtype]
    fn = _build.launcher("spmv_bell", fn_name)

    def launch() -> int:
        return fn(index.ptr.data_ptr(), index.cols.data_ptr(),
                  index.vals.data_ptr(), blocks.data_ptr(), cols.data_ptr(),
                  x.data_ptr(), y.data_ptr(), flag.data_ptr(), K * n, n, nb,
                  S, NNZB, BM, BK, torch._C._cuda_getCurrentRawStream(
                      dev.index))

    if dev.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(dev):
            err = launch()
    _build.check(err, fn_name)
    _build.count("spmv_bell_multi:sell" if multi else "spmv_bell:sell")
    return y


def nonfinite_pass(x: torch.Tensor) -> torch.Tensor:
    """The sell route's first pass alone, for timing it apart: a device
    int32 flag, 1 where x holds an Inf or NaN.  Not a route of the
    product, so it counts no launch."""
    if x.device.type != "cuda" or x.dtype not in _FN_SELL \
            or not x.is_contiguous():
        raise ValueError("nonfinite_pass takes a contiguous float32 or "
                         "float64 CUDA tensor")
    flag = torch.empty(1, dtype=torch.int32, device=x.device)
    fn = _build.launcher("spmv_bell", "bell_nonfinite")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), x.numel(), int(x.dtype == torch.float64),
                 flag.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "bell_nonfinite")
    return flag
