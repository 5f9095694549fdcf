"""Block-ELL SpMV: host converters and the CUDA kernel's wrapper.

Block-ELL groups rows into stripes of BM rows and columns into panels of BK
columns; each stripe stores exactly NNZB dense (BM, BK) blocks plus their
panel indices:

    y[stripe] = sum_b  blocks[stripe, b] @ x[cols[stripe, b]]

The converters are host NumPy, copied from
``src/repro/kernels/spmv_bell.py`` and bit-equal to it.
``spmv_block_ell`` launches the hand-written CUDA kernel
``csrc/spmv_bell.cu`` for tensors on the card; it replaces the Pallas TPU
kernel ``src/repro/kernels/spmv_bell.py::_spmv_block_ell``.  The kernel
streams the block array once and is bound by its bytes; the design note is
in the source.  Tensors on the CPU go to the plain version
(:func:`.ref.spmv_block_ell_ref`).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .ref import spmv_block_ell_ref

_FN = {torch.float32: "spmv_bell_f32", torch.float64: "spmv_bell_f64"}
MAX_BM = 32                       # one warp per stripe row, <= 1024 threads


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
# Kernel wrapper
# --------------------------------------------------------------------------

def spmv_block_ell(blocks: torch.Tensor, cols: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in block-ELL, in the blocks' dtype (float32 or
    float64); x is cast to it, as the TPU kernel does.

    Single form: blocks (S, NNZB, BM, BK), cols (S, NNZB) int32, x (n,)
    -> (n,).  Stacked form (one launch for every PU block of a distributed
    plan): blocks (K, S, NNZB, BM, BK), cols (K, S, NNZB), x (K, n)
    -> (K, n).  S must be ceil(n / BM)."""
    if blocks.device.type == "cpu" and cols.device.type == "cpu" \
            and x.device.type == "cpu":
        return spmv_block_ell_ref(blocks, cols, x)
    dev = blocks.device
    if dev.type != "cuda" or cols.device != dev or x.device != dev:
        raise ValueError(f"spmv_block_ell: blocks, cols and x must lie on "
                         f"one CUDA device (got {blocks.device}, "
                         f"{cols.device}, {x.device})")
    stacked = blocks.dim() == 5
    if not stacked:
        if blocks.dim() != 4:
            raise ValueError(f"spmv_block_ell: blocks of shape "
                             f"{tuple(blocks.shape)} is neither (S, NNZB, "
                             f"BM, BK) nor (K, S, NNZB, BM, BK)")
        blocks, cols, x = blocks[None], cols[None], x[None]
    K, S, NNZB, BM, BK = blocks.shape
    if blocks.dtype not in _FN:
        raise TypeError(f"spmv_block_ell takes float32 or float64 blocks, "
                        f"got {blocks.dtype}")
    if cols.dtype != torch.int32:
        raise TypeError(f"spmv_block_ell: cols must be int32, got "
                        f"{cols.dtype}")
    if x.dim() != 2 or x.shape[0] != K:
        raise ValueError(f"spmv_block_ell: x of shape {tuple(x.shape)} "
                         f"does not match {K} PU blocks")
    n = x.shape[1]
    if tuple(cols.shape) != (K, S, NNZB) or S != -(-n // BM):
        raise ValueError(f"spmv_block_ell: cols {tuple(cols.shape)} / "
                         f"blocks {tuple(blocks.shape)} do not fit x of "
                         f"length {n}")
    if not 1 <= BM <= MAX_BM:
        raise ValueError(f"spmv_block_ell: BM={BM} outside 1..{MAX_BM}")
    x = x.to(blocks.dtype).contiguous()
    if not (blocks.is_contiguous() and cols.is_contiguous()):
        raise ValueError("spmv_block_ell: blocks and cols must be "
                         "contiguous")
    y = torch.empty((K, n), dtype=blocks.dtype, device=dev)
    fn_name = _FN[blocks.dtype]
    fn = _build.launcher("spmv_bell", fn_name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(blocks.data_ptr(), cols.data_ptr(), x.data_ptr(),
                 y.data_ptr(), K, S, NNZB, BM, BK, n, stream)
    _build.check(err, fn_name)
    _build.count("spmv_bell")
    return y if stacked else y[0]
