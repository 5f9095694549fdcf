"""Plain PyTorch versions of the port's kernels.

The wrappers in :mod:`.pdist`, :mod:`.spmv_bell` and :mod:`.flash` take
these for tensors on the CPU; the tests hold them against the JAX package's
Pallas kernels, and ``chip_smoke.py`` holds the CUDA kernels against them
on the card.
"""
from __future__ import annotations

import torch


def pairwise_sqdist_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n, d), (k, d) -> (n, k) float32 ``||x||^2 - 2 x.c + ||c||^2``: the
    three-term form of the TPU kernel, computed in float32 whatever the
    input dtype.  The cross term is an elementwise product and sum, so no
    matrix unit (and no TF32) is involved."""
    x = x.float()
    c = c.float()
    xx = (x * x).sum(1, keepdim=True)
    cc = (c * c).sum(1)[None, :]
    xc = (x[:, None, :] * c[None, :, :]).sum(-1)
    return xx - 2.0 * xc + cc


def spmv_block_ell_ref(blocks: torch.Tensor, cols: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Block-ELL SpMV as a gather plus an einsum, in the blocks' dtype.

    Single form: blocks (S, NNZB, BM, BK), cols (S, NNZB), x (n,) -> (n,).
    Stacked form: a leading PU axis K on all three, x (K, n) -> (K, n).
    x is read as zero past n, as the TPU kernel's zero-padded panels are.
    """
    stacked = blocks.dim() == 5
    if not stacked:
        blocks, cols, x = blocks[None], cols[None], x[None]
    K, S, NNZB, BM, BK = blocks.shape
    n = x.shape[1]
    P = -(-n // BK)
    xp = torch.zeros((K, P * BK), dtype=blocks.dtype, device=x.device)
    xp[:, :n] = x.to(blocks.dtype)
    xp = xp.view(K, P, BK)
    kidx = torch.arange(K, device=x.device)[:, None, None]
    xg = xp[kidx, cols.long()]                       # (K, S, NNZB, BK)
    y = torch.einsum("ksbmt,ksbt->ksbm", blocks, xg).sum(2)
    y = y.reshape(K, S * BM)[:, :n].contiguous()
    return y if stacked else y[0]


def spmv_block_ell_multi_ref(blocks: torch.Tensor, cols: torch.Tensor,
                             x: torch.Tensor) -> torch.Tensor:
    """Block-ELL SpMV of every column of an RHS batch: blocks (S, NNZB,
    BM, BK), cols (S, NNZB), x (n, nb) -> (n, nb), in the blocks' dtype.
    The einsum of :func:`spmv_block_ell_ref` with a column axis: the
    TPU kernel under ``jax.vmap``.  x is read as zero past n."""
    S, NNZB, BM, BK = blocks.shape
    n, nb = x.shape
    P = -(-n // BK)
    xp = torch.zeros((P * BK, nb), dtype=blocks.dtype, device=x.device)
    xp[:n] = x.to(blocks.dtype)
    xg = xp.view(P, BK, nb)[cols.long()]             # (S, NNZB, BK, nb)
    y = torch.einsum("sbmt,sbtj->smj", blocks, xg)
    return y.reshape(S * BM, nb)[:n].contiguous()


def spmv_sell_ref(index, blocks: torch.Tensor, cols: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """The sell route's plain version: y = A @ x as a gather and a sum
    over ``index`` (:func:`.spmv_bell.bell_index` of ``blocks``, ``cols``:
    slices of 32 rows, entry j of a slice's row i at ``ptr + 32 j + i``),
    in the blocks' dtype, in any of the three forms of
    :func:`.spmv_bell.spmv_block_ell`.  An Inf or NaN in x takes the dense
    plain version, so a zero block entry under it gives NaN as the dense
    product does."""
    if not bool(torch.isfinite(x).all()):
        if blocks.dim() == 4 and x.dim() == 2:
            return spmv_block_ell_multi_ref(blocks, cols, x)
        return spmv_block_ell_ref(blocks, cols, x)
    n, rows = index.n, index.k * index.n
    dev = index.vals.device
    xf = x.to(index.vals.dtype).reshape(rows, -1)
    ptr = index.ptr.long()
    width = (ptr[1:] - ptr[:-1]) // 32
    sl = torch.repeat_interleave(torch.arange(len(width), device=dev),
                                 width * 32)
    off = torch.arange(len(sl), device=dev) - ptr[sl]
    row = sl * 32 + off % 32
    live = index.cols >= 0
    row = row[live]
    col = index.cols[live].long() + row // n * n
    y = torch.zeros((rows, xf.shape[1]), dtype=xf.dtype, device=dev)
    y.index_add_(0, row, index.vals[live, None] * xf[col])
    return y.reshape(x.shape)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """Plain softmax attention, the oracle of the flash kernel.

    q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) with Hkv dividing H, query head
    h reading kv head ``h // (H // Hkv)``.  Scores, softmax and the PV
    product are float32 and the output is in q's dtype.  The causal mask
    keeps key j for query i when ``j <= i + Sk - Sq``, as
    ``src/repro/kernels/ref.py::flash_attention_ref`` does; that oracle
    forms the scores in the input dtype before its f32 cast, this one (like
    both kernels) from f32 products.
    """
    H, Hkv = q.shape[1], k.shape[1]
    if Hkv != H:
        head = torch.arange(H, device=k.device) // (H // Hkv)
        k, v = k[:, head], v[:, head]
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits.masked_fill_(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
