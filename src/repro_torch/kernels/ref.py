"""Plain PyTorch versions of the port's kernels.

The wrappers in :mod:`.pdist` and :mod:`.spmv_bell` take these for tensors
on the CPU; the tests hold them against the JAX package's Pallas kernels,
and ``chip_smoke.py`` holds the CUDA kernels against them on the card.
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
