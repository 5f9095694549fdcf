"""Pairwise squared distances, the hot loop of balanced k-means (geoKM).

``pairwise_sqdist`` launches the hand-written CUDA kernel
``csrc/pdist.cu`` for tensors on the card.  It replaces the Pallas TPU
kernel ``src/repro/kernels/pdist.py::pairwise_sqdist_pallas``.  The kernel
is bound by the bytes of its (n, k) float32 output; the design note is in
the source.  Tensors on the CPU go to the plain version
(:func:`.ref.pairwise_sqdist_ref`).
"""
from __future__ import annotations

import torch

from . import _build
from .ref import pairwise_sqdist_ref

MAX_DIM = 8
_FN = {torch.float32: "pdist_f32", torch.bfloat16: "pdist_bf16"}


def pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n, d) x (k, d) -> (n, k) float32 squared distances,
    ``||x||^2 - 2 x.c + ||c||^2``.  x and c are float32 or bfloat16 of one
    dtype, with d <= 8."""
    if x.device.type == "cpu" and c.device.type == "cpu":
        return pairwise_sqdist_ref(x, c)
    if x.device.type != "cuda" or c.device != x.device:
        raise ValueError(f"pairwise_sqdist: x and c must lie on one CUDA "
                         f"device (got {x.device} and {c.device})")
    if x.dtype not in _FN or c.dtype != x.dtype:
        raise TypeError(f"pairwise_sqdist takes float32 or bfloat16 of one "
                        f"dtype, got {x.dtype} and {c.dtype}")
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"pairwise_sqdist: shapes {tuple(x.shape)} and "
                         f"{tuple(c.shape)} are not (n, d) and (k, d)")
    n, d = x.shape
    k = c.shape[0]
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"pairwise_sqdist: d={d} outside 1..{MAX_DIM}")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("pairwise_sqdist: x and c must be contiguous")
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    fn_name = _FN[x.dtype]
    fn = _build.launcher("pdist", fn_name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), c.data_ptr(), out.data_ptr(), n, k, d,
                 stream)
    _build.check(err, fn_name)
    _build.count("pdist")
    return out
