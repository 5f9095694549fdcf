"""Geometric utilities shared by the partitioners.

  * morton_codes — 2D/3D Morton (Z-order) codes for k-means seeding, the
    tensor form of ``src/repro/core/geometry.py::morton_codes``.  The
    reference interleaves in uint32; torch's uint32 support is thin, so the
    port works in int64 and masks every step to the same 32 bits.  The
    codes are equal integers.
  * weighted_split_assignment — cut a visiting order at cumulative target
    weights (host NumPy, copied and bit-equal);
  * principal_axis — the inertial axis RIB splits along (host NumPy,
    copied and bit-equal: float64 power iteration).
"""
from __future__ import annotations

import numpy as np
import torch

_MORTON_BITS = 10  # per dim; 2*10=20 / 3*10=30 bit codes fit in 32 bits


def _part1by1(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits of x so there is a 0 between each (2D interleave)."""
    x = x & 0x3FF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits of x with 2 zeros between each (3D interleave)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(coords: torch.Tensor) -> torch.Tensor:
    """int64 Z-order codes for (n, 2) or (n, 3) points (any float dtype),
    quantized to 10 bits per dimension over the points' bounding box."""
    lo = coords.min(dim=0).values
    hi = coords.max(dim=0).values
    span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    q = ((coords - lo) / span * (2 ** _MORTON_BITS - 1)).to(torch.int64)
    q = q.clamp(0, 2 ** _MORTON_BITS - 1)
    if coords.shape[1] == 2:
        return _part1by1(q[:, 0]) | (_part1by1(q[:, 1]) << 1)
    if coords.shape[1] == 3:
        return (_part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1)
                | (_part1by2(q[:, 2]) << 2))
    raise ValueError(f"dim must be 2 or 3, got {coords.shape[1]}")


def weighted_split_assignment(order: np.ndarray,
                              tw: np.ndarray) -> np.ndarray:
    """Assign vertices, visited in `order`, to blocks with target sizes tw.

    Returns part (n,) int32: the first ~tw[0] vertices of the order go to
    block 0, next ~tw[1] to block 1, ... (fractional boundaries rounded so
    each prefix matches cumsum(tw)).
    """
    n = len(order)
    bounds = np.round(np.cumsum(tw)).astype(np.int64)
    bounds[-1] = n
    part = np.zeros(n, dtype=np.int32)
    ranks = np.empty(n, dtype=np.int64)
    ranks[order] = np.arange(n)
    part = np.searchsorted(bounds, ranks, side="right").astype(np.int32)
    return np.minimum(part, len(tw) - 1)


def principal_axis(coords: np.ndarray, iters: int = 50) -> np.ndarray:
    """Principal inertial axis via power iteration on the covariance."""
    c = coords - coords.mean(axis=0, keepdims=True)
    cov = c.T @ c
    v = np.ones(cov.shape[0]) / np.sqrt(cov.shape[0])
    for _ in range(iters):
        v = cov @ v
        nv = np.linalg.norm(v)
        if nv == 0:
            return np.eye(cov.shape[0])[0]
        v /= nv
    return v
