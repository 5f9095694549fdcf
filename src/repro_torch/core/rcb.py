"""Recursive Coordinate Bisection with heterogeneous target weights
(zRCB analogue, Sec. III-a).

Each recursion step splits the current vertex set orthogonally to its longest
extent, at the point where the left part receives ``sum(tw_left)`` vertices.
The block set is split to keep the two weight sums as close as possible to
the geometric split (classic RCB uses halves; we use the heterogeneous target
weights from Algorithm 1).

Host NumPy, copied from ``src/repro/core/rcb.py`` and bit-equal to it.
"""
from __future__ import annotations

import numpy as np

from ..sparse.graph import Graph


def partition_rcb(g: Graph, tw: np.ndarray, seed: int = 0) -> np.ndarray:
    assert g.coords is not None, "RCB needs coordinates"
    tw = np.asarray(tw, dtype=np.float64)
    part = np.zeros(g.n, dtype=np.int32)
    _rcb(g.coords, np.arange(g.n), np.arange(len(tw)), tw, part)
    return part


def _split_blocks(block_ids: np.ndarray, tw: np.ndarray):
    """Split blocks into two groups with near-equal total target weight.

    Greedy: sort by weight desc, assign each block to the lighter group.
    Returns (left_ids, right_ids, left_weight_fraction).
    """
    if len(block_ids) == 1:
        raise ValueError("cannot split a single block")
    order = np.argsort(-tw[block_ids], kind="stable")
    left, right = [], []
    wl = wr = 0.0
    for b in block_ids[order]:
        if wl <= wr:
            left.append(b)
            wl += tw[b]
        else:
            right.append(b)
            wr += tw[b]
    frac = wl / (wl + wr)
    return np.array(left), np.array(right), frac


def _rcb(coords: np.ndarray, ids: np.ndarray, block_ids: np.ndarray,
         tw: np.ndarray, part: np.ndarray) -> None:
    if len(block_ids) == 1:
        part[ids] = block_ids[0]
        return
    left_b, right_b, frac = _split_blocks(block_ids, tw)
    pts = coords[ids]
    extent = pts.max(axis=0) - pts.min(axis=0)
    axis = int(np.argmax(extent))
    order = np.argsort(pts[:, axis], kind="stable")
    n_left = int(round(frac * len(ids)))
    # both sides hold blocks, so neither may receive an empty vertex set:
    # an extreme weight skew (frac ~ 0 or ~ 1) used to round to 0 or
    # len(ids) and emit empty blocks downstream
    lo = 1 if len(ids) >= 2 else 0
    n_left = min(max(n_left, lo), len(ids) - lo)
    _rcb(coords, ids[order[:n_left]], left_b, tw, part)
    _rcb(coords, ids[order[n_left:]], right_b, tw, part)
