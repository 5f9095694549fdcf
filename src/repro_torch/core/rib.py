"""Recursive Inertial Bisection with heterogeneous target weights
(zRIB analogue, Sec. III-a).

Like RCB but splits along the principal inertial axis of the current point
set (not restricted to coordinate axes).

Host NumPy, copied from ``src/repro/core/rib.py`` and bit-equal to it.
"""
from __future__ import annotations

import numpy as np

from ..sparse.graph import Graph
from .geometry import principal_axis
from .rcb import _split_blocks


def partition_rib(g: Graph, tw: np.ndarray, seed: int = 0) -> np.ndarray:
    assert g.coords is not None, "RIB needs coordinates"
    tw = np.asarray(tw, dtype=np.float64)
    part = np.zeros(g.n, dtype=np.int32)
    _rib(g.coords.astype(np.float64), np.arange(g.n),
         np.arange(len(tw)), tw, part)
    return part


def _rib(coords: np.ndarray, ids: np.ndarray, block_ids: np.ndarray,
         tw: np.ndarray, part: np.ndarray) -> None:
    if len(block_ids) == 1:
        part[ids] = block_ids[0]
        return
    left_b, right_b, frac = _split_blocks(block_ids, tw)
    pts = coords[ids]
    axis = principal_axis(pts)
    proj = pts @ axis
    order = np.argsort(proj, kind="stable")
    n_left = int(round(frac * len(ids)))
    n_left = min(max(n_left, 0), len(ids))
    _rib(coords, ids[order[:n_left]], left_b, tw, part)
    _rib(coords, ids[order[n_left:]], right_b, tw, part)
