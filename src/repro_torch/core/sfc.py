"""Space-filling-curve partitioner (zSFC analogue, Sec. III-a).

Sort vertices by Morton code, then slice the order at the cumulative target
weights from Algorithm 1.  O(n log n), embarrassingly parallel, lowest
quality of the geometric family — exactly the paper's baseline role.

The port of ``src/repro/core/sfc.py``: the codes are computed on
``device`` (the same integers as the reference's), the stable sort and the
split are host NumPy, so the partition is bit-equal.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..sparse.graph import Graph
from .geometry import morton_codes, weighted_split_assignment


def partition_sfc(g: Graph, tw: np.ndarray, seed: int = 0,
                  device=None) -> np.ndarray:
    if g.coords is None:
        raise ValueError("SFC needs coordinates")
    device = resolve_device(device)
    codes = morton_codes(torch.from_numpy(
        np.ascontiguousarray(g.coords)).to(device)).cpu().numpy()
    order = np.argsort(codes, kind="stable")
    return weighted_split_assignment(order, np.asarray(tw))
