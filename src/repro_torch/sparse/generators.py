"""Graph generators for the port's slice (host NumPy, copied from
``src/repro/sparse/generators.py``; bit-equal to it).

  * rdg  — random Delaunay triangulation graphs (Table II's rdg_2d);
  * grid — structured 2-D / 3-D meshes (4/6-point stencil).

Both are deterministic given their arguments and return a Graph with
coordinates.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay

from .graph import Graph, from_edges


def rdg(n: int, seed: int = 0) -> Graph:
    """Random Delaunay graph: Delaunay triangulation of uniform points."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2)).astype(np.float64)
    tri = Delaunay(pts)
    edges = _tri_edges(tri.simplices)
    return from_edges(n, edges[:, 0], edges[:, 1], symmetrize=True,
                      coords=pts.astype(np.float32))


def _tri_edges(simplices: np.ndarray) -> np.ndarray:
    e = np.concatenate([simplices[:, [0, 1]], simplices[:, [1, 2]],
                        simplices[:, [0, 2]]])
    e.sort(axis=1)
    return np.unique(e, axis=0)


def grid(shape: tuple[int, ...]) -> Graph:
    """Structured grid mesh (2D or 3D), 4/6-point stencil."""
    dims = len(shape)
    n = int(np.prod(shape))
    idx = np.arange(n).reshape(shape)
    src, dst = [], []
    for axis in range(dims):
        a = np.take(idx, np.arange(shape[axis] - 1), axis=axis).ravel()
        b = np.take(idx, np.arange(1, shape[axis]), axis=axis).ravel()
        src.append(a)
        dst.append(b)
    src, dst = np.concatenate(src), np.concatenate(dst)
    coords = np.stack(np.unravel_index(np.arange(n), shape),
                      axis=1).astype(np.float32)
    coords /= np.maximum(1, np.array(shape, dtype=np.float32) - 1)
    return from_edges(n, src, dst, symmetrize=True, coords=coords)
