"""Graph generators mirroring the paper's instances (Table II) — host NumPy,
copied from ``src/repro/sparse/generators.py`` and bit-equal to it.

  * rgg_2d / rgg_3d — random geometric graphs (KaGen-style): n points uniform
    in the unit square/cube, edge iff dist <= r, r chosen for avg degree ~6.
  * rdg_2d — random Delaunay triangulation graphs.
  * grid_2d / grid_3d — structured meshes (stand-in for the DIMACS hugeX
    triangle meshes, same family: planar, bounded degree).
  * aniso_grid — grid with direction-dependent edge weights (anisotropic
    diffusion; the block-Jacobi preconditioner's model problem).
  * refined_mesh — adaptively refined triangular mesh (refinetrace family):
    start from a coarse Delaunay mesh and refine cells near an attractor
    curve, giving strongly non-uniform density.

All generators are deterministic given seed and return Graph with coords.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay, cKDTree

from .graph import Graph, from_edges


def rgg(n: int, dim: int = 2, avg_degree: float = 6.0,
        seed: int = 0) -> Graph:
    """Random geometric graph in [0,1]^dim with expected avg degree."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, dim)).astype(np.float32)
    # avg_degree = n * V_d(r)  =>  r = (avg_degree / (n c_d))^(1/d)
    c_d = {1: 2.0, 2: np.pi, 3: 4.0 * np.pi / 3.0}[dim]
    r = (avg_degree / (n * c_d)) ** (1.0 / dim)
    tree = cKDTree(pts)
    pairs = tree.query_pairs(r, output_type="ndarray")
    if len(pairs) == 0:
        pairs = np.zeros((0, 2), dtype=np.int64)
    return from_edges(n, pairs[:, 0], pairs[:, 1], symmetrize=True,
                      coords=pts)


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


def aniso_grid(shape: tuple[int, ...], weights: tuple[float, ...] = None,
               eps: float = 0.01) -> Graph:
    """Structured grid with direction-dependent edge weights — the
    anisotropic-diffusion model problem.  ``weights[d]`` is the coupling
    along axis d (default ``(1, eps, eps, ...)``: strong along axis 0).
    Its shifted Laplacian is the classic case where point-Jacobi stalls
    but per-block preconditioners that keep whole strong lines inside a
    block (e.g. axis-0 stripes + block-Jacobi) stay effective.
    """
    dims = len(shape)
    if weights is None:
        weights = (1.0,) + (eps,) * (dims - 1)
    n = int(np.prod(shape))
    idx = np.arange(n).reshape(shape)
    src, dst, w = [], [], []
    for axis in range(dims):
        a = np.take(idx, np.arange(shape[axis] - 1), axis=axis).ravel()
        b = np.take(idx, np.arange(1, shape[axis]), axis=axis).ravel()
        src.append(a)
        dst.append(b)
        w.append(np.full(len(a), weights[axis], dtype=np.float32))
    src, dst, w = (np.concatenate(src), np.concatenate(dst),
                   np.concatenate(w))
    coords = np.stack(np.unravel_index(np.arange(n), shape),
                      axis=1).astype(np.float32)
    coords /= np.maximum(1, np.array(shape, dtype=np.float32) - 1)
    return from_edges(n, src, dst, w, symmetrize=True, coords=coords)


def refined_mesh(n_coarse: int = 2000, refine_rounds: int = 3,
                 seed: int = 0) -> Graph:
    """Adaptive mesh a la 'refinetrace': density concentrates near a moving
    front (a circle arc), produced by iterative point insertion + re-Delaunay.
    """
    rng = np.random.default_rng(seed)
    pts = rng.random((n_coarse, 2))
    center = np.array([0.5, 0.5])
    for _ in range(refine_rounds):
        d = np.abs(np.linalg.norm(pts - center, axis=1) - 0.3)
        hot = pts[d < 0.08]
        if len(hot) == 0:
            break
        jitter = rng.normal(scale=0.01, size=(len(hot), 2))
        pts = np.concatenate([pts, np.clip(hot + jitter, 0, 1)])
    pts = np.unique(np.round(pts, 7), axis=0)
    tri = Delaunay(pts)
    edges = _tri_edges(tri.simplices)
    return from_edges(len(pts), edges[:, 0], edges[:, 1], symmetrize=True,
                      coords=pts.astype(np.float32))


GENERATORS = {
    "rgg_2d": lambda n, seed=0: rgg(n, 2, seed=seed),
    "rgg_3d": lambda n, seed=0: rgg(n, 3, seed=seed),
    "rdg_2d": lambda n, seed=0: rdg(n, seed=seed),
    "grid_2d": lambda n, seed=0: grid((int(np.sqrt(n)),) * 2),
    "grid_3d": lambda n, seed=0: grid((max(2, round(n ** (1 / 3))),) * 3),
    "refined": lambda n, seed=0: refined_mesh(n, seed=seed),
}
