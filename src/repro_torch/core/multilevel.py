"""Multilevel Geographer-R (Sec. V): partition-first multilevel refinement —
host NumPy, copied from ``src/repro/core/multilevel.py`` and bit-equal to it.

Contrary to the classic multilevel approach, the partition is obtained
*before* coarsening (via balanced k-means).  Each block then coarsens its
local subgraph with heavy-edge matching — matching never crosses block
boundaries, so the partition projects exactly onto every level.  During
uncoarsening, the scheduled pairwise-FM refinement of ``refinement.py`` runs
at each level (cheap at coarse levels, touching only boundaries at fine
ones).  The matching visits vertices in ``default_rng(seed + level)``
order, and ``contract`` accumulates coordinates in float64, as the
reference does.
"""
from __future__ import annotations

import numpy as np

from ..sparse.graph import Graph, from_edges
from .refinement import refine_partition


def heavy_edge_matching(g: Graph, part: np.ndarray,
                        seed: int = 0) -> np.ndarray:
    """Greedy heavy-edge matching restricted to intra-block edges.

    Returns match (n,) — match[v] = u if {u, v} matched, else v.
    Visits vertices in random order; each picks its heaviest unmatched
    same-block neighbor (Metis-style HEM).
    """
    rng = np.random.default_rng(seed)
    match = np.arange(g.n)
    matched = np.zeros(g.n, dtype=bool)
    for v in rng.permutation(g.n):
        if matched[v]:
            continue
        row = slice(g.indptr[v], g.indptr[v + 1])
        nb, wv = g.indices[row], g.weights[row]
        ok = (~matched[nb]) & (part[nb] == part[v]) & (nb != v)
        if not ok.any():
            continue
        u = nb[ok][np.argmax(wv[ok])]
        match[v], match[u] = u, v
        matched[v] = matched[u] = True
    return match


def contract(g: Graph, part: np.ndarray, match: np.ndarray):
    """Contract matched pairs.  Returns (coarse_graph, coarse_part, fine2coarse).

    Vertex weights are carried in ``coarse_vw`` so balance stays exact.
    """
    rep = np.minimum(np.arange(g.n), match)       # canonical endpoint
    uniq, fine2coarse = np.unique(rep, return_inverse=True)
    nc = len(uniq)
    src, dst, w = g.edge_list()
    cs, cd = fine2coarse[src], fine2coarse[dst]
    keep = cs != cd
    coords = None
    if g.coords is not None:
        coords = np.zeros((nc, g.coords.shape[1]), dtype=np.float64)
        np.add.at(coords, fine2coarse, g.coords.astype(np.float64))
        cnt = np.bincount(fine2coarse, minlength=nc)
        coords = (coords / cnt[:, None]).astype(np.float32)
    cg = from_edges(nc, cs[keep], cd[keep], w[keep], coords=coords)
    cvw = np.bincount(fine2coarse, minlength=nc)  # vertices per supernode
    return cg, part[uniq].copy(), fine2coarse, cvw


def partition_multilevel_refine(g: Graph, part0: np.ndarray, tw: np.ndarray,
                                mems: np.ndarray | None = None,
                                eps: float = 0.03, max_levels: int = 4,
                                coarsest: int = 4096, passes: int = 2,
                                seed: int = 0, verbose: bool = False
                                ) -> np.ndarray:
    """Geographer-R refinement given an initial partition (e.g. geoKM).

    On coarse levels supernodes have weight > 1; the per-level supernode
    weights (``contract``'s ``cvw``) are threaded into the pairwise FM's
    size/cap accounting, so the heterogeneous caps (Eq. 3) hold in true
    vertex units at every level — a heavy supernode cannot slip into a
    block whose *mean*-scaled cap would have admitted it.  Boundary-exact
    refinement happens at the finest level (unit weights there).
    """
    graphs = [g]
    parts = [np.asarray(part0, dtype=np.int32).copy()]
    maps: list[np.ndarray] = []
    vws = [np.ones(g.n, dtype=np.int64)]
    for lvl in range(max_levels):
        cur, cpart = graphs[-1], parts[-1]
        if cur.n <= coarsest:
            break
        match = heavy_edge_matching(cur, cpart, seed=seed + lvl)
        cg, cp, f2c, _cvw = contract(cur, cpart, match)
        if cg.n >= cur.n * 0.95:      # matching stalled
            break
        graphs.append(cg)
        parts.append(cp)
        maps.append(f2c)
        # cumulative weight in *finest*-vertex units (not the previous
        # level's supernode count): caps stay comparable across levels
        vws.append(np.bincount(f2c, weights=vws[-1],
                               minlength=cg.n).astype(np.int64))
        if verbose:
            print(f"  level {lvl + 1}: {cg.n} vertices")

    # refine coarsest -> finest: targets/caps stay in true vertex units,
    # the per-level supernode weights carry the size accounting
    for lvl in range(len(graphs) - 1, -1, -1):
        parts[lvl] = refine_partition(graphs[lvl], parts[lvl], tw,
                                      mems=mems, eps=eps, passes=passes,
                                      vw=None if lvl == 0 else vws[lvl],
                                      verbose=verbose)
        if lvl > 0:
            parts[lvl - 1] = parts[lvl][maps[lvl - 1]]
    return parts[0]
