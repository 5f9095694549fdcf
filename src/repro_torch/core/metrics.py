"""Partition quality metrics (Sec. II-A / VI-a), host NumPy copied from
``src/repro/core/metrics.py`` and bit-equal to it: the subset the port uses
to report partition quality.

  * edge cut    — weight of edges with endpoints in different blocks
  * comm volume — per block b: # of vertices outside b adjacent to b
                  (data words b must receive); max over blocks is the
                  paper's maxCommVolume
  * imbalance   — max_i tw_actual(b_i)/tw_target(b_i)
"""
from __future__ import annotations

import numpy as np

from ..sparse.graph import Graph


def edge_cut(g: Graph, part: np.ndarray) -> float:
    src, dst, w = g.edge_list()
    cut2 = np.sum(w * (part[src] != part[dst]))   # both directions counted
    return float(cut2) / 2.0

# The linearized-pair dedup key is ``recv * n + vert`` in int64: it wraps
# (silently, into negative keys that unique/sort still accept) once
# ``k * n`` approaches 2**63.  Above this threshold the dedup switches to
# a lexsort over the two columns — bit-identical output (same pairs, same
# (recv, vert) order), no products formed.
_PAIR_DEDUP_MAX = 2 ** 62


def _dedup_recv_pairs(recv: np.ndarray, vert: np.ndarray, n: int,
                      k: int) -> tuple[np.ndarray, np.ndarray]:
    """Distinct (receiving block, remote vertex) pairs, sorted by
    (recv, vert).  Returns ``(blocks, verts)`` int64 arrays."""
    recv = np.asarray(recv, dtype=np.int64)
    vert = np.asarray(vert, dtype=np.int64)
    if int(max(k, 1)) * int(n) <= _PAIR_DEDUP_MAX:   # Python ints: no wrap
        pairs = np.unique(recv * n + vert)
        return pairs // n, pairs % n
    if len(recv) == 0:
        return recv, vert
    order = np.lexsort((vert, recv))
    r_s, v_s = recv[order], vert[order]
    keep = np.ones(len(r_s), dtype=bool)
    keep[1:] = (r_s[1:] != r_s[:-1]) | (v_s[1:] != v_s[:-1])
    return r_s[keep], v_s[keep]


def comm_volumes(g: Graph, part: np.ndarray, k: int) -> np.ndarray:
    """Received-words per block: for block b, the number of distinct remote
    vertices adjacent to b (the halo size — exactly what distributed SpMV
    must fetch)."""
    src, dst, _ = g.edge_list()
    pb, pv = part[src], part[dst]
    ext = pb != pv
    # distinct (receiving block, remote vertex) pairs
    blocks, _ = _dedup_recv_pairs(pb[ext], dst[ext], g.n, k)
    return np.bincount(blocks, minlength=k)


def max_comm_volume(g: Graph, part: np.ndarray, k: int) -> int:
    return int(comm_volumes(g, part, k).max(initial=0))


def block_sizes_of(part: np.ndarray, k: int) -> np.ndarray:
    return np.bincount(part, minlength=k)


def imbalance(part: np.ndarray, tw: np.ndarray) -> float:
    """max_i actual/target over blocks with a positive target — 1.0 is
    perfectly on-target.

    Blocks with ``tw == 0`` (fully saturated topologies hand some PUs a
    zero target) are correct exactly when they stay empty: an empty
    zero-target block is ignored rather than polluting the ratio, and a
    *populated* zero-target block returns ``inf`` (any load on it is a
    violation, not a ratio)."""
    tw = np.asarray(tw, dtype=np.float64)
    sizes = block_sizes_of(part, len(tw))
    pos = tw > 0
    if np.any(sizes[~pos] > 0):
        return float("inf")
    if not pos.any():
        return 1.0
    return float((sizes[pos] / tw[pos]).max())
