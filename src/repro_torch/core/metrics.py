"""Partition quality metrics (Sec. II-A / VI-a), host NumPy copied from
``src/repro/core/metrics.py`` and bit-equal to it: the subset the port uses
to report partition quality.

  * edge cut    — weight of edges with endpoints in different blocks
  * comm volume — per block b: # of vertices outside b adjacent to b
                  (data words b must receive); max over blocks is the
                  paper's maxCommVolume
  * imbalance   — max_i tw_actual(b_i)/tw_target(b_i)

Hierarchical splits: given an (h-1, k) ancestor table of the blocks
(``topology.normalize_tree_of``), cut and comm volume split exactly into
per-tree-level components — every cut edge / received word crosses a block
pair with exactly one LCA level.  The two-level (pod) splits are the
``h == 2`` instance.

Cost-model metrics (what ``costmodel`` and ``replan_policy`` price a
partition with): the weighted tree objective ``sum_level lam[level] *
cut[level]`` and the per-PU bottleneck (makespan) split, with per-level
weights from the shared default link costs (``resolve_lams``).
"""
from __future__ import annotations

import numpy as np

from ..sparse.graph import Graph
from .topology import LinkCosts, level_matrix


def _default_link_costs() -> LinkCosts:
    """THE default cost model for every metric that takes an optional
    ``lam``/``lams``: one resolution point, so the objective, the FM
    gains, and ``summarize_hier``/``summarize_tree`` can never disagree
    about what an unspecified lambda means.  Topology-calibrated models
    come in through the ``lam``/``lams`` arguments
    (``Topology.link_costs()``)."""
    return LinkCosts()


def resolve_lams(lams, h: int):
    """(h,) per-level objective weights; defaults extend the one default
    cost model geometrically to depth h (``link_costs`` ladder)."""
    if lams is None:
        base = _default_link_costs()
        ratio = base.lam
        return tuple(base.lams[l] if l < base.levels else
                     float(ratio ** l) for l in range(h))
    lams = tuple(float(x) for x in np.atleast_1d(np.asarray(lams)))
    if len(lams) != h:
        raise ValueError(f"need {h} per-level weights, got {len(lams)}")
    return lams


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


# -- hierarchical (tree-aware) splits --------------------------------------

def tree_cut_split(g: Graph, part: np.ndarray,
                   anc: np.ndarray) -> np.ndarray:
    """Edge cut split by LCA level: (h,) array with
    ``tree_cut_split(...).sum() == edge_cut`` exactly — every cut edge
    connects two distinct blocks with exactly one tree-distance level
    (``topology.level_matrix``).  ``anc`` is the (h-1, k) ancestor table
    (a (k,) pod array is the two-level instance)."""
    anc = np.atleast_2d(np.asarray(anc))
    h = anc.shape[0] + 1
    lev = level_matrix(anc)
    src, dst, w = g.edge_list()
    pa, pb = part[src], part[dst]
    lev_uv = lev[pa, pb]                        # -1 for same-block pairs
    # both directions counted in each sum, halved per level
    return np.array([float(np.sum(w * (lev_uv == l))) / 2.0
                     for l in range(h)])


def tree_comm_volumes(g: Graph, part: np.ndarray, k: int,
                      anc: np.ndarray) -> np.ndarray:
    """Received-words per block split by the owner's LCA level: (h, k)
    array with column sums over levels == :func:`comm_volumes` exactly —
    each distinct (receiver, remote vertex) pair has one owning block,
    hence one level.  Row ``l`` sums to the word count the tree schedule
    moves over the level-``l`` links; ``row.max()`` is the per-level
    bottleneck volume (the Langguth/Schlag/Schulz objective)."""
    anc = np.atleast_2d(np.asarray(anc))
    h = anc.shape[0] + 1
    lev = level_matrix(anc)
    src, dst, _ = g.edge_list()
    pb, pv = part[src], part[dst]
    ext = pb != pv
    blocks, verts = _dedup_recv_pairs(pb[ext], dst[ext], g.n, k)
    owners = part[verts]
    lev_pair = lev[blocks, owners]
    return np.stack([np.bincount(blocks[lev_pair == l], minlength=k)
                     for l in range(h)])


def tree_objective(g: Graph, part: np.ndarray, anc: np.ndarray,
                   lams=None) -> float:
    """The weighted tree cut ``sum_level lam[level] * cut[level]`` — what
    the tree-aware FM gains (``refinement.fm_pair_refine(anc=...)``)
    minimize.  ``lams`` defaults to the shared cost model
    (:func:`_default_link_costs`) extended to the table's depth; at
    ``h == 2`` this is bit-identical to :func:`two_level_objective`."""
    anc = np.atleast_2d(np.asarray(anc))
    lams = resolve_lams(lams, anc.shape[0] + 1)
    cuts = tree_cut_split(g, part, anc)
    obj = 0.0
    for lam_l, cut_l in zip(lams, cuts):
        obj += lam_l * cut_l
    return float(obj)



def per_pu_model_costs(g: Graph, part: np.ndarray, anc: np.ndarray,
                       lams=None, speeds: np.ndarray | None = None,
                       c_comp: float = 1.0,
                       vw: np.ndarray | None = None) -> dict:
    """Per-PU modeled cost split of the bottleneck (makespan) objective:

      compute[i] = c_comp * w(b_i) / speed_i        (Algorithm-1 speeds)
      comm[i]    = sum_l lams[l] * vols[l, i]       (deduplicated receive
                                                     volume per tree level)

    ``anc`` is the (h-1, k) ancestor table (a (0, k) table is the flat
    single-level machine; a (k,) pod array is the two-level instance);
    ``k`` is taken from its column count.  ``speeds`` defaults to a
    homogeneous machine; ``c_comp`` converts one weight unit of modeled
    compute into the cost of one innermost-level halo word (``lams[0]``
    units), the knob a measured machine model will calibrate.  ``vw``
    supplies per-vertex weights (coarse-level supernodes).

    Returns ``{"compute": (k,), "comm": (k,), "comm_by_level": (h, k),
    "total": (k,)}`` — ``total.max()`` is :func:`bottleneck_objective`,
    ``total.argmax()`` the critical PU.
    """
    anc = np.atleast_2d(np.asarray(anc))
    h, k = anc.shape[0] + 1, anc.shape[1]
    lams = np.asarray(resolve_lams(lams, h), dtype=np.float64)
    if vw is None:
        sizes = block_sizes_of(part, k).astype(np.float64)
    else:
        sizes = np.bincount(part, weights=np.asarray(vw, np.float64),
                            minlength=k)
    speeds = (np.ones(k) if speeds is None
              else np.asarray(speeds, dtype=np.float64))
    vols = tree_comm_volumes(g, part, k, anc)
    compute = float(c_comp) * sizes / speeds
    comm = lams @ vols
    return {"compute": compute, "comm": comm, "comm_by_level": vols,
            "total": compute + comm}



def bottleneck_objective(g: Graph, part: np.ndarray, anc: np.ndarray,
                         lams=None, speeds: np.ndarray | None = None,
                         c_comp: float = 1.0,
                         vw: np.ndarray | None = None) -> float:
    """The process-mapping bottleneck (makespan) objective
    (Langguth/Schlag/Schulz): the *maximum* over PUs of modeled compute
    plus per-level weighted deduplicated receive volume,

        max_i  c_comp * w(b_i) / speed_i
               + sum_l lams[l] * |halo_l(b_i)|.

    What actually bounds a distributed CG iteration — unlike the summed
    :func:`tree_objective`, concentrating either load or halo volume on
    one PU is penalized even when the total stays flat.  Structurally it
    is also what the padded tree runtime pays: the max block size sets
    the padded rows B and the max per-level receive volume the halo slot
    count S_lvl of ``sparse.distributed.build_plan_tree``."""
    pp = per_pu_model_costs(g, part, anc, lams=lams, speeds=speeds,
                            c_comp=c_comp, vw=vw)
    return float(pp["total"].max(initial=0.0))



def pod_cut_split(g: Graph, part: np.ndarray,
                  pod_of: np.ndarray) -> tuple[float, float]:
    """Edge cut split by pod locality — the two-level instance of
    :func:`tree_cut_split`: ``(intra, inter)`` with ``intra + inter ==
    edge_cut`` exactly."""
    intra, inter = tree_cut_split(g, part,
                                  np.asarray(pod_of)[None, :])
    return float(intra), float(inter)


def pod_comm_volumes(g: Graph, part: np.ndarray, k: int,
                     pod_of: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Received-words per block split by the owner's pod — the two-level
    instance of :func:`tree_comm_volumes`: ``(intra, inter)`` (k,)
    arrays with ``intra + inter == comm_volumes`` exactly.

    ``inter.sum()`` is the total word count the hier schedule moves over
    the slow links; ``inter.max()`` the bottleneck per-PU slow-link
    volume."""
    vols = tree_comm_volumes(g, part, k, np.asarray(pod_of)[None, :])
    return vols[0], vols[1]
