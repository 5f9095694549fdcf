"""Partition quality metrics (Sec. II-A / VI-a), host NumPy copied from
``src/repro/core/metrics.py`` and bit-equal to it.

  * edge cut          — weight of edges with endpoints in different blocks
  * comm volume       — per block b: # of vertices outside b adjacent to b
                        (data words b must receive); max over blocks is the
                        paper's maxCommVolume
  * imbalance         — max_i tw_actual(b_i)/tw_target(b_i)
  * load ratio        — objective (2): max_i |b_i| / c_s(p_i)

Hierarchical (tree-aware) metrics: given an (h-1, k) ancestor table of
the blocks (``topology.normalize_tree_of``), cut and comm volume split
exactly into per-tree-level components — every cut edge / received word
crosses a block pair with exactly one LCA level — and the *weighted tree
objective* ``sum_level lam[level] * cut[level]`` prices each level by its
link cost (``topology.LinkCosts.lams``), the objective the tree-aware
refinement minimizes.  The two-level (pod) metrics are the ``h == 2``
instance.  :func:`summarize`, :func:`summarize_tree` and
:func:`summarize_hier` are the rows of ``core.api.evaluate`` (Table IV).
"""
from __future__ import annotations

import numpy as np

from ..sparse.graph import Graph
from .topology import LinkCosts, Topology, level_matrix


def _default_link_costs() -> LinkCosts:
    """THE default cost model for every metric that takes an optional
    ``lam``/``lams``: one resolution point, so the objective, the FM
    gains, and ``summarize_hier``/``summarize_tree`` can never disagree
    about what an unspecified lambda means.  Topology-calibrated models
    come in through the ``lam``/``lams`` arguments
    (``Topology.link_costs()``)."""
    return LinkCosts()


def _resolve_lam(lam: float | None) -> float:
    return _default_link_costs().lam if lam is None else lam


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


def total_comm_volume(g: Graph, part: np.ndarray, k: int) -> int:
    return int(comm_volumes(g, part, k).sum())


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


def load_ratio(part: np.ndarray, topo: Topology) -> float:
    """Objective (2) evaluated on the realized partition."""
    sizes = block_sizes_of(part, topo.k)
    return float(np.max(sizes / topo.speeds))


def memory_violations(part: np.ndarray, topo: Topology,
                      slack: float = 0.0) -> int:
    """# of blocks violating constraint (3), with optional relative slack."""
    sizes = block_sizes_of(part, topo.k)
    return int(np.sum(sizes > topo.memories * (1.0 + slack)))


def boundary_mask(g: Graph, part: np.ndarray) -> np.ndarray:
    """Vertices with >=1 neighbor in another block."""
    src, dst, _ = g.edge_list()
    ext = part[src] != part[dst]
    mask = np.zeros(g.n, dtype=bool)
    mask[src[ext]] = True
    return mask


def summarize(g: Graph, part: np.ndarray, topo: Topology,
              tw: np.ndarray) -> dict:
    vols = comm_volumes(g, part, topo.k)
    compute = block_sizes_of(part, topo.k) / topo.speeds
    total = compute + vols
    return {
        "cut": edge_cut(g, part),
        "max_comm_volume": int(vols.max(initial=0)),
        "total_comm_volume": int(vols.sum()),
        "imbalance": imbalance(part, tw),
        "load_ratio": load_ratio(part, topo),
        "mem_violations": memory_violations(part, topo, slack=0.03),
        # per-PU modeled split of the flat (single-level) bottleneck:
        # compute = Algorithm-1 speeds x block weight, comm = dedup halo
        "per_pu_compute": compute.tolist(),
        "per_pu_comm_volume": vols.tolist(),
        "bottleneck_objective": float(total.max(initial=0.0)),
        "critical_pu": int(total.argmax()) if len(total) else 0,
    }


# -- hierarchical (tree-aware) metrics --------------------------------------

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


def two_level_objective(g: Graph, part: np.ndarray, pod_of: np.ndarray,
                        lam: float | None = None) -> float:
    """The weighted two-level cut ``intra + lam * inter`` — the ``h == 2``
    instance of :func:`tree_objective`.  ``lam`` defaults to the shared
    cost model's round-latency ratio (one resolution point with
    :func:`summarize_hier`)."""
    lam = _resolve_lam(lam)
    return tree_objective(g, part, np.asarray(pod_of)[None, :],
                          lams=(1.0, lam))


def summarize_tree(g: Graph, part: np.ndarray, topo: Topology,
                   tw: np.ndarray, anc: np.ndarray,
                   lams=None) -> dict:
    """:func:`summarize` plus the per-level cut/volume splits and the
    weighted tree objective (Table IV analogue for the tree pipeline)."""
    anc = np.atleast_2d(np.asarray(anc))
    h = anc.shape[0] + 1
    lams = resolve_lams(lams, h)
    out = summarize(g, part, topo, tw)
    cuts = tree_cut_split(g, part, anc)
    vols = tree_comm_volumes(g, part, topo.k, anc)
    obj = 0.0
    for lam_l, cut_l in zip(lams, cuts):
        obj += lam_l * cut_l
    # tree-aware bottleneck split: same lams, Algorithm-1 speeds
    compute = block_sizes_of(part, topo.k) / topo.speeds
    comm = np.asarray(lams, dtype=np.float64) @ vols
    total = compute + comm
    out.update(
        cut_by_level=cuts.tolist(),
        comm_volume_by_level=[int(v.sum()) for v in vols],
        max_comm_volume_by_level=[int(v.max(initial=0)) for v in vols],
        tree_objective=float(obj),
        lams=list(lams),
        per_pu_compute=compute.tolist(),
        per_pu_comm=comm.tolist(),
        bottleneck_objective=float(total.max(initial=0.0)),
        critical_pu=int(total.argmax()) if len(total) else 0,
    )
    return out


def summarize_hier(g: Graph, part: np.ndarray, topo: Topology,
                   tw: np.ndarray, pod_of: np.ndarray,
                   lam: float | None = None) -> dict:
    """:func:`summarize` plus the intra/inter split and the weighted
    objective — the two-level view of :func:`summarize_tree` (same
    default cost model, so the objective and the summary can't
    diverge)."""
    lam = _resolve_lam(lam)
    out = summarize_tree(g, part, topo, tw,
                         np.asarray(pod_of)[None, :], lams=(1.0, lam))
    cuts = out.pop("cut_by_level")
    vols = out.pop("comm_volume_by_level")
    maxv = out.pop("max_comm_volume_by_level")
    out.pop("lams")
    out.update(
        cut_intra=cuts[0], cut_inter=cuts[1],
        comm_volume_intra=vols[0], comm_volume_inter=vols[1],
        max_comm_volume_intra=maxv[0], max_comm_volume_inter=maxv[1],
        two_level_objective=out.pop("tree_objective"),
        lam=lam,
    )
    return out
