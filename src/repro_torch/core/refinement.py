"""Combinatorial local refinement (Geographer-R, Sec. V) — host NumPy,
copied from ``src/repro/core/refinement.py`` and bit-equal to it.

Pipeline per refinement pass:
  1. build the communication (quotient) graph G_c — one vertex per block,
     edge weights = communication volume between block pairs;
  2. maximum-edge-coloring-style greedy coloring of G_c to schedule
     communication rounds (color classes = sets of disjoint block pairs that
     refine concurrently — Holtgrewe/Sanders/Schulz [20] style);
  3. per pair, pairwise FM on the extended boundary neighborhood: candidates
     are vertices within ``bfs_hops`` BFS rounds of the boundary, moves are
     gain-ordered with tentative-prefix rollback (classic FM), subject to the
     heterogeneous caps  size_i <= min(m_cap_i, (1+eps) tw_i).

The cut objective (flat, two-level ``pod_of``, tree ``anc``/``lams``,
weighted ``vw``) and the bottleneck objective (:class:`VolumeGainTracker`)
both run here, as do the per-level Kernighan–Lin sweeps of the block
grouping and :func:`vizing_edge_coloring`, the halo-round schedule of
``sparse.distributed.build_plan``.  Ties, heap order and every sort are the
reference's, so a partition refines to the same bytes.
"""
from __future__ import annotations

import heapq

import numpy as np

from ..sparse.graph import Graph
from .metrics import block_sizes_of, edge_cut, resolve_lams
from .topology import level_matrix


# -- incremental volume-gain structure (bottleneck objective) ----------------

class VolumeGainTracker:
    """Net-degree-style incremental structure for the bottleneck
    objective: tracks the *distinct* remote vertices each block receives,
    split by the owner's tree level, updated in O(deg + k) per applied
    move — never recomputed from scratch.

    Invariants (held after every applied move against the recompute in
    ``tests/test_torch_partition.py``):

      * ``nbr_cnt[r, u]``  == number of neighbors of vertex u inside
        block r (the net-degree counters);
      * ``vols``           == ``metrics.tree_comm_volumes(g, part, k,
        anc)`` exactly (int64, so equality is exact);
      * ``sizes``          == per-block weights.

    ``apply(v, to)`` mutates the tracked ``part`` array in place and is
    its own inverse (``apply(v, frm)`` undoes), which is what the FM
    rollback and the O(deg + k) tentative ``peek`` use.  Assumes a
    simple symmetric graph with no self-loops (the CSR contract of
    ``sparse.graph.Graph``).
    """

    def __init__(self, g: Graph, part: np.ndarray, k: int,
                 anc: np.ndarray | None = None, lams=None,
                 speeds: np.ndarray | None = None, c_comp: float = 1.0,
                 vw: np.ndarray | None = None):
        self.g = g
        self.k = int(k)
        self.part = part                      # shared, mutated by apply()
        if anc is None:                       # flat machine: one level
            anc = np.zeros((0, k), dtype=np.int64)
        anc = np.atleast_2d(np.asarray(anc))
        self.h = anc.shape[0] + 1
        self.lev = np.maximum(level_matrix(anc), 0)
        self.lams = np.asarray(resolve_lams(lams, self.h),
                               dtype=np.float64)
        self.c_comp = float(c_comp)
        self.speeds = (np.ones(self.k) if speeds is None
                       else np.asarray(speeds, dtype=np.float64))
        self.vw = None if vw is None else np.asarray(vw, dtype=np.float64)
        src, dst, _ = g.edge_list()
        self.nbr_cnt = np.zeros((self.k, g.n), dtype=np.int32)
        np.add.at(self.nbr_cnt, (part[src], dst), 1)
        self.vols = np.zeros((self.h, self.k), dtype=np.int64)
        for r in range(self.k):
            remote = (self.nbr_cnt[r] > 0) & (part != r)
            self.vols[:, r] = np.bincount(self.lev[r, part[remote]],
                                          minlength=self.h)
        self.sizes = (block_sizes_of(part, self.k).astype(np.float64)
                      if self.vw is None
                      else np.bincount(part, weights=self.vw,
                                       minlength=self.k))

    def totals(self) -> np.ndarray:
        """(k,) per-PU modeled cost: compute + weighted receive volume
        (== ``metrics.per_pu_model_costs(...)['total']``)."""
        return (self.c_comp * self.sizes / self.speeds
                + self.lams @ self.vols)

    def bottleneck(self) -> float:
        """Current ``metrics.bottleneck_objective`` value."""
        return float(self.totals().max(initial=0.0))

    def critical_pu(self) -> int:
        return int(self.totals().argmax())

    def apply(self, v: int, to: int) -> None:
        """Move vertex ``v`` to block ``to``; O(deg(v) + k)."""
        v, to = int(v), int(to)
        frm = int(self.part[v])
        if frm == to:
            return
        g, lev, vols = self.g, self.lev, self.vols
        nb = g.indices[g.indptr[v]:g.indptr[v + 1]]
        own = self.part[nb]
        # receiver side: v stops/starts being a block-frm/-to neighbor of
        # each u in N(v); a 1 -> 0 (0 -> 1) transition on a remote u
        # drops (adds) u from that block's halo at the owner's level
        cnt = self.nbr_cnt[frm, nb]
        self.nbr_cnt[frm, nb] = cnt - 1
        gone = (cnt == 1) & (own != frm)
        np.subtract.at(vols, (lev[frm, own[gone]], frm), 1)
        cnt = self.nbr_cnt[to, nb]
        self.nbr_cnt[to, nb] = cnt + 1
        new = (cnt == 0) & (own != to)
        np.add.at(vols, (lev[to, own[new]], to), 1)
        # owner side: every block adjacent to v now receives it from
        # ``to`` instead of ``frm`` (at a possibly different level)
        recv = np.flatnonzero(self.nbr_cnt[:, v] > 0)
        r_rm = recv[recv != frm]
        np.subtract.at(vols, (lev[r_rm, frm], r_rm), 1)
        r_ad = recv[recv != to]
        np.add.at(vols, (lev[r_ad, to], r_ad), 1)
        w = 1.0 if self.vw is None else self.vw[v]
        self.sizes[frm] -= w
        self.sizes[to] += w
        self.part[v] = to

    def peek(self, v: int, to: int) -> float:
        """Objective after tentatively moving ``v`` — state (including
        ``part``) is restored before returning."""
        frm = int(self.part[v])
        self.apply(v, to)
        val = self.bottleneck()
        self.apply(v, frm)
        return val

    def totals_key(self) -> tuple:
        """Per-PU totals sorted descending, as a lexicographically
        comparable tuple.  ``key_a < key_b`` iff partition a is strictly
        better under the bottleneck order: smaller makespan, or equal
        makespan with a smaller second-heaviest PU, and so on.  This is
        what the bottleneck FM minimizes — comparing only the max would
        plateau as soon as two PUs tie at the top, and the overload
        could never diffuse across intermediate blocks."""
        return tuple(np.sort(self.totals())[::-1])

    def peek_key(self, v: int, to: int) -> tuple:
        """:meth:`totals_key` after tentatively moving ``v`` — state is
        restored before returning."""
        frm = int(self.part[v])
        self.apply(v, to)
        key = self.totals_key()
        self.apply(v, frm)
        return key


# -- 1. quotient graph ------------------------------------------------------

def quotient_graph(g: Graph, part: np.ndarray, k: int):
    """Block-level communication graph: returns (pairs, weights) with
    pairs (m, 2) int (a < b), weights = inter-block edge weight (cut)."""
    src, dst, w = g.edge_list()
    pa, pb = part[src], part[dst]
    ext = pa < pb
    key = pa[ext].astype(np.int64) * k + pb[ext]
    order = np.argsort(key, kind="stable")
    key_s, w_s = key[order], w[ext][order]
    uniq, start = np.unique(key_s, return_index=True)
    wsum = np.add.reduceat(w_s, start) if len(w_s) else np.zeros(0)
    pairs = np.stack([uniq // k, uniq % k], axis=1).astype(np.int32)
    return pairs, wsum


# -- 2. edge coloring -------------------------------------------------------

def greedy_edge_coloring(pairs: np.ndarray, weights: np.ndarray
                         ) -> np.ndarray:
    """Greedy edge coloring, heaviest edges first.  Returns color per edge.

    Guarantees <= 2*maxdeg - 1 colors; in practice close to maxdeg (Vizing).
    Heaviest-first means the largest communication volumes get the earliest
    rounds — matching [20]'s scheduling heuristic.
    """
    order = np.argsort(-weights, kind="stable")
    colors = -np.ones(len(pairs), dtype=np.int32)
    used: dict[int, set[int]] = {}
    for e in order:
        a, b = int(pairs[e, 0]), int(pairs[e, 1])
        ua = used.setdefault(a, set())
        ub = used.setdefault(b, set())
        c = 0
        while c in ua or c in ub:
            c += 1
        colors[e] = c
        ua.add(c)
        ub.add(c)
    return colors


def vizing_edge_coloring(pairs: np.ndarray,
                         weights: np.ndarray | None = None) -> np.ndarray:
    """Misra–Gries edge coloring: guaranteed <= maxdeg + 1 colors (Vizing's
    bound).  Returns a color per edge.

    Used for the halo-exchange round schedule in ``sparse.distributed``:
    each color class is a matching = one ppermute round, so the Delta+1
    guarantee bounds the number of rounds by quotient-graph degree + 1
    (greedy only guarantees 2*Delta - 1).  Colors are relabeled so the
    heaviest class (largest total communication volume) is round 0 —
    preserving the heaviest-first scheduling of :func:`greedy_edge_coloring`
    at class granularity.

    O(V * E) on the quotient graph — V = #blocks, tiny by construction.
    """
    m = len(pairs)
    if m == 0:
        return np.zeros(0, np.int32)
    pairs = np.asarray(pairs, dtype=np.int64)
    # at[x]: color -> (edge index, neighbor); edge_color[e] current color
    at: dict[int, dict[int, tuple[int, int]]] = {}
    for u in np.unique(pairs):
        at[int(u)] = {}
    edge_color = -np.ones(m, dtype=np.int32)
    deg = np.bincount(pairs.ravel())
    C = int(deg.max()) + 1                      # palette 0..Delta

    def free(x: int) -> int:
        cx = at[x]
        for c in range(C):
            if c not in cx:
                return c
        raise AssertionError("no free color — palette too small")

    def set_color(e: int, c: int) -> None:
        u, v = int(pairs[e, 0]), int(pairs[e, 1])
        old = int(edge_color[e])
        if old >= 0:
            at[u].pop(old, None)
            at[v].pop(old, None)
        edge_color[e] = c
        at[u][c] = (e, v)
        at[v][c] = (e, u)

    order = (np.argsort(-np.asarray(weights), kind="stable")
             if weights is not None else np.arange(m))
    for e in map(int, order):
        u, v = int(pairs[e, 0]), int(pairs[e, 1])
        # maximal fan of u starting at v
        fan = [v]
        in_fan = {v}
        while True:
            last = fan[-1]
            nxt = None
            for c_, (_e2, nbr) in at[u].items():
                if nbr not in in_fan and c_ not in at[last]:
                    nxt = nbr
                    break
            if nxt is None:
                break
            fan.append(nxt)
            in_fan.add(nxt)
        c = free(u)
        d = free(fan[-1])
        if c != d and d in at[u]:
            # invert the maximal cd-path starting at u.  Two phases (clear
            # all, then recolor all): flipping in place would transiently
            # alias two path edges onto one color at their shared endpoint
            # and the second flip would pop the first one's fresh entry.
            path = []
            x, need = u, d
            while need in at[x]:
                e2, nbr = at[x][need]
                path.append((e2, need))
                x, need = nbr, (c if need == d else d)
            for e2, col in path:
                a, b = int(pairs[e2, 0]), int(pairs[e2, 1])
                at[a].pop(col)
                at[b].pop(col)
                edge_color[e2] = -1
            for e2, col in path:
                set_color(e2, c if col == d else d)
        # w = first fan vertex with d free whose prefix is still a fan
        # (the inversion can break the fan property at one point; the lemma
        # guarantees a valid w exists at or before it)
        ucol_of = {nb: (cc, ee) for cc, (ee, nb) in at[u].items()}
        w_i = None
        for i, fv in enumerate(fan):
            if d not in at[fv]:
                w_i = i
                break
            if i + 1 < len(fan):
                nxt = ucol_of.get(fan[i + 1])
                if nxt is None or nxt[0] in at[fv]:
                    break                      # fan broken by the inversion
        assert w_i is not None, "Misra–Gries invariant violated"
        # rotate fan[0:w_i]: shift each (u, fan[i+1]) color onto (u, fan[i]);
        # the uncolored u-edge walks along the fan as colors shift down
        uncol = e                              # edge u–fan[0]
        for i in range(w_i):
            c_next, e_next = ucol_of[fan[i + 1]]
            edge_color[e_next] = -1
            at[u].pop(c_next)
            at[fan[i + 1]].pop(c_next)
            set_color(uncol, c_next)           # colors edge u–fan[i]
            uncol = e_next                     # u–fan[i+1] now uncolored
        set_color(uncol, d)

    # relabel so the heaviest color class is round 0
    w_arr = (np.asarray(weights, dtype=np.float64) if weights is not None
             else np.ones(m))
    n_col = int(edge_color.max()) + 1
    class_w = np.zeros(n_col)
    np.add.at(class_w, edge_color, w_arr)
    relabel = np.empty(n_col, dtype=np.int32)
    relabel[np.argsort(-class_w, kind="stable")] = np.arange(n_col)
    return relabel[edge_color].astype(np.int32)


# -- 3. pairwise FM ---------------------------------------------------------

def _boundary_candidates(g: Graph, part: np.ndarray, a: int, b: int,
                         bfs_hops: int, max_frac: float = 0.25
                         ) -> np.ndarray:
    """Vertices of blocks a/b within bfs_hops of the a|b boundary."""
    src, dst, _ = g.edge_list()
    on_ab = ((part[src] == a) & (part[dst] == b)) | \
            ((part[src] == b) & (part[dst] == a))
    frontier = np.unique(np.concatenate([src[on_ab], dst[on_ab]]))
    seen = np.zeros(g.n, dtype=bool)
    seen[frontier] = True
    in_pair = (part == a) | (part == b)
    for _ in range(bfs_hops):
        if len(frontier) == 0:
            break
        nbrs = []
        for v in frontier:
            nbrs.append(g.indices[g.indptr[v]:g.indptr[v + 1]])
        nxt = np.unique(np.concatenate(nbrs)) if nbrs else np.zeros(0, int)
        nxt = nxt[in_pair[nxt] & ~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    cand = np.nonzero(seen & in_pair)[0]
    # paper: "we do not consider all vertices but only a smaller number"
    cap = max(64, int(max_frac * in_pair.sum()))
    return cand[:cap]


def _level_cost_matrix(anc: np.ndarray, lams) -> np.ndarray:
    """(k, k) per-edge cost under an ancestor table: 0 on the diagonal
    (same block), ``lams[level]`` otherwise — the price the tree-aware
    FM gains charge a cut edge by the LCA level of its block pair."""
    anc = np.atleast_2d(np.asarray(anc))
    lams = resolve_lams(lams, anc.shape[0] + 1)
    lev = level_matrix(anc)
    cost = np.asarray(lams, dtype=np.float64)[np.maximum(lev, 0)]
    np.fill_diagonal(cost, 0.0)
    return cost


def _fm_pair_bottleneck(g: Graph, part: np.ndarray, a: int, b: int,
                        caps: np.ndarray, tracker: VolumeGainTracker,
                        bfs_hops: int = 2,
                        max_moves: int | None = None) -> float:
    """One bottleneck-objective FM pass between blocks a and b.

    Moves route through ``tracker.apply`` (which mutates ``part`` — the
    tracker must have been built over this very array); each step picks
    the candidate move minimizing the *global* sorted-totals vector
    lexicographically (``tracker.peek_key``, O(deg + k log k) per
    evaluation): smaller makespan first, then smaller second-heaviest
    PU, and so on — so overload drains off the critical PU and keeps
    diffusing through intermediate blocks even while the top of the
    order is momentarily tied.  Classic FM hill-climbing with
    best-prefix rollback; returns the makespan drop (>= 0; an epsilon
    when only the tail of the order improved).
    """
    assert tracker.part is part, "tracker must wrap the mutated part array"
    cand = _boundary_candidates(g, part, a, b, bfs_hops)
    if len(cand) == 0:
        return 0.0
    start = best = tracker.totals_key()
    locked = np.zeros(g.n, dtype=bool)
    history: list[tuple[int, int]] = []        # (v, frm)
    best_len = 0
    if max_moves is None:
        max_moves = min(len(cand), 64)
    vw = tracker.vw
    while len(history) < max_moves:
        best_v, best_to, best_key = -1, -1, None
        for v in cand:
            if locked[v]:
                continue
            frm = int(part[v])
            to = b if frm == a else a
            w_v = 1.0 if vw is None else vw[v]
            if tracker.sizes[to] + w_v > caps[to]:
                continue
            key = tracker.peek_key(v, to)
            if best_key is None or key < best_key:
                best_v, best_to, best_key = int(v), to, key
        if best_v < 0:
            break
        frm = int(part[best_v])
        tracker.apply(best_v, best_to)
        locked[best_v] = True
        history.append((best_v, frm))
        if best_key < best:
            best, best_len = best_key, len(history)
    for v, frm in reversed(history[best_len:]):
        tracker.apply(v, frm)
    # gain: the makespan drop; a lexicographic-only improvement (same
    # max, smaller tail) reports an epsilon so the pass loop keeps going
    drop = start[0] - best[0]
    if drop > 0:
        return float(drop)
    return 1e-12 if best < start else 0.0


def fm_pair_refine(g: Graph, part: np.ndarray, a: int, b: int,
                   caps: np.ndarray, bfs_hops: int = 2,
                   max_moves: int | None = None,
                   pod_of: np.ndarray | None = None, lam: float = 1.0,
                   anc: np.ndarray | None = None, lams=None,
                   vw: np.ndarray | None = None,
                   objective: str = "cut",
                   tracker: VolumeGainTracker | None = None) -> float:
    """One FM pass between blocks a and b.  Mutates ``part``.

    Returns the achieved gain (>= 0; rolls back to the best prefix).

    ``objective="bottleneck"`` switches the gains to the makespan
    objective (:func:`_fm_pair_bottleneck`): pass the shared
    :class:`VolumeGainTracker` built over this ``part`` array (it holds
    the global per-(receiver, level) volumes a bottleneck move gain
    depends on); ``anc``/``lams`` then live on the tracker.

    With ``anc`` (an (h-1, k) ancestor table, + ``lams``) the gains are
    computed against the *weighted tree objective*
    (``metrics.tree_objective``): a cut edge costs ``lams[level]`` at
    the LCA level of its block pair, so moves that pull an edge down the
    tree — off the slower links — are worth proportionally more.
    ``pod_of`` (+ ``lam``) is the two-level sugar: exactly
    ``anc=pod_of[None], lams=(1, lam)``, bit-identical to the two-level pod
    path.  Without either, the gain is the flat cut (every cut edge
    costs 1), bit-identical to the pre-pod-aware behavior.

    ``vw`` (n,) supplies per-vertex weights for the size/cap accounting
    (coarse-level supernodes in the multilevel pipeline); ``caps`` is
    then in weight units, not vertex counts.
    """
    if objective == "bottleneck":
        if tracker is None:
            raise ValueError("objective='bottleneck' needs the shared "
                             "VolumeGainTracker (tracker=)")
        return _fm_pair_bottleneck(g, part, a, b, caps, tracker,
                                   bfs_hops=bfs_hops, max_moves=max_moves)
    if objective != "cut":
        raise ValueError(f"unknown objective {objective!r}")
    if pod_of is not None:
        if anc is not None:
            raise ValueError("pass either pod_of= (two-level) or anc= "
                             "(tree), not both")
        anc = np.asarray(pod_of)[None, :]
        lams = (1.0, lam)
    cand = _boundary_candidates(g, part, a, b, bfs_hops)
    if len(cand) == 0:
        return 0.0
    if vw is None:
        sizes = block_sizes_of(part, len(caps)).astype(np.float64)
    else:
        vw = np.asarray(vw, dtype=np.float64)
        sizes = np.bincount(part, weights=vw, minlength=len(caps))

    if anc is None:
        def gain_of(v: int) -> float:
            nb = g.indices[g.indptr[v]:g.indptr[v + 1]]
            wv = g.weights[g.indptr[v]:g.indptr[v + 1]]
            own, other = (a, b) if part[v] == a else (b, a)
            return float(np.sum(wv * (part[nb] == other))
                         - np.sum(wv * (part[nb] == own)))
    else:
        C = _level_cost_matrix(anc, lams)       # per-pair LCA-level price

        def gain_of(v: int) -> float:
            nb = g.indices[g.indptr[v]:g.indptr[v + 1]]
            wv = g.weights[g.indptr[v]:g.indptr[v + 1]]
            own, other = (a, b) if part[v] == a else (b, a)
            blk = part[nb]
            return float(np.sum(wv * (C[blk, own] - C[blk, other])))

    heap = [(-gain_of(v), v) for v in cand]
    heapq.heapify(heap)
    locked = np.zeros(g.n, dtype=bool)
    stale = np.zeros(g.n, dtype=bool)

    history: list[tuple[int, int, int, float]] = []  # (v, frm, to, gain)
    total = best = 0.0
    best_len = 0
    max_moves = max_moves or len(cand)
    while heap and len(history) < max_moves:
        neg_g, v = heapq.heappop(heap)
        if locked[v]:
            continue
        if stale[v]:
            stale[v] = False
            heapq.heappush(heap, (-gain_of(v), v))
            continue
        gain = -neg_g
        frm = int(part[v])
        to = b if frm == a else a
        w_v = 1.0 if vw is None else vw[v]
        if sizes[to] + w_v > caps[to]:
            continue
        part[v] = to
        sizes[frm] -= w_v
        sizes[to] += w_v
        locked[v] = True
        total += gain
        history.append((v, frm, to, gain))
        if total > best + 1e-9:
            best, best_len = total, len(history)
        nb = g.indices[g.indptr[v]:g.indptr[v + 1]]
        stale[nb[~locked[nb]]] = True

    # roll back past the best prefix
    for v, frm, to, _ in reversed(history[best_len:]):
        part[v] = frm
    return best


# -- the pass loop -----------------------------------------------------------

def refine_partition(g: Graph, part: np.ndarray, tw: np.ndarray,
                     mems: np.ndarray | None = None, eps: float = 0.03,
                     passes: int = 3, bfs_hops: int = 2,
                     pod_of: np.ndarray | None = None, lam: float = 1.0,
                     anc: np.ndarray | None = None, lams=None,
                     vw: np.ndarray | None = None,
                     objective: str = "cut",
                     speeds: np.ndarray | None = None,
                     c_comp: float = 1.0,
                     verbose: bool = False) -> np.ndarray:
    """geoRef: scheduled pairwise FM until no pass improves the objective.

    ``anc``/``lams`` switch the FM gains to the weighted tree objective
    (a cut edge costs ``lams[LCA level]``); ``pod_of``/``lam`` is the
    two-level sugar (see :func:`fm_pair_refine`).  ``vw`` makes the
    size/cap accounting weight-aware (coarse multilevel levels —
    ``tw``/``mems`` are then compared against summed vertex weights).

    ``objective="bottleneck"`` refines the makespan instead: one shared
    :class:`VolumeGainTracker` carries the per-(receiver, level)
    deduplicated volumes and per-PU modeled compute (``speeds`` /
    ``c_comp``) across all pair passes, and pairs run ordered by how hot
    their heavier endpoint is — the critical PU drains first.  Pair
    coloring is irrelevant here (the pass loop is host-sequential and every
    gain is global), so the schedule is just the sort.
    """
    part = np.asarray(part, dtype=np.int32).copy()
    k = len(tw)
    caps = np.ceil(np.asarray(tw) * (1.0 + eps))
    if mems is not None:
        caps = np.minimum(caps, np.floor(np.asarray(mems)))

    if objective == "bottleneck":
        t_anc = anc
        if t_anc is None and pod_of is not None:
            t_anc = np.asarray(pod_of)[None, :]
            lams = (1.0, lam)
        tracker = VolumeGainTracker(g, part, k, t_anc, lams=lams,
                                    speeds=speeds, c_comp=c_comp, vw=vw)
        for p in range(passes):
            pairs, _w = quotient_graph(g, part, k)
            if len(pairs) == 0:
                break
            totals = tracker.totals()
            heat = np.maximum(totals[pairs[:, 0]], totals[pairs[:, 1]])
            gain = 0.0
            for e in np.argsort(-heat, kind="stable"):
                gain += fm_pair_refine(g, part, int(pairs[e, 0]),
                                       int(pairs[e, 1]), caps, bfs_hops,
                                       vw=vw, objective="bottleneck",
                                       tracker=tracker)
            if verbose:
                print(f"  refine pass {p}: gain {gain:.3f} "
                      f"makespan {tracker.bottleneck():.3f}")
            if gain <= 0.0:     # epsilon gains (lexicographic-only
                break           # improvements) keep the passes coming
        return part

    for p in range(passes):
        pairs, w = quotient_graph(g, part, k)
        if len(pairs) == 0:
            break
        colors = greedy_edge_coloring(pairs, w)
        gain = 0.0
        for c in range(colors.max() + 1):
            for e in np.nonzero(colors == c)[0]:
                gain += fm_pair_refine(g, part, int(pairs[e, 0]),
                                       int(pairs[e, 1]), caps, bfs_hops,
                                       pod_of=pod_of, lam=lam,
                                       anc=anc, lams=lams, vw=vw)
        if verbose:
            print(f"  refine pass {p}: gain {gain:.0f} "
                  f"cut {edge_cut(g, part):.0f}")
        if gain <= 0:
            break
    return part


# -- per-level sweeps on the block quotient graph ----------------------------

def _quotient_weight_matrix(pairs: np.ndarray, weights: np.ndarray,
                            k: int) -> np.ndarray:
    """Symmetric (k, k) dense weight matrix from :func:`quotient_graph`
    output (zero diagonal)."""
    W = np.zeros((k, k), dtype=np.float64)
    if len(pairs):
        pairs = np.asarray(pairs, dtype=np.int64)
        W[pairs[:, 0], pairs[:, 1]] = weights
        W += W.T
    return W


def _kl_sweep(W: np.ndarray, grouping: np.ndarray, groups: np.ndarray,
              max_swaps: int) -> tuple[np.ndarray, list[tuple[int, int]]]:
    """One Kernighan–Lin swap sweep of ``grouping`` on the dense quotient
    matrix ``W``: repeatedly apply the best block swap (across two
    groups, same ``groups`` id) that reduces the crossing weight, until
    none helps.  Returns ``(refined grouping, applied swaps in order)``
    — the swap list lets callers mirror the swaps onto deeper ancestor
    rows (:func:`refine_tree_assignment`'s whole-slot trades).
    Deterministic: ties break on the smallest (x, y)."""
    grouping = np.asarray(grouping, dtype=np.int64).copy()
    k = len(grouping)
    swaps: list[tuple[int, int]] = []
    for _ in range(max_swaps):
        best_gain, best = 1e-9, None
        for x in range(k):
            for y in range(x + 1, k):
                if grouping[x] == grouping[y] or groups[x] != groups[y]:
                    continue
                mp = grouping == grouping[x]
                mq = grouping == grouping[y]
                # KL gain: D_x + D_y - 2 w(x,y); edges to third groups
                # and the x-y edge itself stay crossing either way
                d_x = W[x] @ mq - W[x] @ mp
                d_y = W[y] @ mp - W[y] @ mq
                gain = float(d_x + d_y - 2.0 * W[x, y])
                if gain > best_gain:
                    best_gain, best = gain, (x, y)
        if best is None:
            break
        x, y = best
        grouping[x], grouping[y] = grouping[y], grouping[x]
        swaps.append((x, y))
    return grouping, swaps


def refine_pod_assignment(pairs: np.ndarray, weights: np.ndarray,
                          pod_of: np.ndarray,
                          groups: np.ndarray | None = None,
                          max_swaps: int | None = None) -> np.ndarray:
    """Kernighan–Lin sweep of the block->pod grouping on the block
    quotient graph — the single-level (``h == 2``) instance of
    :func:`refine_tree_assignment`.

    ``pairs``/``weights`` are :func:`quotient_graph` output; ``pod_of``
    the starting (k,) assignment (e.g. ``Topology.pod_assignment`` —
    contiguous).  Swapping preserves the pod sizes (the hier meshes are
    rectangular), and ``groups`` (k,) restricts swaps to blocks with the
    same group id — pass the PU spec class so a fast PU's block never
    lands on a slow PU's pod slot; two blocks may trade places only when
    their PUs are interchangeable.

    Returns the refined (k,) pod assignment — the *partition-derived*
    grouping that ``sparse.distributed.build_plan_hier`` consumes as an
    explicit pod array.  The inter-pod quotient weight (= inter-pod cut)
    never increases; the flat cut is untouched (only labels regroup).
    Deterministic: ties break on the smallest (x, y).  O(k^2) candidate
    pairs per applied swap with O(k) gain evaluation — the quotient
    graph has one vertex per PU, so this is host-trivial.
    """
    pod_of = np.asarray(pod_of, dtype=np.int64)
    k = len(pod_of)
    W = _quotient_weight_matrix(pairs, weights, k)
    groups = (np.zeros(k, dtype=np.int64) if groups is None
              else np.asarray(groups))
    out, _ = _kl_sweep(W, pod_of, groups, k * k if max_swaps is None
                       else max_swaps)
    return out


def refine_tree_assignment(pairs: np.ndarray, weights: np.ndarray,
                           anc: np.ndarray,
                           groups: np.ndarray | None = None,
                           max_swaps: int | None = None) -> np.ndarray:
    """Per-level Kernighan–Lin sweep of the block ancestor table on the
    block quotient graph — the tree generalization of
    :func:`refine_pod_assignment`.

    Levels are swept top-down (coarsest grouping first — it prices the
    most expensive links): at depth ``d`` the sweep trades whole *leaf
    slots* between depth-``d`` groups, minimizing the weight crossing
    that grouping; swaps are restricted to blocks with the same
    ``groups`` id (PU spec class) *and* — below the top level — the same
    depth-``d-1`` ancestor, so every swap keeps the table nested and all
    coarser decisions intact.  Each applied swap exchanges the blocks'
    entire remaining slot paths (``anc[d:, x] <-> anc[d:, y]``), which
    is what makes the nesting invariant free.

    Returns the refined (h-1, k) ancestor table, consumable by
    ``sparse.distributed.build_plan_tree`` — per level, the crossing
    quotient weight never increases versus the input table, pod/group
    sizes are preserved, and the flat cut is untouched.
    """
    anc = np.atleast_2d(np.asarray(anc, dtype=np.int64)).copy()
    h1, k = anc.shape
    W = _quotient_weight_matrix(pairs, weights, k)
    groups = (np.zeros(k, dtype=np.int64) if groups is None
              else np.asarray(groups, dtype=np.int64))
    if max_swaps is None:
        max_swaps = k * k
    for d in range(h1):
        # below the top level, a trade must stay inside one parent group
        if d == 0:
            combo = groups
        else:
            parent = anc[d - 1]
            combo = groups * (int(parent.max()) + 1) + parent
        _, swaps = _kl_sweep(W, anc[d], combo, max_swaps)
        for x, y in swaps:                     # whole-slot trades
            anc[d:, [x, y]] = anc[d:, [y, x]]
    return anc
