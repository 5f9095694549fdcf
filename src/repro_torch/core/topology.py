"""Compute-system topology model for the LDHT problem (host NumPy, copied
from ``src/repro/core/topology.py``; bit-equal to it): PUs and topologies,
the implicit tree (ancestor tables, tree levels, pod groupings and their
aggregates), the per-level link-cost model and the tree/pod validators that
``sparse.distributed.build_plan_tree`` shares with the partitioner side.

The paper (Sec. II-B) represents the compute system as a tree T whose leaves
are the k processing units (PUs).  Each PU p_i carries two weights:

  * ``c_s(p_i)``    — normalized speed (operations / time unit)
  * ``m_cap(p_i)``  — memory capacity (same unit as vertex load)

Inner nodes accumulate the values of their children.  The hierarchical
balanced k-means (Sec. V) consumes the tree as a fan-out list
``k_1, ..., k_h`` with per-leaf specs.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class PU:
    """A processing unit (leaf of the topology tree)."""

    speed: float          # c_s(p_i) > 0
    memory: float         # m_cap(p_i) > 0
    name: str = ""

    def __post_init__(self):
        if self.speed <= 0:
            raise ValueError(f"PU speed must be positive, got {self.speed}")
        if self.memory <= 0:
            raise ValueError(f"PU memory must be positive, got {self.memory}")


@dataclasses.dataclass(frozen=True)
class Topology:
    """A (possibly hierarchical) compute topology.

    ``fanouts`` is the implicit-tree representation from Sec. V: a list
    ``[k_1, ..., k_h]`` with ``prod(fanouts) == len(pus)``.  A flat system is
    ``fanouts = [k]``.
    """

    pus: tuple[PU, ...]
    fanouts: tuple[int, ...] = ()

    def __post_init__(self):
        if not self.pus:
            raise ValueError("Topology needs at least one PU")
        fanouts = self.fanouts or (len(self.pus),)
        object.__setattr__(self, "fanouts", tuple(fanouts))
        if int(np.prod(self.fanouts)) != len(self.pus):
            raise ValueError(
                f"prod(fanouts)={np.prod(self.fanouts)} != k={len(self.pus)}")

    # -- aggregate quantities (Table I) ------------------------------------
    @property
    def k(self) -> int:
        return len(self.pus)

    @property
    def speeds(self) -> np.ndarray:
        return np.array([p.speed for p in self.pus], dtype=np.float64)

    @property
    def memories(self) -> np.ndarray:
        return np.array([p.memory for p in self.pus], dtype=np.float64)

    @property
    def total_speed(self) -> float:       # C_s
        return float(self.speeds.sum())

    @property
    def total_memory(self) -> float:      # M_cap
        return float(self.memories.sum())

    def feasible(self, n: float) -> bool:
        """A valid solution exists iff the load fits in total memory."""
        return n <= self.total_memory + 1e-12

    # -- implicit-tree structure (Sec. II-B / V) ---------------------------
    @property
    def depth(self) -> int:
        """h = len(fanouts): number of tree levels below the root.  A flat
        system is depth 1; the two-level pod machine of PRs 3-4 is the
        ``h == 2`` instance."""
        return len(self.fanouts)

    def ancestor_table(self, fanouts: Sequence[int] | None = None
                       ) -> np.ndarray:
        """Canonical (h-1, k) ancestor table of the implicit tree.

        Row ``t`` gives, per leaf, the id of its ancestor at tree depth
        ``t + 1`` (0 = the children of the root, coarsest): leaf ``i``
        written in ``fanouts`` mixed radix has ancestor
        ``i // prod(fanouts[t+1:])``.  For ``h == 2`` the single row is
        exactly :meth:`pod_assignment`'s contiguous pod grouping.  The
        table is the tree analogue of ``pod_of`` — the representation
        the tree metrics, the per-level KL sweep, and
        ``sparse.distributed.build_plan_tree`` all consume.
        """
        fanouts = tuple(fanouts) if fanouts is not None else self.fanouts
        return canonical_ancestors(fanouts)

    def level_of(self, i, j, fanouts: Sequence[int] | None = None):
        """Tree-distance level of PU pair (i, j): 0 = the pair shares its
        deepest internal node (fastest links), ``h - 1`` = only the root
        is shared (slowest links); -1 for ``i == j``.  Vectorized over
        array inputs.  This is the level whose ``LinkCosts`` entry a cut
        edge between blocks i and j pays."""
        fanouts = tuple(fanouts) if fanouts is not None else self.fanouts
        i = np.asarray(i, dtype=np.int64)
        j = np.asarray(j, dtype=np.int64)
        h = len(fanouts)
        shared = np.zeros(np.broadcast(i, j).shape, dtype=np.int64)
        size = int(np.prod(fanouts))
        for t in range(1, h):
            size //= fanouts[t - 1]            # subtree size at depth t
            shared += (i // size) == (j // size)
        level = h - 1 - shared
        level = np.where(i == j, -1, level)
        return level if level.ndim else int(level)

    def tree_aggregate(self, anc_row) -> "Topology":
        """Aggregate topology with one PU per group of ``anc_row`` — the
        per-level generalization of :meth:`pod_aggregate` (pass any row
        of the ancestor table to aggregate the corresponding tree level;
        the tree-aware Algorithm 1 water-fills these top-down)."""
        return self.pod_aggregate(anc_row)

    def pod_assignment(self, pods: int) -> np.ndarray:
        """(k,) pod id per PU: contiguous equal-size grouping of the PU
        list (``sparse.distributed.build_plan_hier``'s default).

        Algorithm-1 block sizes follow the PU order, and every paper
        topology lists the fast PUs first — so contiguous grouping puts
        the fast PUs (which own the largest blocks and therefore share
        the heaviest cut) inside one pod, where their exchange rides the
        fast intra-pod links.  When ``fanouts`` describes a two-level
        tree whose top fan-out equals ``pods`` (e.g. ``topo3``), the
        grouping coincides with the tree's node boundaries.
        """
        return contiguous_pods(self.k, pods)

    def pod_aggregate(self, pods) -> "Topology":
        """One-PU-per-pod aggregate topology (inner tree nodes, Sec. II-B).

        ``pods`` is a pod count (contiguous grouping via
        :meth:`pod_assignment`) or an explicit (k,) pod-of-PU array.
        Each aggregate PU carries the summed speed and memory of its
        members, so Algorithm 1 on the aggregate yields the per-pod
        block sizes of the two-level pipeline (``api.partition_hier``):
        the pod-level targets are exactly the per-pod sums of the leaf
        targets whenever no member is memory-saturated, and remain
        feasible (per-pod memory is the true per-pod capacity) when some
        are.
        """
        pod_of = normalize_pod_of(pods, self.k)
        n_pods = int(pod_of.max()) + 1
        speeds = np.zeros(n_pods)
        mems = np.zeros(n_pods)
        np.add.at(speeds, pod_of, self.speeds)
        np.add.at(mems, pod_of, self.memories)
        return Topology(tuple(PU(speeds[p], mems[p], f"pod{p}")
                              for p in range(n_pods)), (n_pods,))

    def link_costs(self, intra: float | None = None,
                   inter: float | None = None,
                   costs: Sequence[float] | None = None,
                   levels: int | None = None) -> "LinkCosts":
        """Per-cut-edge link-cost model for this topology's ``fanouts``
        tree: a cut edge between PUs i and j pays ``costs[level_of(i, j)]``
        — one unit for siblings, more per extra tree level the exchange
        must climb.  ``costs`` supplies the per-level vector directly
        (calibrate from measured round latencies); otherwise a geometric
        ladder ``intra * (inter/intra)**level`` over ``levels`` levels
        (default ``max(depth, 2)``) reproduces the two-level defaults
        (:data:`INTRA_LINK_COST` / :data:`INTER_LINK_COST`) at depth 2."""
        if costs is not None:
            return LinkCosts(costs=costs)
        intra = INTRA_LINK_COST if intra is None else intra
        inter = INTER_LINK_COST if inter is None else inter
        if levels is None:
            levels = max(self.depth, 2)
        if levels == 2:
            return LinkCosts(intra, inter)
        ratio = inter / intra
        return LinkCosts(costs=tuple(intra * ratio ** l
                                     for l in range(levels)))

    # -- constructors for the paper's simulated systems ---------------------
    @staticmethod
    def homogeneous(k: int, speed: float = 1.0, memory: float = 2.0,
                    fanouts: Sequence[int] | None = None) -> "Topology":
        return Topology(tuple(PU(speed, memory, f"pu{i}") for i in range(k)),
                        tuple(fanouts) if fanouts else (k,))

    @staticmethod
    def topo1(k: int, fast_fraction: float = 1 / 12,
              fast_speed: float = 2.0, fast_memory: float = 3.2) -> "Topology":
        """TOPO1 (Sec. VI-A): two sets, F (fast) and S (slow).

        Slow PUs always have speed 1 and memory 2 (Table III).  |F| = k/12 or
        k/6; the fast specs step through Table III rows.
        """
        n_fast = max(1, int(round(k * fast_fraction)))
        pus = [PU(fast_speed, fast_memory, f"fast{i}") for i in range(n_fast)]
        pus += [PU(1.0, 2.0, f"slow{i}") for i in range(k - n_fast)]
        return Topology(tuple(pus))

    @staticmethod
    def topo2(k: int, fast_fraction: float = 1 / 12,
              fast_speed: float = 2.0, fast_memory: float = 3.2) -> "Topology":
        """TOPO2 (Sec. VI-B): F + two slow groups S1, S2 with |S1| = |S2|.

        S2 PUs: speed 1, memory 2 (constant).  S1 PUs have memory 2 and speed
        chosen so that c_s(s1)/m_cap(s1) = (1/2) c_s(f)/m_cap(f)   (Eq. 5).
        """
        n_fast = max(1, int(round(k * fast_fraction)))
        n_slow = k - n_fast
        n_s1 = n_slow // 2
        n_s2 = n_slow - n_s1
        s1_speed = 0.5 * (fast_speed / fast_memory) * 2.0   # memory 2
        pus = [PU(fast_speed, fast_memory, f"fast{i}") for i in range(n_fast)]
        pus += [PU(s1_speed, 2.0, f"s1_{i}") for i in range(n_s1)]
        pus += [PU(1.0, 2.0, f"s2_{i}") for i in range(n_s2)]
        return Topology(tuple(pus))

    @staticmethod
    def topo3(nodes: int = 4, cores_per_node: int = 24, fast_nodes: int = 1,
              slow_speed: float = 0.5, slow_memory: float = 1.0) -> "Topology":
        """TOPO3 (Sec. VI-C): whole cluster nodes tuned down.

        ``fast_nodes`` nodes keep (1, 2); the rest get
        (slow_speed, slow_memory).  Hierarchical: fanouts = (nodes, cores).
        """
        pus = []
        for node in range(nodes):
            fast = node < fast_nodes
            for c in range(cores_per_node):
                pus.append(PU(1.0 if fast else slow_speed,
                              2.0 if fast else slow_memory,
                              f"n{node}c{c}"))
        return Topology(tuple(pus), fanouts=(nodes, cores_per_node))


# -- link-cost model over the topology tree ---------------------------------
#
# The tree runtime (sparse/distributed.py, comm="hier") pays one ppermute
# class per tree level at its own latency: level-0 rounds ride the fast
# innermost axes and overlap every slower exchange, while each outer level
# traverses progressively slower links (ICI < intra-node < DCN).  The
# per-cut-edge costs below are the relative round latencies that schedule
# implies — one unit for a sibling halo word, INTER_LINK_COST units per
# pod-crossing one (the ~4x DCN-vs-ICI gap the hier benchmark models);
# deeper trees default to the geometric ladder intra * (inter/intra)**lvl.
# The normalized vector is the per-level lambda of the tree objective
# (metrics.tree_objective) that the tree-aware refinement minimizes;
# override from measured round latencies when calibrating a real machine.

INTRA_LINK_COST = 1.0
INTER_LINK_COST = 4.0


@dataclasses.dataclass(frozen=True, init=False)
class LinkCosts:
    """Per-tree-level per-edge communication cost vector.

    ``costs[level]`` is the cost of one halo word between two PUs whose
    LCA sits ``level`` tree edges above them (``Topology.level_of``):
    ``costs[0]`` between siblings, ``costs[-1]`` across the root.  The
    two-positional-argument form ``LinkCosts(intra, inter)`` builds the
    ``h == 2`` instance (``intra``/``inter``/``lam`` keep their
    two-level meaning as views of the vector).
    """

    costs: tuple[float, ...]

    def __init__(self, intra: float | None = None,
                 inter: float | None = None, *,
                 costs: Sequence[float] | None = None):
        if costs is not None:
            if intra is not None or inter is not None:
                raise ValueError("pass either (intra, inter) or costs=, "
                                 "not both")
            costs = tuple(float(c) for c in costs)
        else:
            costs = (INTRA_LINK_COST if intra is None else float(intra),
                     INTER_LINK_COST if inter is None else float(inter))
        if not costs or any(c <= 0 for c in costs):
            raise ValueError("link costs must be positive")
        object.__setattr__(self, "costs", costs)

    @property
    def levels(self) -> int:
        return len(self.costs)

    @property
    def intra(self) -> float:
        """Innermost (sibling) per-edge cost — the cost unit."""
        return self.costs[0]

    @property
    def inter(self) -> float:
        """Outermost (root-crossing) per-edge cost."""
        return self.costs[-1]

    @property
    def lam(self) -> float:
        """lambda = inter/intra, the weight of the two-level objective."""
        return self.inter / self.intra

    @property
    def lams(self) -> tuple[float, ...]:
        """Per-level objective weights, normalized so ``lams[0] == 1``:
        the lambda vector of ``metrics.tree_objective``."""
        return tuple(c / self.costs[0] for c in self.costs)

    def matrix(self, pod_of: np.ndarray) -> np.ndarray:
        """(k, k) cost per block pair of the two-level instance: 0 on the
        diagonal, ``intra`` for same-pod pairs, ``inter`` for
        pod-crossing pairs."""
        pod_of = np.asarray(pod_of)
        same = pod_of[:, None] == pod_of[None, :]
        cost = np.where(same, self.intra, self.inter)
        np.fill_diagonal(cost, 0.0)
        return cost

    def tree_matrix(self, anc: np.ndarray) -> np.ndarray:
        """(k, k) cost per block pair under an (h-1, k) ancestor table:
        0 on the diagonal, ``costs[level]`` elsewhere, level = tree
        distance to the pair's LCA.  Needs ``levels >= h``."""
        lev = level_matrix(anc)
        if lev.max(initial=-1) >= self.levels:
            raise ValueError(f"ancestor table implies depth "
                             f"{lev.max() + 1} > {self.levels} cost levels")
        cost = np.asarray(self.costs)[np.maximum(lev, 0)]
        np.fill_diagonal(cost, 0.0)
        return cost


def normalize_pod_of(pods, k: int) -> np.ndarray:
    """``pods`` (pod count or explicit (k,) pod-of-block array) -> (k,)
    int64 pod ids.  The explicit path validates shape and equal pod sizes
    (the hier meshes are rectangular), mirroring
    ``sparse.distributed.build_plan_hier``."""
    if np.ndim(pods) == 0:
        return contiguous_pods(k, int(pods))
    pod_of = np.ascontiguousarray(pods, dtype=np.int64)
    if len(pod_of) != k:
        raise ValueError(f"pods array has {len(pod_of)} entries, "
                         f"expected k={k}")
    if pod_of.min() < 0:
        raise ValueError("pod ids must be >= 0")
    counts = np.bincount(pod_of, minlength=int(pod_of.max()) + 1)
    if not (counts == counts[0]).all():
        raise ValueError(f"pods must be equal-sized for a rectangular "
                         f"mesh; got sizes {counts.tolist()}")
    return pod_of


def contiguous_pods(k: int, pods: int) -> np.ndarray:
    """(k,) pod id per block: contiguous equal-size grouping — block b
    goes to pod ``b // (k // pods)``.  Requires ``pods | k`` (the
    two-level meshes are rectangular)."""
    if pods <= 0 or k % pods:
        raise ValueError(f"pods={pods} must divide k={k}")
    return np.arange(k, dtype=np.int64) // (k // pods)


def canonical_ancestors(fanouts: Sequence[int]) -> np.ndarray:
    """Canonical (h-1, k) ancestor table of the ``fanouts`` implicit tree:
    row ``t`` = ``leaf // prod(fanouts[t+1:])`` (contiguous nested
    grouping).  Row 0 of a two-level tree is :func:`contiguous_pods`."""
    fanouts = tuple(int(f) for f in fanouts)
    if not fanouts or any(f <= 0 for f in fanouts):
        raise ValueError(f"fanouts must be positive, got {fanouts}")
    k = int(np.prod(fanouts))
    leaves = np.arange(k, dtype=np.int64)
    rows = []
    size = k
    for t in range(len(fanouts) - 1):
        size //= fanouts[t]                    # subtree size at depth t+1
        rows.append(leaves // size)
    return (np.stack(rows) if rows
            else np.zeros((0, k), dtype=np.int64))


def level_matrix(anc: np.ndarray) -> np.ndarray:
    """(k, k) tree-distance level per block pair from an (h-1, k)
    ancestor table: 0 for pairs sharing every ancestor (siblings),
    ``h - 1`` for pairs sharing only the root; -1 on the diagonal."""
    anc = np.atleast_2d(np.asarray(anc, dtype=np.int64))
    h = anc.shape[0] + 1
    k = anc.shape[1]
    eq_all = np.ones((k, k), dtype=bool)
    shared = np.zeros((k, k), dtype=np.int64)
    for row in anc:
        eq_all &= row[:, None] == row[None, :]
        shared += eq_all
    lev = h - 1 - shared
    np.fill_diagonal(lev, -1)
    return lev


def normalize_tree_of(tree, k: int,
                      fanouts: Sequence[int] | None = None) -> np.ndarray:
    """Ancestor-table analogue of :func:`normalize_pod_of`: returns a
    validated (h-1, k) int64 table.

    Accepted forms: ``None`` (canonical contiguous table from
    ``fanouts``), a pod count or (k,) pod array (the two-level instance —
    one row), or a full (h-1, k) table.  Validation: every row groups the
    k blocks into equal-sized parts (the tree meshes are rectangular),
    rows are *nested* (each depth-(t+1) group lies inside one depth-t
    group), and — when ``fanouts`` is given — the group count of row t is
    ``prod(fanouts[:t+1])``.
    """
    if tree is None:
        if fanouts is None:
            raise ValueError("need fanouts when no ancestor table given")
        anc = canonical_ancestors(fanouts)
        if anc.shape[1] != k:
            raise ValueError(f"prod(fanouts)={anc.shape[1]} != k={k}")
        return anc
    arr = np.asarray(tree)
    if arr.ndim <= 1:                          # pods count or (k,) pod array
        anc = normalize_pod_of(tree, k)[None, :]
    else:
        anc = np.ascontiguousarray(arr, dtype=np.int64)
    if anc.shape[1] != k:
        raise ValueError(f"ancestor table has {anc.shape[1]} columns, "
                         f"expected k={k}")
    if fanouts is not None and anc.shape[0] != len(fanouts) - 1:
        raise ValueError(f"ancestor table has {anc.shape[0]} rows, "
                         f"fanouts {tuple(fanouts)} require "
                         f"{len(fanouts) - 1}")
    prev = np.zeros(k, dtype=np.int64)
    groups = 1
    for t, row in enumerate(anc):
        if row.min(initial=0) < 0:
            raise ValueError("ancestor ids must be >= 0")
        counts = np.bincount(row, minlength=int(row.max(initial=0)) + 1)
        if not (counts == counts[0]).all():
            raise ValueError(
                f"ancestor row {t} must group blocks equally for a "
                f"rectangular mesh; got sizes {counts.tolist()}")
        n_groups = len(counts)
        if fanouts is not None:
            groups *= int(fanouts[t])
            if n_groups != groups:
                raise ValueError(
                    f"ancestor row {t} has {n_groups} groups, "
                    f"fanouts {tuple(fanouts)} require {groups}")
        # nested: a depth-(t+1) group never straddles depth-t groups
        for gid in range(n_groups):
            if len(np.unique(prev[row == gid])) > 1:
                raise ValueError(
                    f"ancestor row {t} group {gid} straddles row "
                    f"{t - 1} groups — the table must be nested")
        prev = row
    return anc


def scale_to_load(topo: Topology, n: float,
                  headroom: float = 1.2) -> Topology:
    """Scale memory capacities so the total memory is ``headroom * n``.

    The paper's Table III specs are *relative* units.  With headroom 1.2 the
    implied tw(fast)/tw(slow) ratios of Table III's last column are
    reproduced exactly (9.4 for |F|=k/12, 11.5 for |F|=k/6 at fs=16).
    """
    u = headroom * n / topo.total_memory
    return Topology(tuple(PU(p.speed, p.memory * u, p.name)
                          for p in topo.pus), topo.fanouts)


# Table III of the paper: (speed, memory) of fast PUs per experiment step.
TABLE_III_FAST_SPECS: tuple[tuple[float, float], ...] = (
    (1.0, 2.0),     # exp 1 — homogeneous
    (2.0, 3.2),     # exp 2
    (4.0, 5.2),     # exp 3
    (8.0, 8.5),     # exp 4
    (16.0, 13.8),   # exp 5
)
