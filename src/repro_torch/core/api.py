"""Unified partitioning API — the black-box phase-2 interface of the paper,
ported from ``src/repro/core/api.py``.

``partition(graph, topology, method)`` runs the two-stage LDHT pipeline:
  stage 1: Algorithm 1 -> target block sizes tw (optimal for Eq. 2 + 3);
  stage 2: the chosen partitioner minimizes the cut (Eq. 1) under tw.

Methods (paper nomenclature):
  geoKM    — balanced k-means                      (Geographer)
  geoRef   — geoKM + multilevel pairwise-FM        (Geographer-R)
  geoHier  — hierarchical balanced k-means + refinement (Sec. V)
  sfc      — Morton space-filling curve            (zSFC analogue)
  rcb      — recursive coordinate bisection        (zRCB analogue)
  rib      — recursive inertial bisection          (zRIB analogue)
  sfcRef   — sfc + multilevel FM refinement        (ParMetisGeom-like:
             geometric initial partition + combinatorial refinement)
  greedyRef— BFS-greedy growing + multilevel FM    (ParMetisGraph-like:
             combinatorial initial partition + combinatorial refinement)

Where the work runs: the k-means loops of geoKM / geoRef / geoHier (with
the ``pdist`` kernel under ``use_pallas=True``) and the Morton codes of
sfc / sfcRef run on ``device`` (default the card; without one the entry
points raise).  Everything else — the multilevel FM refinement, RCB, RIB,
greedy growing, the tree-aware sweeps and the metrics — is host NumPy
copied from the reference and bit-equal to it, so from the same initial
partition every method refines to the same bytes.

Tree-aware mode (``pods=`` / ``tree=`` / ``fanouts=``): the flat
objective (Eq. 1) ignores that on a hierarchical machine each cut edge
pays the link latency of its LCA level (``sparse.distributed``
``comm='hier'``).  :func:`partition_tree` runs the whole pipeline
recursively down the ``fanouts`` tree, WindGP-style: at every level the
load is water-filled over the subtree aggregates and the graph is
partitioned at that granularity; a per-level KL sweep then regroups
equal-spec blocks on the quotient graph
(``refinement.refine_tree_assignment``) and a weighted FM pass refines
against the tree objective (a cut edge costs ``lams[LCA level]``,
``topology.LinkCosts``).  :func:`partition_hier` is the two-level
(``pods=``) instance.  The returned :class:`HierPartition` carries the
ancestor table the tree runtime consumes directly
(``make_operator(..., part=hier_partition)``).

``validate=`` runs the partition verifier (``repro_torch.analysis``,
PART0xx) on the result of :func:`partition_tree` / :func:`partition_hier`;
``None`` defers to ``REPRO_VALIDATE``, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device
from ..analysis import validate_requested, verify_partition
from ..sparse.graph import Graph
from .balanced_kmeans import (partition_balanced_kmeans,
                              partition_hierarchical_kmeans)
from .block_sizes import target_block_sizes, waterfill
from .metrics import summarize, summarize_hier, summarize_tree
from .multilevel import partition_multilevel_refine
from .rcb import partition_rcb
from .refinement import (quotient_graph, refine_partition,
                         refine_pod_assignment, refine_tree_assignment)
from .rib import partition_rib
from .sfc import partition_sfc
from .topology import Topology, normalize_pod_of, normalize_tree_of


def _greedy_growing(g: Graph, tw: np.ndarray, seed: int = 0) -> np.ndarray:
    """Combinatorial initial partition: multi-source BFS region growing with
    heterogeneous capacities (GGP — the classic Metis-style initializer).

    Blocks with a zero rounded target get no seed and receive no orphans
    — on fully saturated topologies a zero-target block must stay empty,
    not grab a seed vertex another block needs."""
    rng = np.random.default_rng(seed)
    k = len(tw)
    want = np.round(tw).astype(np.int64)
    want[np.argmax(want)] += g.n - want.sum()
    part = -np.ones(g.n, dtype=np.int32)
    active = np.flatnonzero(want > 0)
    # seeds: spread via random picks (BFS-farthest would be better; this is
    # the baseline tool, quality is allowed to be baseline-ish)
    seeds = np.full(k, -1, dtype=np.int64)
    seeds[active] = rng.choice(g.n, size=len(active), replace=False)
    from collections import deque
    queues = [deque([int(seeds[b])] if seeds[b] >= 0 else [])
              for b in range(k)]
    sizes = np.zeros(k, dtype=np.int64)
    for b in active:
        s = seeds[b]
        if part[s] == -1:
            part[s] = b
            sizes[b] += 1
    active_mask = want > 0
    while True:
        progressed_any = False
        for b in np.argsort(sizes / np.maximum(want, 1)):
            if sizes[b] >= want[b] or not queues[b]:
                continue
            progressed = False
            while queues[b] and not progressed:
                v = queues[b].popleft()
                for u in g.indices[g.indptr[v]:g.indptr[v + 1]]:
                    if part[u] == -1 and sizes[b] < want[b]:
                        part[u] = b
                        sizes[b] += 1
                        queues[b].append(int(u))
                        progressed = True
            progressed_any = progressed_any or progressed
        if not progressed_any:
            break
    # orphans (disconnected leftovers): most underloaded *active* block —
    # never a zero-target one
    for v in np.nonzero(part == -1)[0]:
        ratio = np.where(active_mask, sizes / np.maximum(want, 1), np.inf)
        b = int(np.argmin(ratio))
        part[v] = b
        sizes[b] += 1
    return part


def _dispatch(g: Graph, method: str, tw: np.ndarray, mems: np.ndarray,
              fanouts: tuple[int, ...], seed: int, eps: float,
              device: torch.device, **kw) -> np.ndarray:
    """Stage-2 method dispatch shared by the flat and hierarchical
    pipelines; ``tw``/``mems``/``fanouts`` describe whatever block level
    is being partitioned (PUs, or pods for the hier top level).  The
    k-means and Morton stages run on ``device``; ``kw`` (``use_pallas``,
    ``iters``, ...) goes to the k-means."""
    if method == "geoKM":
        part = partition_balanced_kmeans(g, tw, seed=seed, device=device,
                                         **kw)
    elif method == "geoRef":
        part = partition_balanced_kmeans(g, tw, seed=seed, device=device,
                                         **kw)
        part = partition_multilevel_refine(g, part, tw, mems=mems, eps=eps,
                                           seed=seed)
    elif method == "geoHier":
        part = partition_hierarchical_kmeans(g, tw, fanouts, seed=seed,
                                             device=device, **kw)
        part = partition_multilevel_refine(g, part, tw, mems=mems, eps=eps,
                                           seed=seed)
    elif method == "sfc":
        part = partition_sfc(g, tw, seed=seed, device=device)
    elif method == "rcb":
        part = partition_rcb(g, tw, seed=seed)
    elif method == "rib":
        part = partition_rib(g, tw, seed=seed)
    elif method == "sfcRef":
        part = partition_sfc(g, tw, seed=seed, device=device)
        part = partition_multilevel_refine(g, part, tw, mems=mems, eps=eps,
                                           seed=seed)
    elif method == "greedyRef":
        part = _greedy_growing(g, tw, seed=seed)
        part = partition_multilevel_refine(g, part, tw, mems=mems, eps=eps,
                                           seed=seed)
    else:
        raise ValueError(f"unknown method {method!r}")
    return np.asarray(part, dtype=np.int32)


def partition(g: Graph, topo: Topology, method: str = "geoRef",
              tw: np.ndarray | None = None, seed: int = 0,
              eps: float = 0.03, pods=None, lam: float | None = None,
              fanouts=None, tree=None, lams=None, objective: str = "cut",
              device=None, **kw) -> tuple[np.ndarray, np.ndarray]:
    """Two-stage LDHT solve on ``device`` (default the card).  Returns
    (part, tw) as host arrays.

    With ``pods`` (pod count or explicit (k,) pod-of-PU array) the
    pipeline runs hierarchically via :func:`partition_hier`; with
    ``fanouts``/``tree`` it runs the arbitrary-depth recursion
    (:func:`partition_tree`).  Use those functions directly when you
    also need the resulting ancestor table (e.g. to feed
    ``sparse.distributed.build_plan_tree``).

    ``objective="bottleneck"`` appends a makespan refinement stage
    (:func:`core.refinement.refine_partition` bottleneck mode — max over
    PUs of modeled compute + weighted deduplicated receive volume,
    ``core.costmodel.BottleneckCost``); ``"cut"`` (default) is the
    summed lambda-cut pipeline, bit-identical to before the objective
    became selectable."""
    device = resolve_device(device)
    if pods is not None:
        res = partition_hier(g, topo, method, pods=pods, tw=tw, seed=seed,
                             eps=eps, lam=lam, objective=objective,
                             device=device, **kw)
        return res.part, res.tw
    if fanouts is not None or tree is not None:
        res = partition_tree(g, topo, method, fanouts=fanouts, tree=tree,
                             tw=tw, seed=seed, eps=eps, lams=lams,
                             objective=objective, device=device, **kw)
        return res.part, res.tw
    if tw is None:
        tw = target_block_sizes(g.n, topo)
    part = _dispatch(g, method, tw, topo.memories, topo.fanouts, seed, eps,
                     device, **kw)
    if objective == "bottleneck":
        part = refine_partition(g, part, tw, mems=topo.memories, eps=eps,
                                objective="bottleneck", speeds=topo.speeds)
    elif objective != "cut":
        raise ValueError(f"unknown objective {objective!r}")
    return part, tw


@dataclasses.dataclass
class HierPartition:
    """Tree-aware pipeline output: the partition *and* the co-optimized
    ancestor table that the tree runtime consumes.

    ``anc`` is the (h-1, k) ancestor table (``topology.normalize_tree_of``
    form); ``pod_of``/``lam`` are its two-level views (top grouping and
    outermost/innermost weight ratio), kept as the two-level pod API.  After
    the per-level sweep the table need not be contiguous —
    ``sparse.distributed.build_plan_tree`` relabels blocks tree-major
    internally (``block_map``), and ``sparse.make_operator(...,
    backend='dist_hier', part=<this>)`` unpacks everything directly.
    """

    part: np.ndarray        # (n,) vertex -> block (= PU)
    tw: np.ndarray          # (k,) Algorithm-1 targets, PU order
    pod_of: np.ndarray      # (k,) block -> top-level group (pod)
    lam: float              # outer/inner link-cost ratio of the objective
    anc: np.ndarray = None  # (h-1, k) ancestor table; pod_of == anc[0]
    lams: tuple = None      # (h,) per-level objective weights
    fanouts: tuple = ()     # (k_1, ..., k_h) of the partitioned tree
    objective: str = "cut"  # which cost model refinement minimized
    # the ``analysis.Report`` of the ``validate=`` pass (None when
    # unverified).  A class attribute, not a field: equality and
    # ``dataclasses.replace`` never see it
    verify_report = None

    def __post_init__(self):
        if self.anc is None:
            self.anc = np.asarray(self.pod_of)[None, :]
        self.anc = np.asarray(self.anc)
        if not self.fanouts:
            self.fanouts = _infer_fanouts(self.anc, self.k)
        if self.lams is None:
            # geometric ladder from 1 to lam across the table's depth —
            # (1, lam) at h == 2, consistent with the anc depth so the
            # tree metrics accept (lams, anc) pairs straight off this
            h = len(self.fanouts)
            self.lams = ((1.0,) if h <= 1 else
                         tuple(float(self.lam) ** (l / (h - 1))
                               for l in range(h)))

    @property
    def k(self) -> int:
        return len(self.tw)

    @property
    def h(self) -> int:
        return len(self.fanouts)

    @property
    def n_pods(self) -> int:
        return int(self.pod_of.max()) + 1


def _spec_groups(topo: Topology) -> np.ndarray:
    """(k,) group id per PU: PUs are interchangeable (their blocks may
    trade pod slots) iff they share (speed, memory)."""
    spec = np.stack([topo.speeds, topo.memories], axis=1)
    _, groups = np.unique(spec, axis=0, return_inverse=True)
    return groups


def pod_assignment_for(g: Graph, part: np.ndarray, topo: Topology,
                       pods) -> np.ndarray:
    """Partition-derived pod assignment for an existing (flat) partition:
    start from ``Topology.pod_assignment`` and KL-sweep equal-spec blocks
    on the quotient graph (``refinement.refine_pod_assignment``) so the
    heaviest block pairs share pods.  The inter-pod cut never increases
    versus the contiguous grouping; feed the result to
    ``build_plan_hier``/``make_operator`` as the explicit pod array."""
    pod_of = normalize_pod_of(pods, topo.k)
    pairs, w = quotient_graph(g, np.asarray(part, dtype=np.int32), topo.k)
    return refine_pod_assignment(pairs, w, pod_of,
                                 groups=_spec_groups(topo))


def tree_assignment_for(g: Graph, part: np.ndarray, topo: Topology,
                        tree=None, fanouts=None) -> np.ndarray:
    """Partition-derived ancestor table for an existing (flat) partition
    — the tree generalization of :func:`pod_assignment_for`: start from
    the canonical nested grouping and sweep equal-spec blocks level by
    level (``refinement.refine_tree_assignment``) so the heaviest block
    pairs meet at the deepest (cheapest) tree level.  Feed the result to
    ``build_plan_tree``/``make_operator`` as the explicit table."""
    anc = normalize_tree_of(tree, topo.k,
                            fanouts if (fanouts is not None or
                                        tree is not None)
                            else topo.fanouts)
    pairs, w = quotient_graph(g, np.asarray(part, dtype=np.int32), topo.k)
    return refine_tree_assignment(pairs, w, anc, groups=_spec_groups(topo))


def _infer_fanouts(anc: np.ndarray, k: int) -> tuple[int, ...]:
    """(k_1, ..., k_h) implied by a validated nested ancestor table."""
    counts = [int(np.asarray(row).max()) + 1 for row in anc] + [k]
    prev = 1
    fanouts = []
    for c in counts:
        fanouts.append(c // prev)
        prev = c
    return tuple(fanouts)


def _maybe_verify_partition(res: "HierPartition", n: int,
                            validate: bool | None) -> "HierPartition":
    """Structural verification of a partition result
    (``repro_torch.analysis`` PART0xx).  ``validate=None`` defers to
    ``REPRO_VALIDATE`` (on in the test suite via conftest).  The report,
    ``info["seconds"]`` its host time, is kept as ``res.verify_report``."""
    if validate_requested(validate):
        t0 = time.perf_counter()
        rep = verify_partition(res, n)
        rep.info["seconds"] = time.perf_counter() - t0
        rep.raise_for_errors()
        res.verify_report = rep
    return res


def partition_tree(g: Graph, topo: Topology, method: str = "geoRef",
                   fanouts=None, tree=None, tw: np.ndarray | None = None,
                   seed: int = 0, eps: float = 0.03, lams=None,
                   refine: bool = True, validate: bool | None = None,
                   objective: str = "cut", c_comp: float = 1.0,
                   device=None, **kw) -> HierPartition:
    """Tree-aware recursive pipeline (the tentpole of the tree runtime):

      A. the load is water-filled over the current level's subtree
         aggregates (tree-aware Algorithm 1: summed speeds under summed
         memories — ``block_sizes.waterfill``) and the graph is
         partitioned at that granularity with the chosen method — the
         future level-crossing cut is minimized directly;
      B. recursion: each subtree's subgraph is partitioned among its
         children the same way, down to the leaves — the realized
         subtree load is water-filled over the children, so a saturated
         member's overflow is absorbed by its siblings (no stage-B
         rescale);
      C. a per-level KL sweep regroups equal-spec blocks on the quotient
         graph (``refinement.refine_tree_assignment``) — the
         partition-derived ancestor table;
      D. scheduled pairwise FM refines against the weighted tree
         objective (a cut edge costs ``lams[LCA level]``).

    ``tree`` accepts anything ``topology.normalize_tree_of`` does (pod
    count, pod array, ancestor table); default is the canonical table of
    ``fanouts`` (default ``topo.fanouts``).  ``lams`` defaults to the
    topology's link-cost ladder (``topo.link_costs(levels=h).lams``).
    At depth 2 every stage is the two-level pod pipeline (stages C/D
    bit-identical; stages A/B replace the target rescale with the
    per-subtree water-fill).

    ``objective="bottleneck"`` adds a stage E after the (unchanged) cut
    FM: makespan refinement over the incremental volume-gain tracker
    (``refinement.refine_partition(objective='bottleneck')``,
    Algorithm-1 ``topo.speeds`` as the compute model; ``c_comp`` is the
    modeled compute cost per weight unit in halo-word units —
    ``core.costmodel.CostModel.c_comp``) — the critical PU sheds
    load/halo first.  ``"cut"`` leaves the pipeline bit-identical to
    before the objective became selectable.
    """
    device = resolve_device(device)
    if objective not in ("cut", "bottleneck"):
        raise ValueError(f"unknown objective {objective!r}")
    if tw is not None:
        tw = np.asarray(tw, dtype=np.float64)
    anc = normalize_tree_of(tree, topo.k,
                            fanouts if (fanouts is not None or
                                        tree is not None)
                            else topo.fanouts)
    h0 = anc.shape[0] + 1
    # drop trivial levels: a row that does not strictly refine the one
    # above (fanout 1) or that already separates every leaf (identity —
    # its boundary coincides with the leaf level) adds no block pairs
    kept, prev = [], 1
    for t in range(anc.shape[0]):
        c = int(anc[t].max()) + 1
        if prev < c < topo.k:
            kept.append(t)
            prev = c
    anc = anc[kept]
    fanouts = _infer_fanouts(anc, topo.k)
    h = len(fanouts)
    if lams is None:
        lams = tuple(topo.link_costs(levels=max(h, 2)).lams[:h])
    else:
        lams = tuple(float(x) for x in np.atleast_1d(lams))
        if len(lams) == h0 and h != h0:
            # keep the weights of the surviving levels (row t prices
            # level h0-1-t; the leaf level keeps lams[0])
            lams = tuple([lams[0]] + [lams[h0 - 1 - t]
                                      for t in reversed(kept)])
        elif len(lams) != h:
            raise ValueError(f"need {h} per-level weights for the "
                             f"{fanouts} tree, got {len(lams)}")
    lam = lams[-1] / lams[0]

    if anc.shape[0] == 0:                    # flat tree: no boundary to price
        if tw is None:
            tw = target_block_sizes(g.n, topo)
        part = _dispatch(g, method, tw, topo.memories, topo.fanouts, seed,
                         eps, device, **kw)
        if refine and objective == "bottleneck":
            part = refine_partition(g, part, tw, mems=topo.memories,
                                    eps=eps, objective="bottleneck",
                                    speeds=topo.speeds, c_comp=c_comp)
        return _maybe_verify_partition(
            HierPartition(part=part, tw=tw,
                          pod_of=np.zeros(topo.k, dtype=np.int64),
                          lam=lam, anc=np.zeros((0, topo.k), np.int64),
                          lams=(lams[0],), fanouts=(topo.k,),
                          objective=objective),
            g.n, validate)

    # A/B. recurse down the tree: water-fill the level's aggregates, then
    # partition at that granularity and descend into each subtree
    speeds, mems = topo.speeds, topo.memories
    wleaf = speeds if tw is None else tw     # water-fill preference weights
    part = np.empty(g.n, dtype=np.int32)
    tw_out = np.zeros(topo.k, dtype=np.float64)

    def rec(sub: Graph, ids: np.ndarray, pus: np.ndarray,
            anc_sub: np.ndarray, seed_l: int) -> None:
        if len(pus) == 1:
            part[ids] = pus[0]
            tw_out[pus[0]] = sub.n
            return
        if anc_sub.shape[0] == 0:            # leaf level: PUs directly
            tw_p = waterfill(sub.n, wleaf[pus], mems[pus], strict=False)
            tw_out[pus] = tw_p
            sub_part = _dispatch(sub, method, tw_p, mems[pus],
                                 (len(pus),), seed_l, eps, device, **kw)
            part[ids] = pus[sub_part]
            return
        top = anc_sub[0]
        gids = np.unique(top)
        wg = np.array([wleaf[pus[top == gi]].sum() for gi in gids])
        cg = np.array([mems[pus[top == gi]].sum() for gi in gids])
        tw_g = waterfill(sub.n, wg, cg, strict=False)
        vgrp = _dispatch(sub, method, tw_g, cg, (len(gids),), seed_l, eps,
                         device, **kw)
        for i, gi in enumerate(gids):
            mask = vgrp == i
            if not mask.any():
                continue
            ss, sids = sub.subgraph(mask)
            rec(ss, ids[sids], pus[top == gi], anc_sub[1:, top == gi],
                seed_l + i + 1)

    rec(g, np.arange(g.n), np.arange(topo.k), anc, seed)
    tw = tw_out if tw is None else tw

    # C. per-level sweep: co-optimize the ancestor table with the
    # realized partition (equal-spec blocks may trade slots)
    if refine:
        pairs, w = quotient_graph(g, part, topo.k)
        anc = refine_tree_assignment(pairs, w, anc,
                                     groups=_spec_groups(topo))
        # D. vertex-level FM against the weighted tree objective
        part = refine_partition(g, part, tw, mems=mems, eps=eps,
                                anc=anc, lams=lams)
        # E. (bottleneck mode) makespan polish from the cut-refined
        # start: drain modeled compute + dedup halo off the critical PU
        if objective == "bottleneck":
            part = refine_partition(g, part, tw, mems=mems, eps=eps,
                                    anc=anc, lams=lams,
                                    objective="bottleneck", speeds=speeds,
                                    c_comp=c_comp)
    return _maybe_verify_partition(
        HierPartition(part=part, tw=tw, pod_of=anc[0], lam=lam,
                      anc=anc, lams=lams, fanouts=fanouts,
                      objective=objective), g.n, validate)


def partition_hier(g: Graph, topo: Topology, method: str = "geoRef",
                   pods=2, tw: np.ndarray | None = None, seed: int = 0,
                   eps: float = 0.03, lam: float | None = None,
                   refine: bool = True, objective: str = "cut",
                   device=None, **kw) -> HierPartition:
    """Pod-aware two-level pipeline — the ``h == 2`` instance of
    :func:`partition_tree` (``pods`` = pod count or explicit (k,) pod
    array; stages C/D are bit-identical to the pod path, stages A/B
    water-fill per subtree instead of rescaling the global targets).

    ``lam`` defaults to the topology's link-cost ratio
    (``topo.link_costs().lam`` — the hier round-latency model).
    """
    if lam is None:
        lam = topo.link_costs().lam
    pod_of = normalize_pod_of(pods, topo.k)
    res = partition_tree(g, topo, method, tree=pod_of[None, :], tw=tw,
                         seed=seed, eps=eps, lams=(1.0, float(lam)),
                         refine=refine, objective=objective, device=device,
                         **kw)
    if res.anc.shape[0] == 0:                # pods == 1 degenerates
        return HierPartition(part=res.part, tw=res.tw, pod_of=pod_of,
                             lam=lam, objective=objective)
    return res


METHODS = ("geoKM", "geoRef", "geoHier", "sfc", "rcb", "rib", "sfcRef",
           "greedyRef")


def evaluate(g: Graph, topo: Topology, methods=METHODS, seed: int = 0,
             pods=None, lam: float | None = None, fanouts=None,
             tree=None, lams=None, objective: str = "cut",
             verbose: bool = True, device=None) -> dict[str, dict]:
    """Run all methods; return {method: metrics+time} (Table IV analogue).

    With ``pods`` each method runs the pod-aware pipeline
    (:func:`partition_hier`) and the metrics include the intra/inter-pod
    split plus the weighted two-level objective; with ``fanouts``/
    ``tree`` the arbitrary-depth pipeline (:func:`partition_tree`) with
    per-level splits and the tree objective.  ``objective`` selects the
    refinement cost model per method (the summaries always report both
    the summed cut and the bottleneck makespan).

    ``time_s`` is the host clock around each method; on the card it is
    read after a ``torch.cuda.synchronize()``, so the k-means loop's
    queued work is inside it."""
    device = resolve_device(device)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    out = {}
    tw = target_block_sizes(g.n, topo)
    tree_mode = fanouts is not None or tree is not None
    for m in methods:
        sync()
        t0 = time.perf_counter()
        if pods is not None:
            res = partition_hier(g, topo, m, pods=pods, tw=tw, seed=seed,
                                 lam=lam, objective=objective, device=device)
            part = res.part
            s = summarize_hier(g, part, topo, tw, res.pod_of, lam=res.lam)
        elif tree_mode:
            res = partition_tree(g, topo, m, fanouts=fanouts, tree=tree,
                                 tw=tw, seed=seed, lams=lams,
                                 objective=objective, device=device)
            part = res.part
            s = summarize_tree(g, part, topo, tw, res.anc, lams=res.lams)
        else:
            part, _ = partition(g, topo, m, tw=tw, seed=seed,
                                objective=objective, device=device)
            s = summarize(g, part, topo, tw)
        sync()
        dt = time.perf_counter() - t0
        s["time_s"] = dt
        out[m] = s
        if verbose:
            line = (f"  {m:10s} cut={s['cut']:9.0f}"
                    f" maxCV={s['max_comm_volume']:6d}"
                    f" imb={s['imbalance']:.3f}"
                    f" memViol={s['mem_violations']}")
            if pods is not None:
                line += (f" interCV={s['comm_volume_inter']:6d}"
                         f" obj={s['two_level_objective']:9.0f}")
            elif tree_mode:
                line += (f" outerCV={s['comm_volume_by_level'][-1]:6d}"
                         f" obj={s['tree_objective']:9.0f}")
            print(line + f" t={dt:6.2f}s")
    return out
