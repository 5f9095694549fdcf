"""Drift policy for incremental replanning: host NumPy copied from
``src/repro/core/replan_policy.py`` and bit-equal to it.

Delta patching (:mod:`repro_torch.sparse.replan`) keeps the *partition*
frozen while the graph mutates, so plan quality decays over time: edges
accumulate across block boundaries (the cost-model objective grows) and
blocks drift apart in work (imbalance grows).  The :class:`DriftMonitor`
watches both against the last full partition's baseline and decides,
after every delta, whether a full repartition (plus solver-state
migration, :func:`repro_torch.sparse.replan.migrate_state`) beats
continuing to patch.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .costmodel import CostModel, cost_model_for


@dataclasses.dataclass(frozen=True)
class DriftPolicy:
    """Thresholds for triggering a full repartition.

    ``objective``           — the cost model the drift is priced with
                              ("cut" | "bottleneck" | a CostModel);
    ``lams`` / ``c_comp``   — forwarded to :func:`cost_model_for`;
    ``max_objective_ratio`` — repartition when the modeled objective
                              exceeds baseline * ratio;
    ``max_imbalance_ratio`` — repartition when work imbalance (max/mean
                              of per-PU rows + nnz) exceeds baseline
                              imbalance * ratio;
    ``max_deltas``          — unconditional repartition after this many
                              observed deltas (None: never by count).
    """
    objective: object = "cut"
    lams: object = None
    c_comp: float = 1.0
    max_objective_ratio: float = 1.5
    max_imbalance_ratio: float = 1.25
    max_deltas: int | None = None

    def model(self) -> CostModel:
        return cost_model_for(self.objective, lams=self.lams,
                              c_comp=self.c_comp)


@dataclasses.dataclass(frozen=True)
class DriftDecision:
    """One :meth:`DriftMonitor.observe` verdict."""
    repartition: bool
    reason: str | None
    objective: float
    objective_ratio: float
    imbalance: float
    imbalance_ratio: float
    deltas_since_full: int


def _work_imbalance(g, part: np.ndarray, k: int) -> float:
    """max/mean of per-PU work, modeled as rows + nnz (vertex count plus
    degree sum) — the quantity a frozen partition lets drift."""
    part = np.asarray(part)
    work = (np.bincount(part, minlength=k).astype(np.float64)
            + np.bincount(part, weights=g.degrees.astype(np.float64),
                          minlength=k))
    mean = work.mean()
    return float(work.max() / mean) if mean > 0 else 1.0


class DriftMonitor:
    """Tracks plan-quality drift of a patched plan vs its last full plan.

    ``reset(g, part, anc)`` records the baseline right after a full
    (re)partition; ``observe(g, part, anc)`` prices the mutated graph on
    the *same* partition and returns a :class:`DriftDecision`.  The
    caller owns acting on it —
    :class:`repro_torch.launch.serve.SolverService` rebuilds the operator
    and migrates solver state when
    ``decision.repartition`` is True, then calls ``reset`` again.
    """

    def __init__(self, policy: DriftPolicy | None = None):
        self.policy = policy or DriftPolicy()
        self._model = self.policy.model()
        self._base_objective: float | None = None
        self._base_imbalance: float | None = None
        self.deltas_since_full = 0

    @property
    def baseline(self) -> tuple[float, float] | None:
        if self._base_objective is None:
            return None
        return self._base_objective, self._base_imbalance

    def _measure(self, g, part, anc) -> tuple[float, float]:
        part = np.asarray(part)
        anc = np.atleast_2d(np.asarray(anc)) if anc is not None \
            else np.zeros((0, int(part.max()) + 1), dtype=np.int64)
        k = anc.shape[1] if anc.size else int(part.max()) + 1
        return (float(self._model.price(g, part, anc)),
                _work_imbalance(g, part, k))

    def reset(self, g, part, anc=None) -> None:
        """Record the post-repartition baseline."""
        self._base_objective, self._base_imbalance = \
            self._measure(g, part, anc)
        self.deltas_since_full = 0

    def observe(self, g, part, anc=None) -> DriftDecision:
        """Price one post-delta state; trips when a threshold is crossed.

        Must be preceded by :meth:`reset`; observing without a baseline
        raises rather than silently treating the first delta as one.
        """
        if self._base_objective is None:
            raise RuntimeError("DriftMonitor.observe before reset()")
        obj, imb = self._measure(g, part, anc)
        self.deltas_since_full += 1
        if self._base_objective > 0:
            obj_ratio = obj / self._base_objective
        else:
            obj_ratio = float("inf") if obj > 0 else 1.0
        imb_ratio = imb / self._base_imbalance \
            if self._base_imbalance > 0 else 1.0
        pol = self.policy
        reason = None
        if obj_ratio > pol.max_objective_ratio:
            reason = (f"objective {obj:.6g} > {pol.max_objective_ratio:g}x "
                      f"baseline {self._base_objective:.6g}")
        elif imb_ratio > pol.max_imbalance_ratio:
            reason = (f"imbalance {imb:.4g} > {pol.max_imbalance_ratio:g}x "
                      f"baseline {self._base_imbalance:.4g}")
        elif pol.max_deltas is not None \
                and self.deltas_since_full >= pol.max_deltas:
            reason = f"{self.deltas_since_full} deltas since full plan"
        return DriftDecision(
            repartition=reason is not None, reason=reason,
            objective=obj, objective_ratio=float(obj_ratio),
            imbalance=imb, imbalance_ratio=float(imb_ratio),
            deltas_since_full=self.deltas_since_full)
