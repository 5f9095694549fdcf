"""Pluggable partition cost models (the objective layer): host NumPy
copied from ``src/repro/core/costmodel.py`` and bit-equal to it.

A :class:`CostModel` prices a partition of a graph over a k-PU tree
machine as per-PU modeled compute (Algorithm-1 speeds x block weight) plus
per-level weighted *deduplicated* receive volume:

  * :class:`CutCost` — the summed lambda-cut, ``metrics.tree_objective``;
  * :class:`BottleneckCost` — the process-mapping bottleneck (makespan):
    the *max* over PUs of modeled compute + weighted receive volume.

``cost_model_for`` resolves ``objective="cut"|"bottleneck"`` into a model
instance.  The port's drift policy (``replan_policy``) prices every served
matrix update with one.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..sparse.graph import Graph
from . import metrics
from .topology import Topology


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Prices a partition over a tree machine.

    ``lams``    — (h,) per-tree-level comm weights (``None``: the shared
                  default ladder, ``metrics.resolve_lams``);
    ``speeds``  — (k,) Algorithm-1 PU speeds (``None``: homogeneous);
    ``c_comp``  — modeled compute cost of one weight unit on a unit-speed
                  PU, in units of one innermost-level halo word
                  (``lams[0]``); the compute/comm exchange rate a
                  measured machine model calibrates.

    ``price(g, part, anc)`` is the scalar objective refinement minimizes;
    ``per_pu(g, part, anc)`` the per-PU compute/comm breakdown
    (``metrics.per_pu_model_costs``) every model exposes uniformly.
    """

    lams: tuple | None = None
    speeds: tuple | None = None
    c_comp: float = 1.0

    kind = "?"      # class attribute, overridden per concrete model

    def resolve(self, h: int) -> tuple:
        """(h,) per-level weights for a depth-h ancestor table."""
        return tuple(metrics.resolve_lams(self.lams, h))

    def price(self, g: Graph, part: np.ndarray, anc: np.ndarray) -> float:
        raise NotImplementedError

    def per_pu(self, g: Graph, part: np.ndarray,
               anc: np.ndarray) -> dict:
        """Per-PU modeled compute/comm split (shared across models — the
        cut model reports the same breakdown it just doesn't bound by)."""
        return metrics.per_pu_model_costs(g, part, anc, lams=self.lams,
                                          speeds=self.speeds,
                                          c_comp=self.c_comp)

    def summary(self, g: Graph, part: np.ndarray,
                anc: np.ndarray) -> dict:
        """JSON-friendly price + breakdown (what benchmarks and
        ``SolverService.static_cost`` report)."""
        anc = np.atleast_2d(np.asarray(anc))
        pp = self.per_pu(g, part, anc)
        total = pp["total"]
        return {
            "objective": self.kind,
            "price": self.price(g, part, anc),
            "makespan": float(total.max(initial=0.0)),
            "critical_pu": int(total.argmax()) if len(total) else 0,
            "per_pu_compute": pp["compute"].tolist(),
            "per_pu_comm": pp["comm"].tolist(),
            "max_comm_volume_by_level": [int(v.max(initial=0))
                                         for v in pp["comm_by_level"]],
            "lams": list(self.resolve(anc.shape[0] + 1)),
            "c_comp": float(self.c_comp),
        }


@dataclasses.dataclass(frozen=True)
class CutCost(CostModel):
    """The summed lambda-weighted tree cut — the pre-costmodel objective,
    bit-identical to ``metrics.tree_objective`` (``speeds``/``c_comp``
    only affect the informational ``per_pu`` breakdown, never the
    price)."""

    kind = "cut"

    def price(self, g: Graph, part: np.ndarray, anc: np.ndarray) -> float:
        anc = np.atleast_2d(np.asarray(anc))
        if anc.shape[0] == 0:               # flat machine: plain edge cut
            return metrics.edge_cut(g, part) * float(self.resolve(1)[0])
        return metrics.tree_objective(g, part, anc,
                                      self.resolve(anc.shape[0] + 1))


@dataclasses.dataclass(frozen=True)
class BottleneckCost(CostModel):
    """max over PUs of modeled compute + per-level weighted deduplicated
    receive volume (``metrics.bottleneck_objective``)."""

    kind = "bottleneck"

    def price(self, g: Graph, part: np.ndarray, anc: np.ndarray) -> float:
        return metrics.bottleneck_objective(g, part, anc, lams=self.lams,
                                            speeds=self.speeds,
                                            c_comp=self.c_comp)


COST_MODELS: dict[str, type[CostModel]] = {
    "cut": CutCost,
    "bottleneck": BottleneckCost,
}


def cost_model_for(objective: str | CostModel = "cut",
                   topo: Topology | None = None, lams=None,
                   c_comp: float = 1.0) -> CostModel:
    """Resolve the API-level ``objective=`` argument into a model.

    A :class:`CostModel` instance passes through unchanged (calibrated
    models); a name constructs the registered class with speeds from
    ``topo`` and the given per-level weights."""
    if isinstance(objective, CostModel):
        return objective
    cls = COST_MODELS.get(objective)
    if cls is None:
        raise ValueError(f"unknown objective {objective!r}; choose from "
                         f"{sorted(COST_MODELS)} or pass a CostModel")
    return cls(lams=None if lams is None else
               tuple(float(x) for x in np.atleast_1d(lams)),
               speeds=None if topo is None else tuple(topo.speeds),
               c_comp=float(c_comp))
