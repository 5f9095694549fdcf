"""Partitioning entry point — the port of ``src/repro/core/api.py`` (flat
path).

``partition(graph, topology, method)`` runs the two-stage LDHT pipeline:
  stage 1: Algorithm 1 -> target block sizes tw (optimal for Eq. 2 + 3);
  stage 2: the chosen partitioner minimizes the cut (Eq. 1) under tw.

This slice ports stage 2 for ``geoKM`` (balanced k-means, Geographer's
phase 1).  The other methods, the tree-aware modes (``pods=``,
``fanouts=``, ``tree=``) and ``objective="bottleneck"`` raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import numpy as np

from ..device import resolve_device
from ..sparse.graph import Graph
from .balanced_kmeans import partition_balanced_kmeans
from .block_sizes import target_block_sizes
from .topology import Topology

METHODS = ("geoKM", "geoRef", "geoHier", "sfc", "rcb", "rib", "sfcRef",
           "greedyRef")
_LATER = "ROADMAP.md queue 1 item 8 (partition path, core/)"


def _dispatch(g: Graph, method: str, tw: np.ndarray, seed: int, device,
              **kw) -> np.ndarray:
    """Stage-2 method dispatch for the block sizes ``tw``."""
    if method == "geoKM":
        part = partition_balanced_kmeans(g, tw, seed=seed, device=device,
                                         **kw)
    elif method in METHODS:
        raise NotImplementedError(
            f"method {method!r} is not ported yet; see {_LATER}")
    else:
        raise ValueError(f"unknown method {method!r}")
    return np.asarray(part, dtype=np.int32)


def partition(g: Graph, topo: Topology, method: str = "geoRef",
              tw: np.ndarray | None = None, seed: int = 0,
              eps: float = 0.03, pods=None, lam: float | None = None,
              fanouts=None, tree=None, lams=None, objective: str = "cut",
              device=None, **kw) -> tuple[np.ndarray, np.ndarray]:
    """Two-stage LDHT solve on ``device`` (default the card).  Returns
    (part, tw) as host arrays.  The signature and defaults are the
    reference's; only the flat ``geoKM`` path runs in this slice."""
    device = resolve_device(device)
    if pods is not None or fanouts is not None or tree is not None \
            or lam is not None or lams is not None:
        raise NotImplementedError(
            "tree-aware partitioning (pods=/fanouts=/tree=/lam=/lams=) is "
            f"not ported yet; see {_LATER}")
    if objective == "bottleneck":
        raise NotImplementedError(
            f"objective='bottleneck' is not ported yet; see {_LATER}")
    if objective != "cut":
        raise ValueError(f"unknown objective {objective!r}")
    if tw is None:
        tw = target_block_sizes(g.n, topo)
    part = _dispatch(g, method, tw, seed, device, **kw)
    return part, tw
