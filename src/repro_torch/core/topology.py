"""Compute-system topology model for the LDHT problem (host NumPy, copied
from ``src/repro/core/topology.py``; bit-equal to it).  The pod, tree and
link-cost parts wait for the hierarchical slice (ROADMAP queue 1 item 8).

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
