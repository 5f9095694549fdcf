"""Algorithm 1 of the paper: optimal target block sizes for LDHT.

Given n (total unit-weight load), and k PUs with speeds c_s and memory caps
m_cap, compute target weights tw(b_i) that

    minimize  max_i tw(b_i) / c_s(p_i)           (Eq. 2)
    s.t.      tw(b_i) <= m_cap(p_i)              (Eq. 3)
              sum_i tw(b_i) = n

Greedy water-filling: sort PUs by decreasing c_s/m_cap; assign each its
proportional share of the *remaining* load, clamped to its memory.

  * ``waterfill`` / ``target_block_sizes`` — host NumPy, copied from
    ``src/repro/core/block_sizes.py`` and bit-equal to it.
  * ``target_block_sizes_torch`` — the tensor form of the reference's
    ``target_block_sizes_jax``: the closed form over all k+1 saturated
    prefixes, no data-dependent control flow.
"""
from __future__ import annotations

import numpy as np
import torch

from .topology import Topology


def waterfill(load: float, weights: np.ndarray, caps: np.ndarray,
              strict: bool = True) -> np.ndarray:
    """The Algorithm-1 water-fill core: split ``load`` proportionally to
    ``weights`` under per-unit ``caps``, greedily in decreasing
    weight/cap order (Lemma 1: the saturated units form a prefix).

    ``strict=False`` relaxes the feasibility check: an overfull load
    (``load > sum(caps)``) falls back to cap-ignoring proportional
    shares.
    """
    weights = np.asarray(weights, dtype=np.float64)
    caps = np.asarray(caps, dtype=np.float64)
    k = len(weights)
    if load > caps.sum() + 1e-12:
        if strict:
            raise ValueError(
                f"infeasible: load {load} exceeds total memory "
                f"{caps.sum()}")
        w = weights if weights.sum() > 0 else caps
        return w * (float(load) / w.sum())
    if weights.sum() <= 0:
        weights = caps                       # no preference: fill by cap
    order = np.argsort(-(weights / caps), kind="stable")  # Line 1
    tw = np.zeros(k, dtype=np.float64)
    j_load = float(load)                                 # Line 2
    j_speed = float(weights.sum())                       # Line 3
    for idx in order:                                    # Line 4
        des_w = weights[idx] * j_load / j_speed          # Line 5
        if des_w > caps[idx]:                            # Line 6
            tw[idx] = caps[idx]                          # Line 7  (saturated)
        else:
            tw[idx] = des_w                              # Line 10 (non-sat.)
        j_load -= tw[idx]                                # Line 11
        j_speed -= weights[idx]                          # Line 12
    return tw


def target_block_sizes(n: float, topo: Topology,
                       integral: bool = False) -> np.ndarray:
    """Algorithm 1 — returns tw in the ORIGINAL PU order.

    Args:
      n: total load (|V| of the application graph).
      topo: the compute topology (leaves only are used).
      integral: if True, round to integers that still sum to n (largest
        remainder method, respecting memory caps).
    """
    if not topo.feasible(n):
        raise ValueError(
            f"infeasible: load {n} exceeds total memory {topo.total_memory}")
    tw = waterfill(n, topo.speeds, topo.memories)
    if integral:
        tw = _round_preserving_sum(tw, int(round(n)), topo.memories)
    return tw


def _round_preserving_sum(tw: np.ndarray, total: int,
                          mems: np.ndarray) -> np.ndarray:
    """Largest-remainder rounding, keeping sum == total and tw <= m_cap."""
    base = np.floor(tw).astype(np.int64)
    rem = tw - base
    deficit = total - int(base.sum())
    # hand out +1 by largest remainder where memory allows
    order = np.argsort(-rem, kind="stable")
    out = base.astype(np.float64)
    i = 0
    while deficit > 0 and i < 4 * len(tw):
        idx = order[i % len(tw)]
        if out[idx] + 1 <= mems[idx] + 1e-9:
            out[idx] += 1
            deficit -= 1
        i += 1
    if deficit != 0:
        raise ValueError("could not round block sizes within memory caps")
    return out


def max_load_ratio(tw: np.ndarray, topo: Topology) -> float:
    """Objective (2): max_i tw(b_i)/c_s(p_i)."""
    return float(np.max(np.asarray(tw) / topo.speeds))


# ---------------------------------------------------------------------------
# Tensor version.  After sorting by c_s/m_cap desc, saturated PUs form a
# prefix (Lemma 1).  For a candidate prefix length s, the assignment is
#   tw_i = m_cap_i                   for i < s
#   tw_i = c_s_i * L_s / S_s         for i >= s
# where L_s = n - sum_{i<s} m_cap_i and S_s = sum_{i>=s} c_s_i.  The correct s
# is the smallest one for which no i >= s violates memory.  All k+1 prefixes
# are evaluated at once and the smallest feasible one is picked.
# ---------------------------------------------------------------------------

def target_block_sizes_torch(n, speeds: torch.Tensor,
                             mems: torch.Tensor) -> torch.Tensor:
    """Algorithm 1 on tensors (any device).  Returns tw in the original PU
    order, in the dtype of ``speeds``.

    Args:
      n: scalar total load (number or 0-d tensor).
      speeds, mems: shape (k,) tensors.
    """
    k = speeds.shape[0]
    ratio = speeds / mems
    order = torch.sort(-ratio, stable=True).indices
    s_sorted = speeds[order]
    m_sorted = mems[order]
    r_sorted = ratio[order]

    zero = torch.zeros(1, dtype=speeds.dtype, device=speeds.device)
    # prefix sums: cum_mem[s] = sum_{i<s} m_i, suf_speed[s] = sum_{i>=s} c_i
    cum_mem = torch.cat([zero, torch.cumsum(m_sorted, 0)])      # (k+1,)
    suf_speed = s_sorted.sum() - torch.cat([zero,
                                            torch.cumsum(s_sorted, 0)])

    load_s = n - cum_mem                                        # (k+1,)
    # max ratio among the suffix i >= s; sorted desc => it is r_sorted[s]
    r_suffix_max = torch.cat([r_sorted, zero])
    safe_speed = torch.where(suf_speed > 0, suf_speed,
                             torch.ones_like(suf_speed))
    feasible = r_suffix_max * load_s / safe_speed <= 1.0 + 1e-12
    feasible = feasible | (suf_speed <= 0)  # s == k: everyone saturated
    # smallest feasible prefix length (argmax of a bool picks the first)
    s_star = torch.argmax(feasible.to(torch.int32))

    idx = torch.arange(k, device=speeds.device)
    load = load_s[s_star]
    sspd = torch.where(suf_speed[s_star] > 0, suf_speed[s_star],
                       torch.ones_like(suf_speed[s_star]))
    tw_sorted = torch.where(idx < s_star, m_sorted, s_sorted * load / sspd)
    tw = torch.zeros_like(tw_sorted)
    tw[order] = tw_sorted
    return tw
