"""LDHT expert placement -- the paper's technique applied to MoE serving,
copied from ``src/repro/core/expert_placement.py``.

``PlacementResult``, ``expert_loads``, ``coactivation_graph`` and
``place_experts`` are host NumPy, copied verbatim so their results are
bit-equal to the reference's: the swap loops' scan order decides the
placement among ties.  They run on the port's ``block_sizes`` and
``topology``.  ``permute_expert_params`` works on the port's
:class:`repro_torch.models.mlp.MoE` module.

Experts are the 'graph', expert-parallel device ranks are the heterogeneous
PUs.  The mapping of the paper's LDHT objectives (Sec. II-B):

  Eq. (2)  minimize max_j load(b_j) / c_s(p_j)   -- hot experts must not pile
           onto one (or a slow) device; load(e) = expected fraction of
           routed tokens hitting expert e (from router statistics).
  Eq. (3)  |b_j| == E_loc                        -- the memory constraint is
           *exact*: every rank hosts exactly E/ep_size expert slots.
  Eq. (1)  minimize co-activation cut            -- secondary: experts that
           fire together for the same token are co-located, shrinking the
           per-token dispatch fan-out across ranks.

Because the count constraint is exact and E is small (32-64), stage 2 is an
LPT-style greedy under Algorithm-1 budgets plus pairwise-swap refinement
(the FM analogue on the expert quotient graph).

Outputs a permutation ``perm`` with perm[old_expert] = new_slot such that
new slots [j*E_loc, (j+1)*E_loc) live on rank j.  Apply it with
``permute_expert_params``, which reorders the stacked weights and stores
``perm`` on the module, where ``moe_forward`` reads it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .block_sizes import target_block_sizes
from .topology import Topology


@dataclasses.dataclass(frozen=True)
class PlacementResult:
    perm: np.ndarray            # (E,) old expert id -> new slot id
    rank_of: np.ndarray         # (E,) old expert id -> EP rank
    load_per_rank: np.ndarray   # (ep,) sum of expert loads per rank
    max_load_ratio: float       # Eq. 2 objective: max load_j / speed_j
    coact_cut: float            # Eq. 1 analogue: cross-rank co-activation


def expert_loads(routing_counts: np.ndarray) -> np.ndarray:
    """Normalize router top-k hit counts (E,) to a load distribution."""
    c = np.asarray(routing_counts, dtype=np.float64)
    s = c.sum()
    return c / s if s > 0 else np.full(c.shape, 1.0 / len(c))


def coactivation_graph(topk_ids: np.ndarray, n_experts: int) -> np.ndarray:
    """Dense (E, E) co-routing weights from observed top-k id rows.

    topk_ids: (T, K) int — the router's chosen experts per token."""
    W = np.zeros((n_experts, n_experts), dtype=np.float64)
    for row in np.asarray(topk_ids).reshape(-1, topk_ids.shape[-1]):
        for a in row:
            for b in row:
                if a != b:
                    W[a, b] += 1.0
    return W


def place_experts(loads: np.ndarray, topo: Topology,
                  coact: np.ndarray | None = None,
                  swap_rounds: int = 4) -> PlacementResult:
    """Two-stage LDHT placement of E experts onto topo.k EP ranks.

    Stage 1 (Algorithm 1): per-rank *load budgets* from the PU speeds (the
    slot memory constraint is handled structurally by E_loc).
    Stage 2: LPT greedy into the budget with exactly E_loc slots per rank,
    then pairwise swap refinement on (Eq. 2, then Eq. 1).
    """
    loads = np.asarray(loads, dtype=np.float64)
    E, ep = len(loads), topo.k
    if E % ep != 0:
        raise ValueError(f"E={E} not divisible by ep_size={ep}")
    E_loc = E // ep
    if coact is None:
        coact = np.zeros((E, E))

    # Stage 1: Algorithm-1 budgets on total load 1.0.  Memory caps in load
    # units are effectively infinite (the slot constraint is separate), so
    # budgets are speed-proportional — but we keep the general call so
    # heterogeneous m_cap topologies still bound the budget.
    budgets = target_block_sizes(float(loads.sum()), topo)

    # Stage 2a: LPT greedy — heaviest expert first, to the rank with the
    # most remaining budget that still has a free slot.
    order = np.argsort(-loads)
    rank_of = np.empty(E, dtype=np.int64)
    used = np.zeros(ep, dtype=np.int64)
    acc = np.zeros(ep, dtype=np.float64)
    for e in order:
        headroom = (budgets - acc) / topo.speeds
        headroom[used >= E_loc] = -np.inf
        j = int(np.argmax(headroom))
        rank_of[e] = j
        used[j] += 1
        acc[j] += loads[e]

    speeds = topo.speeds

    def ratio(a):
        return (a / speeds).max()

    def cut(r):
        same = r[:, None] == r[None, :]
        return float(coact[~same].sum())

    # Stage 2b: pairwise swap refinement (FM analogue, swap moves keep the
    # exact-count constraint satisfied).  Restart the scan after every
    # accepted swap — membership lists go stale once ranks change.
    for _ in range(swap_rounds * E):
        improved = False
        jmax = int(np.argmax(acc / speeds))
        for e1 in np.where(rank_of == jmax)[0]:
            for e2 in np.where(rank_of != jmax)[0]:
                j2 = rank_of[e2]
                delta = loads[e1] - loads[e2]
                new_acc = acc.copy()
                new_acc[jmax] -= delta
                new_acc[j2] += delta
                if ratio(new_acc) < ratio(acc) - 1e-15:
                    rank_of[e1], rank_of[e2] = j2, jmax
                    acc = new_acc
                    improved = True
                    break
            if improved:
                break
        if not improved:
            break

    # co-activation polish: same-load-impact swaps that reduce the cut
    for _ in range(swap_rounds):
        improved = False
        base = cut(rank_of)
        for e1 in range(E):
            for e2 in range(e1 + 1, E):
                j1, j2 = rank_of[e1], rank_of[e2]
                if j1 == j2:
                    continue
                delta = loads[e1] - loads[e2]
                new_acc = acc.copy()
                new_acc[j1] -= delta
                new_acc[j2] += delta
                if ratio(new_acc) > ratio(acc) + 1e-12:
                    continue
                trial = rank_of.copy()
                trial[e1], trial[e2] = j2, j1
                c = cut(trial)
                if c < base - 1e-12:
                    rank_of, acc, base = trial, new_acc, c
                    improved = True
        if not improved:
            break

    # slots: experts of rank j occupy [j*E_loc, (j+1)*E_loc)
    perm = np.empty(E, dtype=np.int64)
    nxt = np.array([j * E_loc for j in range(ep)])
    for e in range(E):
        j = rank_of[e]
        perm[e] = nxt[j]
        nxt[j] += 1
    return PlacementResult(perm=perm, rank_of=rank_of, load_per_rank=acc,
                           max_load_ratio=ratio(acc),
                           coact_cut=cut(rank_of))


def permute_expert_params(moe, perm: np.ndarray):
    """Reorder ``moe``'s stacked expert weights in place so slot perm[e]
    holds expert e's weights, and store the routing permutation as the
    module's ``perm`` buffer (int64, on the weights' device), where
    ``moe_forward`` picks it up on every path (forward, prefill, decode):
    the placed module computes what the unplaced one did.  Returns
    ``moe``."""
    dev = moe.w1.device
    inv = torch.as_tensor(np.argsort(perm), device=dev)
    for k in ("w1", "w2", "w3"):
        w = getattr(moe, k)
        if w is not None:
            w.data = w.data.index_select(0, inv)
    moe.perm = torch.as_tensor(np.asarray(perm), dtype=torch.int64,
                               device=dev)
    return moe
