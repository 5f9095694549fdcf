"""Dense MLP (SwiGLU / GELU) and the token-choice top-k MoE with grouped
capacity dispatch, ported from ``src/repro/models/mlp.py``.

The MoE is where the paper's LDHT technique meets the LM stack:
``repro_torch.core.expert_placement`` places the experts on ranks and
stores the routing permutation on the module (``MoE.perm``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ParamInit


class MLP(nn.Module):
    """``w1``, ``w2`` (and ``w3`` for SwiGLU), each (in, out) for
    ``x @ W``."""

    def __init__(self, init: ParamInit, d_model: int, d_ff: int,
                 activation: str = "swiglu"):
        super().__init__()
        self.w1 = init.param((d_model, d_ff))
        self.w2 = init.param((d_ff, d_model))
        if activation == "swiglu":
            self.w3 = init.param((d_model, d_ff))
        else:
            self.register_parameter("w3", None)


def init_mlp(init: ParamInit, d_model: int, d_ff: int,
             activation: str = "swiglu") -> MLP:
    return MLP(init, d_model, d_ff, activation)


def mlp_forward(p: MLP, x, activation: str = "swiglu"):
    h = _activate(x @ p.w1, activation)
    if activation == "swiglu":
        h = h * (x @ p.w3)
    return h @ p.w2


def _activate(h, activation: str):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(h) if activation == "swiglu" else \
        F.gelu(h, approximate="tanh")


# -- MoE ----------------------------------------------------------------------

class MoE(nn.Module):
    """``router`` (D, E), ``w1`` (E, D, F), ``w2`` (E, F, D) and, for
    SwiGLU, ``w3`` (E, D, F); ``perm`` is an (E,) int64 buffer, None until
    ``expert_placement.permute_expert_params`` places the experts."""

    def __init__(self, init: ParamInit, d_model: int, n_experts: int,
                 d_expert: int, activation: str = "swiglu"):
        super().__init__()
        self.router = init.param((d_model, n_experts))
        self.w1 = init.param((n_experts, d_model, d_expert))
        self.w2 = init.param((n_experts, d_expert, d_model))
        if activation == "swiglu":
            self.w3 = init.param((n_experts, d_model, d_expert))
        else:
            self.register_parameter("w3", None)
        self.register_buffer("perm", None)


def init_moe(init: ParamInit, d_model: int, n_experts: int, d_expert: int,
             activation: str = "swiglu") -> MoE:
    """Draws in the reference's order: router, w1, w2, w3."""
    return MoE(init, d_model, n_experts, d_expert, activation)


def route(p: MoE, x: torch.Tensor, top_k: int):
    """Router softmax and top-k: (probs (B, S, E) f32, gates (B, S, K),
    expert ids (B, S, K) int64).  Ties go to the lower expert id, as
    ``jax.lax.top_k``'s do: a stable descending sort, then the first K
    (``torch.topk`` promises no order among equal values, and bf16 logits
    tie often)."""
    probs = torch.softmax((x @ p.router).float(), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, vals[..., :top_k], ids[..., :top_k]


def capacity(S: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots per expert and batch row: ceil(S K / E) times the factor,
    rounded up to a multiple of 4, at least 4 (the reference's integer
    arithmetic)."""
    C = int(-(-S * top_k // n_experts) * capacity_factor)
    return max(4, -(-C // 4) * 4)


def assign_slots(exp_ids: torch.Tensor, n_experts: int, C: int):
    """Slot of each (token, k) entry of (B, S, K) expert ids: its position
    in its expert's queue within the batch row, in (s, k) order.  Returns
    ``flat_e`` and ``slot`` (B, S*K), and ``keep`` (slot < C); a dropped
    entry's slot is 0."""
    B = exp_ids.shape[0]
    flat_e = exp_ids.reshape(B, -1)                           # (B, S*K)
    pos = F.one_hot(flat_e, n_experts).cumsum(1) - 1          # (B, S*K, E)
    slot = pos.gather(2, flat_e[..., None])[..., 0]
    keep = slot < C
    return flat_e, torch.where(keep, slot, 0), keep


def dispatch(x: torch.Tensor, flat_e, slot, keep, n_experts: int,
             C: int) -> torch.Tensor:
    """x (B, S, D) into the (E, B, C, D) slots.  Dropped entries add a zero
    at slot 0, as the reference's scatter-add does (a set would overwrite
    the token there)."""
    B, S, D = x.shape
    K = flat_e.shape[1] // S
    tok_ids = torch.arange(S, device=x.device).repeat_interleave(K)
    brow = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    xk = torch.where(keep[..., None], x[:, tok_ids], 0)       # (B, S*K, D)
    disp = torch.zeros((n_experts, B, C, D), dtype=x.dtype, device=x.device)
    return disp.index_put_((flat_e, brow, slot), xk, accumulate=True)


def expert_ffn(p: MoE, disp: torch.Tensor, activation: str) -> torch.Tensor:
    """Every expert on its (B, C) slots, one ``bmm`` per weight over the
    expert axis: (E, B, C, D) -> (E, B, C, D)."""
    E, B, C, D = disp.shape
    d = disp.view(E, B * C, D)
    h = _activate(torch.bmm(d, p.w1), activation)
    if activation == "swiglu":
        h = h * torch.bmm(d, p.w3)
    return torch.bmm(h, p.w2).view(E, B, C, D)


def combine(eout: torch.Tensor, flat_e, slot, gates: torch.Tensor,
            S: int) -> torch.Tensor:
    """Each (token, k) entry's expert output times its gate (B, S*K; zero
    for a dropped entry), summed over k in one fixed-order reduction (no
    atomics): (B, S, D)."""
    B, T = flat_e.shape
    brow = torch.arange(B, device=eout.device)[:, None].expand(B, T)
    contrib = eout[flat_e, brow, slot] * gates[..., None].to(eout.dtype)
    return contrib.view(B, S, T // S, -1).sum(2)


def moe_forward(p: MoE, x: torch.Tensor, *, n_experts: int, top_k: int,
                activation: str = "swiglu", capacity_factor: float = 1.25,
                expert_perm: torch.Tensor | None = None,
                impl: str = "auto"):
    """Token-choice top-k MoE.  x: (B, S, D) -> (y, aux_loss).

    The reference's ``_moe_forward_dense``: each batch row is a dispatch
    group with ``capacity(S, E, K, cf)`` slots per expert; a (token, k)
    entry past its expert's capacity loses that expert's contribution
    (GShard).  ``expert_perm`` (default ``p.perm``) maps router ids to
    expert slots, the LDHT placement hook.  ``impl``: "auto", "dense" or
    "shard_map"; without a 'model' mesh axis the reference runs this
    grouped dispatch for all three, and one GPU has no mesh.

    Stages: :func:`route`, :func:`assign_slots`, :func:`dispatch`,
    :func:`expert_ffn`, :func:`combine`.  The dispatch tensor is laid out
    (E, B, C, D), so the expert products are one ``bmm`` each over the
    expert axis with no transpose; every element is the reference's
    ``einsum``'s sum over D (or F).
    """
    if impl not in ("auto", "dense", "shard_map"):
        raise ValueError(f"impl must be auto, dense or shard_map; got "
                         f"{impl!r}")
    if expert_perm is None:
        expert_perm = p.perm
    B, S, _ = x.shape
    E, K = n_experts, top_k
    probs, gate_vals, exp_ids = route(p, x, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    aux_ids = exp_ids                 # aux stats in *original* expert ids
    if expert_perm is not None:
        exp_ids = expert_perm[exp_ids]
    C = capacity(S, E, K, capacity_factor)
    flat_e, slot, keep = assign_slots(exp_ids, E, C)
    disp = dispatch(x, flat_e, slot, keep, E, C)
    eout = expert_ffn(p, disp, activation)
    del disp
    y = combine(eout, flat_e, slot, gate_vals.reshape(B, S * K) * keep, S)

    # load-balancing aux loss (Switch): E * sum_e f_e * P_e
    f = F.one_hot(aux_ids[..., 0], E).float().mean((0, 1))
    aux = E * (f * probs.mean((0, 1))).sum()
    return y.to(x.dtype), aux
