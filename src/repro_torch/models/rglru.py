"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427),
ported from ``src/repro/models/rglru.py``.

Block: x -> { gate branch: W_gate -> GeLU } * { rec branch: W_in -> causal
conv1d -> RG-LRU } -> W_out.

RG-LRU:  r_t = sigma(W_a x + b_a);  i_t = sigma(W_x x + b_x)
         log a_t = -c * softplus(Lambda) * r_t          (c = 8)
         h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)

The reference runs the first-order recurrence with
``jax.lax.associative_scan``.  :func:`linear_scan` is its log-depth
counterpart: ceil(log2 S) rounds over the sequence axis with the same
combine, ``(la1 + la2, exp(la2) b1 + b2)`` in float32, each round reading
only the previous round's values.  The gates stay in log space (the closed
form ``exp(cumsum(log a))`` would overflow: log a reaches about -10.5 a
step).  Decode is the single-step update.

The stages (:func:`project`, the causal conv, :func:`gates`,
:func:`linear_scan`, :func:`gated_out`) are functions of their own so that
each can be timed alone.  Plain PyTorch throughout: the reference reaches
no Pallas kernel here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ParamInit, causal_conv, conv_step, gelu_tanh

_C = 8.0


class RGLRU(nn.Module):
    """The reference's ``init_rglru`` leaves, drawn in its order: ``w_in
    w_gate w_out`` (D, D), the depthwise conv ``conv_w`` (K, D, scale 0.5)
    and ``conv_b`` (zeros), ``w_a`` (D, D) and ``b_a`` (zeros), ``w_x``
    (D, D) and ``b_x`` (zeros), ``lam`` (ones)."""

    def __init__(self, init: ParamInit, d_model: int, conv_kernel: int = 4):
        super().__init__()
        d = d_model
        self.w_in = init.param((d, d))
        self.w_gate = init.param((d, d))
        self.w_out = init.param((d, d))
        self.conv_w = init.param((conv_kernel, d), scale=0.5)
        self.conv_b = init.param((d,), init="zeros")
        self.w_a = init.param((d, d))
        self.b_a = init.param((d,), init="zeros")
        self.w_x = init.param((d, d))
        self.b_x = init.param((d,), init="zeros")
        self.lam = init.param((d,), init="ones")


def init_rglru(init: ParamInit, d_model: int,
               conv_kernel: int = 4) -> RGLRU:
    return RGLRU(init, d_model, conv_kernel)


def project(p: RGLRU, x: torch.Tensor):
    """(GeLU gate, rec-branch input): ``gelu_tanh(x W_gate)`` and ``x
    W_in``."""
    return gelu_tanh(x @ p.w_gate), x @ p.w_in


def gates(p: RGLRU, u: torch.Tensor):
    """u: (..., D) post-conv activations -> (log_a, gated input), both
    float32."""
    r = torch.sigmoid((u @ p.w_a + p.b_a).float())
    i = torch.sigmoid((u @ p.w_x + p.b_x).float())
    log_a = -_C * F.softplus(p.lam.float()) * r
    a2 = torch.exp(2.0 * log_a)
    gx = torch.sqrt(torch.clamp(1.0 - a2, min=1e-9)) * i * u.float()
    return log_a, gx


def linear_scan(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of h_t = exp(log_a_t) h_{t-1} + b_t (h_{-1} = 0)
    over axis 1, in ceil(log2 S) rounds: at stride s, element t combines
    with element t - s of the previous round."""
    S = log_a.shape[1]
    la, h = log_a, b
    s = 1
    while s < S:
        h = torch.cat([h[:, :s], torch.addcmul(h[:, s:], torch.exp(la[:, s:]),
                                               h[:, :-s])], dim=1)
        if 2 * s < S:          # the last round needs no decay sums
            la = torch.cat([la[:, :s], la[:, s:] + la[:, :-s]], dim=1)
        s *= 2
    return h


def gated_out(p: RGLRU, h: torch.Tensor, gate: torch.Tensor):
    """(h in the gate's dtype * gate) @ W_out."""
    return (h.to(gate.dtype) * gate) @ p.w_out


def rglru_forward(p: RGLRU, x: torch.Tensor, return_state: bool = False):
    """Prefill.  x: (B, S, D) -> (B, S, D), or (y, cache) with
    ``return_state``: the cache's ``conv`` holds the last K - 1 *pre-conv*
    inputs, ``h`` the last state in float32."""
    gate, xin = project(p, x)
    u = causal_conv(xin, p.conv_w, p.conv_b)
    h = linear_scan(*gates(p, u))
    out = gated_out(p, h, gate)
    if return_state:
        # copies, not views: a view would hold the whole (B, S, D) input
        # and states alive with the cache
        K = p.conv_w.shape[0]
        return out, {"conv": xin[:, x.shape[1] - (K - 1):].clone(),
                     "h": h[:, -1].clone()}
    return out


def rglru_init_cache(d_model: int, batch: int, conv_kernel: int = 4,
                     dtype=torch.float32, device=None) -> dict:
    """``conv`` (B, K - 1, D) in the model's dtype, ``h`` (B, D) float32,
    both zero."""
    return {
        "conv": torch.zeros((batch, conv_kernel - 1, d_model), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, d_model), dtype=torch.float32,
                         device=device),
    }


def rglru_decode(p: RGLRU, x: torch.Tensor, cache: dict):
    """One step.  x: (B, 1, D) -> ((B, 1, D), new cache)."""
    gate, xin = project(p, x[:, 0])
    u, new_conv = conv_step(cache["conv"], xin, p.conv_w, p.conv_b)
    log_a, gx = gates(p, u)
    h = torch.exp(log_a) * cache["h"] + gx
    return gated_out(p, h, gate)[:, None], {"conv": new_conv, "h": h}
