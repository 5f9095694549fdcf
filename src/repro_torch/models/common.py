"""Shared model building blocks: parameter init, the recurrent layers'
causal conv, the reference's GeLU, norms, RoPE.

Ported from ``src/repro/models/common.py``.  The reference creates every
parameter through ``ParamCollector.param`` with logical axis names and maps
them to mesh axes (``logical_to_spec``, ``maybe_constrain``); one GPU has no
mesh, so :class:`ParamInit` keeps only the values: the same shapes, the same
initializers and the same order of draws, from an explicit
``torch.Generator``.  Parameters are made ``nn.Parameter`` with
``requires_grad=False``, so serving records no autograd graph; the
trainer (``repro_torch.train.trainer``) alone calls ``requires_grad_(True)``
on its model.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class ParamInit:
    """Makes parameters of one dtype on one device.

    ``gen`` is the generator every normal draw takes, in call order.  With
    ``gen=None`` normal parameters are left uninitialised, for
    :mod:`.convert` to fill from the reference's tree.
    """

    def __init__(self, gen: torch.Generator | None, dtype: torch.dtype,
                 device: torch.device):
        self.gen = gen
        self.dtype = dtype
        self.device = device

    def param(self, shape: tuple[int, ...], init: str = "normal",
              scale: float | None = None) -> nn.Parameter:
        if init == "zeros":
            w = torch.zeros(shape, dtype=self.dtype, device=self.device)
        elif init == "ones":
            w = torch.ones(shape, dtype=self.dtype, device=self.device)
        elif self.gen is None:
            w = torch.empty(shape, dtype=self.dtype, device=self.device)
        else:
            fan_in = shape[0] if len(shape) > 1 else shape[-1]
            s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
            w = (torch.randn(shape, generator=self.gen, dtype=torch.float32,
                             device=self.device) * s).to(self.dtype)
        return nn.Parameter(w, requires_grad=False)


# -- depthwise causal conv (SSM and RG-LRU) -----------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d with no activation, as the reference's
    ``_causal_conv`` sums its taps: x (B, S, C), w (K, C), b (C,)."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S] * w[i]
    return out + b


def conv_step(tail: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor):
    """One step of :func:`causal_conv` from the last K - 1 inputs
    ``tail`` (B, K - 1, C) and the new ``x`` (B, C): (out (B, C), new
    tail).  The taps are summed as the reference's ``einsum("bkc,kc->bc")``
    sums them: in float32, rounded once to x's dtype."""
    hist = torch.cat([tail, x[:, None]], dim=1)                  # (B, K, C)
    out = (hist.float() * w.float()).sum(1).to(hist.dtype)
    return out + b, hist[:, 1:]


# -- GeLU ---------------------------------------------------------------------

def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation, its default) as the
    reference evaluates it: op by op in x's dtype, its constants rounded
    to that dtype first (in bfloat16 sqrt(2/pi) is 0.796875).
    ``F.gelu(approximate="tanh")`` keeps the exact constants and differs
    from it by a bf16 ulp on about half the entries.  The dense MLP, the
    MoE experts and the RG-LRU gate take it for ``activation="gelu"``."""
    def r(v):
        return float(torch.tensor(v, dtype=x.dtype))
    cdf = r(0.5) * (1.0 + torch.tanh(
        r(math.sqrt(2 / math.pi)) * (x + r(0.044715) * (x * x * x))))
    return x * cdf


# -- norms --------------------------------------------------------------------

class Norm(nn.Module):
    """``scale`` (and ``bias`` for layernorm) over the last axis."""

    def __init__(self, init: ParamInit, d: int, kind: str):
        super().__init__()
        self.scale = init.param((d,), init="ones")
        if kind == "rmsnorm":
            self.register_parameter("bias", None)
        else:
            self.bias = init.param((d,), init="zeros")


def init_norm(init: ParamInit, d: int, kind: str) -> Norm:
    return Norm(init, d, kind)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """Normalised in float32, cast back to x's dtype, *then* scaled."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


def apply_norm(kind: str, x: torch.Tensor, p: Norm) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p.scale)
    return layernorm(x, p.scale, p.bias)


# -- RoPE ---------------------------------------------------------------------

def rope_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta^(2i / head_dim)`` in float32, shape (head_dim / 2,)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_table(seq: int, head_dim: int, theta: float = 10000.0,
               offset: int = 0, device=None):
    """cos, sin of shape (seq, head_dim / 2) from float32 positions."""
    pos = torch.arange(offset, offset + seq, dtype=torch.float32,
                       device=device)
    ang = pos[:, None] * rope_inv_freq(head_dim, theta, device)[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (..., S, H, hd); cos/sin: (S, hd/2).  Split-half (NeoX) form."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# -- loss ---------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross entropy in float32: logsumexp minus the gold logit.
    logits (..., V), labels (...) integer; with ``mask`` (...) the sum of
    the masked losses over ``max(sum(mask), 1)``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
