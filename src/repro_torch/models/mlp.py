"""Dense MLP (SwiGLU / GELU), ported from ``src/repro/models/mlp.py``.
The token-choice MoE layer is not ported yet (ROADMAP queue 1 item 13)."""
from __future__ import annotations

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
    if activation == "swiglu":
        return (F.silu(x @ p.w1) * (x @ p.w3)) @ p.w2
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ p.w1, approximate="tanh") @ p.w2
