"""AdamW with global-norm clipping, ported from
``src/repro/train/optimizer.py``: plain functions over a model's named
parameters, no ``torch.optim``.

``torch.optim.AdamW`` is not this optimizer: it keeps its moments in the
parameter's dtype (bf16 for a bf16 model) and rounds its update another
way.  Here, as in the reference, ``m`` and ``v`` are float32 whatever the
parameter's dtype, the update is computed in float32 and cast back to the
parameter's dtype once, weight decay applies to every parameter, and the
gradients are clipped by their global norm, which is reported before the
clip.  The elementwise work goes through ``torch._foreach_*`` (one launch
per op over all parameters where the device allows it).

The state is ``{"m": {name: f32}, "v": {name: f32}, "step": int32 0-d}``
on the parameters' device, so the step's schedule never reads the host.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac`` of ``lr``; float32
    like the reference's.  ``step`` is an int or an integer tensor."""
    step = torch.as_tensor(step)
    warm = torch.clamp_max((step + 1) / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def init_opt_state(params: nn.Module) -> dict:
    """Zero float32 ``m`` and ``v`` for every named parameter, step 0."""
    named = list(params.named_parameters())

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": {n: zeros(p) for n, p in named},
            "v": {n: zeros(p) for n, p in named},
            "step": torch.zeros((), dtype=torch.int32,
                                device=named[0][1].device)}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in float32.  ``tensors``
    is a sequence or a dict of tensors."""
    if isinstance(tensors, dict):
        tensors = list(tensors.values())
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


def adamw_update(cfg: AdamWConfig, params: nn.Module, grads: dict,
                 state: dict):
    """One AdamW step over ``params``' named parameters, written in place
    (parameters, ``m``, ``v`` and ``step``).  ``grads`` maps each name to
    its gradient (any float dtype).  Returns (params, state, metrics) with
    metrics ``{"grad_norm", "lr"}``: the global norm before the clip and
    the step's learning rate, 0-d float32 tensors."""
    names = list(state["m"])
    named = dict(params.named_parameters())
    ps = [named[n] for n in names]
    g = [grads[n].float() for n in names]
    m = [state["m"][n] for n in names]
    v = [state["v"][n] for n in names]
    gnorm = global_norm(g)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    step = state["step"]
    lr = lr_schedule(cfg, step)
    t = (step + 1).float()
    bc1 = 1 - torch.pow(cfg.b1, t)
    bc2 = 1 - torch.pow(cfg.b2, t)

    g = torch._foreach_mul(g, scale)     # new tensors: never the caller's
    torch._foreach_mul_(m, cfg.b1)                       # m = b1 m + (1-b1) g
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
    torch._foreach_mul_(v, cfg.b2)                       # v = b2 v + (1-b2) g²
    torch._foreach_add_(v, torch._foreach_mul(
        torch._foreach_mul(g, 1 - cfg.b2), g))
    mh = torch._foreach_div(m, bc1)
    den = torch._foreach_sqrt(torch._foreach_div(v, bc2))
    torch._foreach_add_(den, cfg.eps)
    p32 = [p.detach().float() for p in ps]
    delta = torch._foreach_div(mh, den)
    torch._foreach_add_(delta, torch._foreach_mul(p32, cfg.weight_decay))
    new = torch._foreach_sub(p32, torch._foreach_mul(delta, lr))
    with torch.no_grad():
        for p, x in zip(ps, new):
            p.copy_(x)                                   # one cast to p's dtype
    state["step"] = step + 1
    return params, state, {"grad_norm": gnorm, "lr": lr}
