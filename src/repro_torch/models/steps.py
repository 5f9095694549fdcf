"""Train-step, prefill and decode-step factories for every family, ported
from ``src/repro/models/steps.py``.  The dry-run input specs wait for
ROADMAP.md queue 1 item 19.

Serving (:func:`make_prefill`, :func:`make_decode_step`) runs under
``torch.no_grad()``: a model whose parameters require grad (a trainer's)
still serves through the flash kernels, which refuse to run where a
gradient is needed.  ``inference_mode`` would not do: its tensors cannot be
written in place later, and a decode step writes its caches in place.

Training (:func:`loss_fn`, :func:`make_train_step`) differentiates the
plain attention, as the reference does, and runs each layer under remat
when ``cfg.remat == "full"`` (``transformer.remat_layers``).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..train.optimizer import AdamWConfig, adamw_update
from . import encdec, transformer
from .common import cross_entropy
from .config import ModelConfig

AUX_COEF = 0.01


def model_module(cfg: ModelConfig):
    """:mod:`.encdec` for the audio family, :mod:`.transformer` for the
    others."""
    transformer.require_ported(cfg)
    return encdec if cfg.family == "audio" else transformer


def loss_fn(params: nn.Module, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Mean cross entropy of ``batch["labels"]`` (masked by
    ``batch["mask"]`` if given) plus ``AUX_COEF`` times the MoE layers'
    load-balancing loss.  ``batch`` holds ``tokens`` and ``labels``, and
    ``img_embeds`` for a VLM or ``frames`` for the audio family."""
    if cfg.family == "audio":
        logits, aux = encdec.forward(params, cfg, batch["frames"],
                                     batch["tokens"])
    elif cfg.family == "vlm":
        logits, aux = transformer.forward(params, cfg, batch["tokens"],
                                          img_embeds=batch["img_embeds"])
    else:
        logits, aux = transformer.forward(params, cfg, batch["tokens"])
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce + AUX_COEF * aux


def loss_and_grads(params: nn.Module, cfg: ModelConfig, batch: dict):
    """(loss, {name: gradient in the parameter's dtype}); a parameter the
    loss does not reach gets zeros, as ``jax.grad`` gives."""
    named = [(n, p) for n, p in params.named_parameters()]
    loss = loss_fn(params, cfg, batch)
    gs = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(named, gs)}


def make_train_step(cfg: ModelConfig, opt: AdamWConfig,
                    accum_steps: int = 1,
                    grad_compression: str | None = None) -> Callable:
    """(state, batch) -> (state, metrics).  ``state = {"params": model,
    "opt": init_opt_state(model)}``, updated in place and returned;
    ``metrics = {"loss", "grad_norm", "lr"}``, 0-d float32 tensors on the
    model's device.  Every parameter must require grad.

    ``accum_steps`` > 1 splits the batch into that many contiguous
    microbatches along its leading axis (the reference's reshape), sums
    their gradients in float32 buffers of its own (not in the parameter
    dtype's ``.grad``) and divides the loss and the gradients by
    ``accum_steps``.

    ``grad_compression`` is accepted and changes nothing: the reference's
    int8 cross-pod reduction acts only on a mesh with a ``pod`` axis of
    two or more, and one process has none (the multi-process mode is
    ROADMAP.md queue 1 item 9).
    """
    del grad_compression

    def train_step(state, batch):
        params = state["params"]
        if accum_steps == 1:
            loss, grads = loss_and_grads(params, cfg, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            mb = B // accum_steps
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(params.parameters()).device)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.named_parameters()}
            for i in range(accum_steps):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, g = loss_and_grads(params, cfg, micro)
                loss = loss + l
                for n, x in g.items():
                    grads[n].add_(x.float())
                del g
            loss = loss / accum_steps
            grads = {n: g / accum_steps for n, g in grads.items()}
        _, opt_state, m = adamw_update(opt, params, grads, state["opt"])
        state["opt"] = opt_state
        return state, {"loss": loss.float(), **m}

    return train_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """(params, cache, tokens (B, 1), pos) -> (logits, cache), under
    ``torch.no_grad()``."""
    mod = model_module(cfg)

    def step(params, cache, tokens, pos):
        with torch.no_grad():
            return mod.decode_step(params, cfg, cache, tokens, pos)

    return step


def make_prefill(cfg: ModelConfig, cache_len: int | None = None) -> Callable:
    """Prefill: (params, batch) -> (last-token logits, cache), under
    ``torch.no_grad()``.  ``batch`` holds ``tokens``, and ``img_embeds``
    for a VLM or ``frames`` for the audio family; ``cache_len`` (default:
    the prompt's length) sizes the attention caches."""
    mod = model_module(cfg)

    def prefill(params, batch):
        with torch.no_grad():
            if cfg.family == "audio":
                return mod.prefill_forward(params, cfg, batch["frames"],
                                           batch["tokens"],
                                           cache_len=cache_len)
            return mod.prefill_forward(params, cfg, batch["tokens"],
                                       cache_len=cache_len,
                                       img_embeds=batch.get("img_embeds"))

    return prefill
