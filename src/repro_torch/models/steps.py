"""Prefill and decode-step factories, ported from
``src/repro/models/steps.py`` for the dense and MoE families.  Training
(``loss_fn``, ``make_train_step``) waits for ROADMAP.md queue 1 item 18 and
the dry-run input specs for item 19."""
from __future__ import annotations

from typing import Callable

from . import transformer
from .config import ModelConfig


def model_module(cfg: ModelConfig):
    transformer.require_ported(cfg)
    return transformer


def make_decode_step(cfg: ModelConfig) -> Callable:
    """(params, cache, tokens (B, 1), pos) -> (logits, cache)."""
    mod = model_module(cfg)

    def step(params, cache, tokens, pos):
        return mod.decode_step(params, cfg, cache, tokens, pos)

    return step


def make_prefill(cfg: ModelConfig) -> Callable:
    """Prefill: (params, batch) -> (last-token logits, KV cache)."""
    mod = model_module(cfg)

    def prefill(params, batch):
        return mod.prefill_forward(params, cfg, batch["tokens"])

    return prefill
