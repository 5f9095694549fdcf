"""Prefill and decode-step factories, ported from
``src/repro/models/steps.py`` for every family.  Training (``loss_fn``,
``make_train_step``) waits for ROADMAP.md queue 1 item 18 and the dry-run
input specs for item 19."""
from __future__ import annotations

from typing import Callable

from . import encdec, transformer
from .config import ModelConfig


def model_module(cfg: ModelConfig):
    """:mod:`.encdec` for the audio family, :mod:`.transformer` for the
    others."""
    transformer.require_ported(cfg)
    return encdec if cfg.family == "audio" else transformer


def make_decode_step(cfg: ModelConfig) -> Callable:
    """(params, cache, tokens (B, 1), pos) -> (logits, cache)."""
    mod = model_module(cfg)

    def step(params, cache, tokens, pos):
        return mod.decode_step(params, cfg, cache, tokens, pos)

    return step


def make_prefill(cfg: ModelConfig, cache_len: int | None = None) -> Callable:
    """Prefill: (params, batch) -> (last-token logits, cache).  ``batch``
    holds ``tokens``, and ``img_embeds`` for a VLM or ``frames`` for the
    audio family; ``cache_len`` (default: the prompt's length) sizes the
    attention caches."""
    mod = model_module(cfg)

    def prefill(params, batch):
        if cfg.family == "audio":
            return mod.prefill_forward(params, cfg, batch["frames"],
                                       batch["tokens"], cache_len=cache_len)
        return mod.prefill_forward(params, cfg, batch["tokens"],
                                   cache_len=cache_len,
                                   img_embeds=batch.get("img_embeds"))

    return prefill
