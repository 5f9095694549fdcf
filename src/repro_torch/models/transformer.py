"""Decoder LM, dense family: full-sequence forward, prefill and KV-cache
decode, ported from ``src/repro/models/transformer.py``.

The reference stacks the layers on a leading axis and runs them with
``lax.scan`` under ``jax.checkpoint``; here the model is an ``nn.Module``
holding one :class:`DenseLayer` per layer in an ``nn.ModuleList``, run by a
Python loop (no remat: that is a training concern).  The parameter names
mirror the reference's tree (``embed``, ``layers.<i>.attn.wq``, ...,
``final_norm.scale``, ``lm_head``) so :mod:`.convert` maps one onto the
other.  The KV cache is a list with one ``(k, v)`` pair per layer.

Only layer kind ``"dense"`` is ported.  The other kinds and families raise
``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .attention import attn_decode, attn_forward, attn_prefill, \
    init_attention
from .common import ParamInit, apply_norm, init_norm
from .config import ModelConfig
from .mlp import init_mlp, mlp_forward

_NOT_PORTED = {
    "moe": "MoE layers (ROADMAP.md queue 1 item 13)",
    "ssm": "SSM layers (ROADMAP.md queue 1 item 14)",
    "hybrid": "the hybrid family: RG-LRU and local attention (ROADMAP.md "
              "queue 1 item 15)",
    "vlm": "the VLM family (ROADMAP.md queue 1 item 16)",
    "audio": "the audio enc-dec family (ROADMAP.md queue 1 item 17)",
}


def require_dense(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless every layer of ``cfg`` is a
    dense decoder layer of the dense family."""
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: {_NOT_PORTED[cfg.family]} is not ported yet")
    if cfg.family != "dense" or set(cfg.unit) != {"dense"}:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {cfg.unit} are not ported yet")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class DenseLayer(nn.Module):
    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        self.norm1 = init_norm(init, cfg.d_model, cfg.norm)
        self.attn = init_attention(init, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim,
                                   cfg.qkv_bias)
        self.norm2 = init_norm(init, cfg.d_model, cfg.norm)
        self.ffn = init_mlp(init, cfg.d_model, cfg.d_ff, cfg.activation)


class LM(nn.Module):
    """Embedding (``vocab_padded`` rows), the layers, the final norm and,
    unless the embeddings are tied, an ``lm_head``."""

    def __init__(self, cfg: ModelConfig, init: ParamInit):
        super().__init__()
        require_dense(cfg)
        self.embed = init.param((cfg.vocab_padded, cfg.d_model), scale=0.02)
        self.layers = nn.ModuleList(DenseLayer(init, cfg)
                                    for _ in range(cfg.n_layers))
        self.final_norm = init_norm(init, cfg.d_model, cfg.norm)
        if cfg.tie_embeddings:
            self.register_parameter("lm_head", None)
        else:
            self.lm_head = init.param((cfg.d_model, cfg.vocab_padded),
                                      scale=0.02)


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> LM:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    drawn in the reference's order and with its initializers (normal with
    scale ``1/sqrt(fan_in)``, 0.02 for the embedding and head; norms ones,
    biases zeros).  ``device=None`` is the card."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LM(cfg, ParamInit(gen, _dtype(cfg), dev))


def _attn_kw(cfg: ModelConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)


def _head(params: LM, cfg: ModelConfig) -> torch.Tensor:
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def _embed(params: LM, cfg: ModelConfig, tokens: torch.Tensor):
    return params.embed[tokens.long()].to(_dtype(cfg))


# -- full-sequence forward ----------------------------------------------------

def _apply_layer(p: DenseLayer, x, cfg: ModelConfig):
    h = apply_norm(cfg.norm, x, p.norm1)
    x = x + attn_forward(p.attn, h, **_attn_kw(cfg))
    h2 = apply_norm(cfg.norm, x, p.norm2)
    return x + mlp_forward(p.ffn, h2, cfg.activation)


def forward(params: LM, cfg: ModelConfig, tokens: torch.Tensor):
    """Full-sequence forward.  Returns (logits (B, S, V_padded), aux loss);
    the aux loss is zero for dense layers."""
    require_dense(cfg)
    x = _embed(params, cfg, tokens)
    for layer in params.layers:
        x = _apply_layer(layer, x, cfg)
    x = apply_norm(cfg.norm, x, params.final_norm)
    logits = x @ _head(params, cfg).to(x.dtype)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# -- cache --------------------------------------------------------------------

def _layer_cache(kind: str, cfg: ModelConfig, batch: int, cache_len: int,
                 device):
    if kind != "dense":
        raise NotImplementedError(f"{cfg.name}: layer kind {kind!r} is not "
                                  "ported yet")
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=_dtype(cfg), device=device),
            torch.zeros(shape, dtype=_dtype(cfg), device=device))


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """One zero ``(k, v)`` pair per layer, each (batch, cache_len, n_kv,
    head_dim) in the model's dtype."""
    require_dense(cfg)
    dev = resolve_device(device)
    return [_layer_cache("dense", cfg, batch, cache_len, dev)
            for _ in range(cfg.n_layers)]


# -- prefill ------------------------------------------------------------------

def _apply_layer_prefill(p: DenseLayer, x, cfg: ModelConfig,
                         cache_len: int):
    h = apply_norm(cfg.norm, x, p.norm1)
    y, c = attn_prefill(p.attn, h, cache_len, **_attn_kw(cfg))
    x = x + y
    h2 = apply_norm(cfg.norm, x, p.norm2)
    return x + mlp_forward(p.ffn, h2, cfg.activation), c


def prefill_forward(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
                    cache_len: int | None = None):
    """Prefill: returns (last-token logits (B, 1, V_padded), cache).  Only
    the last position is normalised and projected onto the vocabulary."""
    require_dense(cfg)
    B, S = tokens.shape
    cache_len = cache_len or S
    x = _embed(params, cfg, tokens)
    cache = []
    for layer in params.layers:
        x, c = _apply_layer_prefill(layer, x, cfg, cache_len)
        cache.append(c)
    x = apply_norm(cfg.norm, x[:, -1:], params.final_norm)
    return x @ _head(params, cfg).to(x.dtype), cache


# -- decode -------------------------------------------------------------------

def decode_step(params: LM, cfg: ModelConfig, cache, tokens: torch.Tensor,
                pos: int):
    """One token for the whole batch.  tokens: (B, 1); pos: Python int.
    Returns (logits (B, 1, V_padded), cache); the cache is updated in
    place."""
    require_dense(cfg)
    x = _embed(params, cfg, tokens)
    new_cache = []
    for layer, c in zip(params.layers, cache):
        h = apply_norm(cfg.norm, x, layer.norm1)
        y, c = attn_decode(layer.attn, h, c, pos, **_attn_kw(cfg))
        x = x + y
        h2 = apply_norm(cfg.norm, x, layer.norm2)
        x = x + mlp_forward(layer.ffn, h2, cfg.activation)
        new_cache.append(c)
    x = apply_norm(cfg.norm, x, params.final_norm)
    return x @ _head(params, cfg).to(x.dtype), new_cache
