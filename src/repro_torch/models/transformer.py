"""Decoder LM, dense, MoE, SSM, hybrid and VLM families: full-sequence
forward, prefill and cached decode, ported from
``src/repro/models/transformer.py``.

The reference stacks the layers of each repeating unit (``cfg.unit``, e.g.
``("rec", "rec", "attn")`` for RecurrentGemma) on a leading ``n_groups``
axis and runs them with ``lax.scan`` under ``jax.checkpoint``; the
``cfg.remainder`` layers get unstacked parameters.  Here the model is an
``nn.Module`` holding one layer module per layer in an ``nn.ModuleList``
(layer ``l`` of kind ``unit[l % len(unit)]`` for the ``n_groups`` groups,
then the remainder), run by a Python loop.  Where a gradient is needed and
``cfg.remat == "full"`` (every config's default), :func:`forward` runs each
layer under ``torch.utils.checkpoint`` (its activations recomputed in the
backward), as the reference runs each group under ``jax.checkpoint``; see
:func:`remat_layers`.  The parameter names mirror the reference's tree (``embed``,
``layers.<l>.attn.wq``, ..., ``final_norm.scale``, ``lm_head``) so
:mod:`.convert` maps one onto the other.  The cache is a list with one
entry per layer: a ``(k, v)`` pair for an attention layer (a ring of
``min(window, cache_len)`` slots for the hybrid's local attention), a
``{"conv", "h"}`` dict for an SSM or RG-LRU layer.

Layer kinds: ``dense`` and ``moe`` (attention + MLP / MoE), ``attn`` (the
hybrid's local attention: a dense layer whose attention takes
``cfg.window``), ``rec`` (RG-LRU + MLP) and ``ssm`` (Mamba2).  The VLM
family is the dense backbone whose first ``cfg.n_img_tokens`` positions
take the image embeddings (``img_embeds``; the vision frontend is a stub,
as in the reference).  The audio family's encoder-decoder is
:mod:`.encdec`.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels.flash import needs_grad
from .attention import attn_decode, attn_forward, attn_prefill, \
    init_attention
from .common import ParamInit, apply_norm, init_norm
from .config import ModelConfig
from .mlp import MoE, init_mlp, init_moe, mlp_forward, moe_forward
from .rglru import init_rglru, rglru_decode, rglru_forward, rglru_init_cache
from .ssm import init_ssm, ssm_decode, ssm_forward, ssm_init_cache

_NOT_PORTED: dict[str, str] = {}   # family -> what is missing; all ported
_KINDS = ("dense", "moe", "attn", "rec", "ssm")


def require_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg``'s family is ported and
    its layers are of the ported kinds."""
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: {_NOT_PORTED[cfg.family]} is not ported yet")
    if not set(cfg.unit) <= set(_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {cfg.unit} are not ported yet")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class DenseLayer(nn.Module):
    """Attention and a dense MLP: kinds ``dense`` and ``attn``."""

    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        self.norm1 = init_norm(init, cfg.d_model, cfg.norm)
        self.attn = init_attention(init, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim,
                                   cfg.qkv_bias)
        self.norm2 = init_norm(init, cfg.d_model, cfg.norm)
        self.ffn = self.init_ffn(init, cfg)

    @staticmethod
    def init_ffn(init: ParamInit, cfg: ModelConfig):
        return init_mlp(init, cfg.d_model, cfg.d_ff, cfg.activation)


class MoELayer(DenseLayer):
    """A dense layer whose feed-forward block is the token-choice MoE."""

    @staticmethod
    def init_ffn(init: ParamInit, cfg: ModelConfig):
        return init_moe(init, cfg.d_model, cfg.n_experts, cfg.d_expert,
                        cfg.activation)


class RecLayer(nn.Module):
    """RG-LRU and a dense MLP, each behind its own norm."""

    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        self.norm1 = init_norm(init, cfg.d_model, cfg.norm)
        self.rec = init_rglru(init, cfg.d_model, cfg.conv_kernel)
        self.norm2 = init_norm(init, cfg.d_model, cfg.norm)
        self.ffn = init_mlp(init, cfg.d_model, cfg.d_ff, cfg.activation)


class SSMLayer(nn.Module):
    """A norm and the Mamba2 block; no MLP."""

    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        self.norm1 = init_norm(init, cfg.d_model, cfg.norm)
        self.ssm = init_ssm(init, cfg.d_model, cfg.ssm_state,
                            cfg.ssm_headdim, cfg.ssm_expand,
                            cfg.conv_kernel)


_LAYERS = {"dense": DenseLayer, "moe": MoELayer, "attn": DenseLayer,
           "rec": RecLayer, "ssm": SSMLayer}


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """The kind of each layer: the unit repeated ``n_groups`` times, then
    the remainder."""
    return list(cfg.unit) * cfg.n_groups + list(cfg.remainder)


class LM(nn.Module):
    """Embedding (``vocab_padded`` rows), the layers, the final norm and,
    unless the embeddings are tied, an ``lm_head``."""

    def __init__(self, cfg: ModelConfig, init: ParamInit):
        super().__init__()
        require_ported(cfg)
        self.kinds = layer_kinds(cfg)
        self.embed = init.param((cfg.vocab_padded, cfg.d_model), scale=0.02)
        self.layers = nn.ModuleList(_LAYERS[kind](init, cfg)
                                    for kind in self.kinds)
        self.final_norm = init_norm(init, cfg.d_model, cfg.norm)
        if cfg.tie_embeddings:
            self.register_parameter("lm_head", None)
        else:
            self.lm_head = init.param((cfg.d_model, cfg.vocab_padded),
                                      scale=0.02)


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> LM:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    drawn in the reference's order and with its initializers (normal with
    scale ``1/sqrt(fan_in)``, 0.02 for the embedding and head, 0.5 for the
    convolutions; norms ones, biases zeros).  ``device=None`` is the
    card."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LM(cfg, ParamInit(gen, _dtype(cfg), dev))


def _attn_kw(kind: str, cfg: ModelConfig) -> dict:
    """Attention arguments; the hybrid's ``attn`` layers take the
    window."""
    window = cfg.window if (kind == "attn" and cfg.family == "hybrid"
                            and cfg.window) else None
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                window=window)


def _ssm_kw(cfg: ModelConfig) -> dict:
    return dict(ssm_state=cfg.ssm_state, headdim=cfg.ssm_headdim,
                expand=cfg.ssm_expand)


def _head(params: LM, cfg: ModelConfig) -> torch.Tensor:
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def _embed(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
           img_embeds: torch.Tensor | None = None):
    """Token embeddings; a VLM's image embeddings (B, n_img_tokens, D)
    overwrite the first ``cfg.n_img_tokens`` positions."""
    x = params.embed[tokens.long()].to(_dtype(cfg))
    if img_embeds is not None and cfg.n_img_tokens:
        x[:, :cfg.n_img_tokens] = img_embeds.to(x.dtype)  # a fresh gather
    return x


def _ffn(p: nn.Module, h, cfg: ModelConfig, capacity_factor: float):
    """The layer's feed-forward block: (y, aux), aux None for a dense
    MLP."""
    if isinstance(p.ffn, MoE):
        return moe_forward(p.ffn, h, n_experts=cfg.n_experts,
                           top_k=cfg.top_k, activation=cfg.activation,
                           capacity_factor=capacity_factor,
                           impl=cfg.moe_impl)
    return mlp_forward(p.ffn, h, cfg.activation), None


def _mixer(kind: str, p: nn.Module, h, cfg: ModelConfig, mode: str,
           cache=None, pos: int = 0, cache_len: int = 0):
    """The token mixer of one layer on its normed input ``h``: attention,
    RG-LRU or SSM.  ``mode`` is ``"forward"`` (returns y), ``"prefill"``
    or ``"decode"`` (return (y, cache))."""
    if kind == "rec":
        if mode == "decode":
            return rglru_decode(p.rec, h, cache)
        return rglru_forward(p.rec, h, return_state=mode == "prefill")
    if kind == "ssm":
        if mode == "decode":
            return ssm_decode(p.ssm, h, cache, **_ssm_kw(cfg))
        return ssm_forward(p.ssm, h, return_state=mode == "prefill",
                           **_ssm_kw(cfg))
    kw = _attn_kw(kind, cfg)
    if mode == "decode":
        return attn_decode(p.attn, h, cache, pos, **kw)
    if mode == "prefill":
        clen = min(cfg.window or cache_len, cache_len) if kind == "attn" \
            else cache_len
        return attn_prefill(p.attn, h, clen, **kw)
    return attn_forward(p.attn, h, **kw)


def _apply_layer(kind: str, p: nn.Module, x, cfg: ModelConfig, mode: str,
                 capacity_factor: float, cache=None, pos: int = 0,
                 cache_len: int = 0):
    """One layer: (x, aux, cache); aux None but for an MoE layer, cache
    None in forward mode."""
    h = apply_norm(cfg.norm, x, p.norm1)
    out = _mixer(kind, p, h, cfg, mode, cache, pos, cache_len)
    y, cache = (out, None) if mode == "forward" else out
    x = x + y
    aux = None
    if kind != "ssm":
        h2 = apply_norm(cfg.norm, x, p.norm2)
        y2, aux = _ffn(p, h2, cfg, capacity_factor)
        x = x + y2
    return x, aux, cache


# -- full-sequence forward ----------------------------------------------------

def remat_layers(cfg: ModelConfig) -> bool:
    """Whether a forward that needs a gradient recomputes each layer in the
    backward: ``cfg.remat`` ``"full"`` (the reference's ``jax.checkpoint``
    of each scanned group) yes, ``"none"`` no.  The reference's ``"dots"``
    and ``"dots_nb"`` policies and its two-level ``remat_chunks`` are set by
    no config and not ported (ROADMAP.md queue 1 item 21)."""
    if cfg.remat not in ("full", "none"):
        raise NotImplementedError(
            f"{cfg.name}: remat={cfg.remat!r} is not ported (ROADMAP.md "
            f"queue 1 item 21); use 'full' or 'none'")
    if cfg.remat == "full" and cfg.remat_chunks > 1:
        raise NotImplementedError(
            f"{cfg.name}: remat_chunks={cfg.remat_chunks} (two-level remat) "
            f"is not ported (ROADMAP.md queue 1 item 21)")
    return cfg.remat == "full"


def run_layer(fn, *args, remat: bool = False):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant)
    when ``remat``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _forward_layer(kind: str, p: nn.Module, x, cfg: ModelConfig):
    x, aux, _ = _apply_layer(kind, p, x, cfg, "forward", cfg.moe_capacity)
    return x, aux


def forward(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
            img_embeds: torch.Tensor | None = None):
    """Full-sequence forward.  Returns (logits (B, S, V_padded), aux loss):
    the MoE layers' load-balancing losses summed and divided by the number
    of layers, zero for the other families.  Where a gradient is needed,
    each layer runs under remat as :func:`remat_layers` says."""
    require_ported(cfg)
    remat = needs_grad(*params.parameters()) and remat_layers(cfg)
    x = _embed(params, cfg, tokens, img_embeds)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, layer in zip(params.kinds, params.layers):
        x, aux = run_layer(_forward_layer, kind, layer, x, cfg, remat=remat)
        if aux is not None:
            aux_total = aux_total + aux
    x = apply_norm(cfg.norm, x, params.final_norm)
    logits = x @ _head(params, cfg).to(x.dtype)
    return logits, aux_total / max(cfg.n_layers, 1)


# -- cache --------------------------------------------------------------------

def _layer_cache(kind: str, cfg: ModelConfig, batch: int, cache_len: int,
                 device):
    dt = _dtype(cfg)
    if kind in ("dense", "moe", "attn"):
        L = min(cfg.window or cache_len, cache_len) if kind == "attn" \
            else cache_len                 # the hybrid's ring
        shape = (batch, L, cfg.n_kv_heads, cfg.head_dim)
        return (torch.zeros(shape, dtype=dt, device=device),
                torch.zeros(shape, dtype=dt, device=device))
    if kind == "rec":
        return rglru_init_cache(cfg.d_model, batch, cfg.conv_kernel, dt,
                                device)
    if kind == "ssm":
        return ssm_init_cache(cfg.d_model, cfg.ssm_state, batch,
                              cfg.ssm_headdim, cfg.ssm_expand,
                              cfg.conv_kernel, dt, device)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """One zero entry per layer: a (k, v) pair of (batch, L, n_kv,
    head_dim) for attention (L = cache_len, or min(window, cache_len) for
    the hybrid's ring), ``{"conv", "h"}`` for RG-LRU and SSM (``conv`` in
    the model's dtype, ``h`` float32)."""
    require_ported(cfg)
    dev = resolve_device(device)
    return [_layer_cache(kind, cfg, batch, cache_len, dev)
            for kind in layer_kinds(cfg)]


# -- prefill ------------------------------------------------------------------

def prefill_forward(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
                    cache_len: int | None = None,
                    img_embeds: torch.Tensor | None = None):
    """Prefill: returns (last-token logits (B, 1, V_padded), cache).  Only
    the last position is normalised and projected onto the vocabulary.
    MoE layers dispatch with ``cfg.moe_capacity``."""
    require_ported(cfg)
    B, S = tokens.shape
    cache_len = cache_len or S
    x = _embed(params, cfg, tokens, img_embeds)
    cache = []
    for kind, layer in zip(params.kinds, params.layers):
        x, _, c = _apply_layer(kind, layer, x, cfg, "prefill",
                               cfg.moe_capacity, cache_len=cache_len)
        cache.append(c)
    x = apply_norm(cfg.norm, x[:, -1:], params.final_norm)
    return x @ _head(params, cfg).to(x.dtype), cache


# -- decode -------------------------------------------------------------------

def decode_step(params: LM, cfg: ModelConfig, cache, tokens: torch.Tensor,
                pos: int):
    """One token for the whole batch.  tokens: (B, 1); pos: Python int.
    Returns (logits (B, 1, V_padded), cache); attention caches are updated
    in place, the recurrent states replaced.  MoE layers dispatch with
    capacity factor 2.0, as the reference's decode does."""
    require_ported(cfg)
    x = _embed(params, cfg, tokens)
    new_cache = []
    for kind, layer, c in zip(params.kinds, params.layers, cache):
        x, _, c = _apply_layer(kind, layer, x, cfg, "decode", 2.0, cache=c,
                               pos=pos)
        new_cache.append(c)
    x = apply_norm(cfg.norm, x, params.final_norm)
    return x @ _head(params, cfg).to(x.dtype), new_cache
