"""Whisper-style encoder-decoder (arXiv:2212.04356), backbone only, ported
from ``src/repro/models/encdec.py``.

The conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, n_frames, d_model).  Encoder: non-causal
self attention and a GELU MLP, sinusoidal positions.  Decoder: causal self
attention, cross attention to the encoder output and a GELU MLP, learned
positions (``pos_dec``).  LayerNorm throughout (pre-norm); no RoPE; the
head is the tied embedding.

The reference stacks the encoder and decoder layers on a leading axis and
scans them; here :class:`EncDec` holds one module per layer in the
``nn.ModuleList``s ``enc`` and ``dec``, under the reference's names
(``enc.<l>.attn.wq``, ``dec.<l>.xattn.wk``, ``norm_enc.scale``, ...), so
:mod:`.convert` maps one onto the other.

Attention: the encoder's self attention and a prefill's cross attention
are non-causal calls with Sq > 1, and the decoder's self attention in a
prefill is causal, so all three go to the flash kernel on the card
(:func:`.attention.gqa_attend`); a decode step's cross attention is the
plain path at Sq = 1.  The reference computes a prefill's cross k and v
twice per layer (in ``_cross_attend`` and again for the cache); here they
are computed once, used, and kept.

The cache is a list with one entry per decoder layer: ``((k, v), (xk,
xv))``, the self-attention pair of (B, cache_len, n_kv, head_dim), updated
in place by a decode step, and the cross pair of (B, n_frames, n_kv,
head_dim); each tensor owns its storage.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .attention import (attn_decode, attn_forward, attn_prefill,
                        gqa_attend, init_attention)
from .common import ParamInit, apply_norm, init_norm
from .config import ModelConfig
from .mlp import init_mlp, mlp_forward
from ..kernels.flash import needs_grad
from .transformer import _dtype, remat_layers, run_layer


@functools.lru_cache(maxsize=8)
def _sinusoid(length: int, d: int) -> torch.Tensor:
    """The encoder's (length, d) position table, [sin | cos], computed in
    float64 NumPy and cast to float32, as the reference does (bit-equal);
    on the host, cached (do not write into it)."""
    pos = np.arange(length)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * dim / d))
    return torch.from_numpy(np.concatenate(
        [np.sin(ang), np.cos(ang)], axis=1).astype(np.float32))


class EncLayer(nn.Module):
    """``norm1``, self ``attn``, ``norm2``, the GELU ``ffn``."""

    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__()
        self.norm1 = init_norm(init, cfg.d_model, cfg.norm)
        self.attn = init_attention(init, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim)
        self.norm2 = init_norm(init, cfg.d_model, cfg.norm)
        self.ffn = init_mlp(init, cfg.d_model, cfg.d_ff, cfg.activation)


class DecLayer(EncLayer):
    """An encoder layer's parameters, then ``norm_x`` and the cross
    attention ``xattn`` (drawn in that order, as the reference does)."""

    def __init__(self, init: ParamInit, cfg: ModelConfig):
        super().__init__(init, cfg)
        self.norm_x = init_norm(init, cfg.d_model, cfg.norm)
        self.xattn = init_attention(init, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.head_dim)


class EncDec(nn.Module):
    """``embed`` (``vocab_padded`` rows, also the head), ``pos_dec``
    (``max_seq`` rows), the ``enc`` and ``dec`` layers, ``norm_enc`` and
    ``norm_dec``."""

    def __init__(self, cfg: ModelConfig, init: ParamInit):
        super().__init__()
        self.embed = init.param((cfg.vocab_padded, cfg.d_model), scale=0.02)
        self.pos_dec = init.param((cfg.max_seq, cfg.d_model), scale=0.02)
        self.enc = nn.ModuleList(EncLayer(init, cfg)
                                 for _ in range(cfg.enc_layers))
        self.dec = nn.ModuleList(DecLayer(init, cfg)
                                 for _ in range(cfg.n_layers))
        self.norm_enc = init_norm(init, cfg.d_model, cfg.norm)
        self.norm_dec = init_norm(init, cfg.d_model, cfg.norm)


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> EncDec:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    drawn in the reference's order with its initializers (see
    :func:`.transformer.init_model`).  ``device=None`` is the card."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return EncDec(cfg, ParamInit(gen, _dtype(cfg), dev))


def _attn_kw(cfg: ModelConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                use_rope=False)   # Whisper: learned / sinusoidal positions


def _cross_kv(p: nn.Module, enc_out: torch.Tensor, cfg: ModelConfig):
    """The cross attention's k and v from the encoder output: (B, Se,
    n_kv, head_dim) each."""
    B, Se, _ = enc_out.shape
    shape = (B, Se, cfg.n_kv_heads, cfg.head_dim)
    return ((enc_out @ p.wk).reshape(shape),
            (enc_out @ p.wv).reshape(shape))


def _cross_attend(p: nn.Module, h: torch.Tensor, k, v, cfg: ModelConfig):
    """q from the decoder's normed ``h`` against the encoder's k, v."""
    B, S, _ = h.shape
    q = (h @ p.wq).reshape(B, S, cfg.n_heads, cfg.head_dim)
    out = gqa_attend(q, k, v, causal=False)
    return out.reshape(B, S, -1) @ p.wo


def _mlp(p: nn.Module, x, cfg: ModelConfig):
    return x + mlp_forward(p.ffn, apply_norm(cfg.norm, x, p.norm2),
                           cfg.activation)


def _enc_layer(p: EncLayer, x, cfg: ModelConfig):
    h = apply_norm(cfg.norm, x, p.norm1)
    x = x + attn_forward(p.attn, h, causal=False, **_attn_kw(cfg))
    return _mlp(p, x, cfg)


def encode(params: EncDec, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T, D) stub embeddings -> the encoder's states (B, T,
    D) in the model's dtype.  Where a gradient is needed, each layer runs
    under remat as ``transformer.remat_layers`` says."""
    dt = _dtype(cfg)
    remat = needs_grad(*params.parameters()) and remat_layers(cfg)
    x = frames.to(dt) + _sinusoid(frames.shape[1], cfg.d_model).to(
        frames.device, dt)
    for p in params.enc:
        x = run_layer(_enc_layer, p, x, cfg, remat=remat)
    return apply_norm(cfg.norm, x, params.norm_enc)


def check_positions(cfg: ModelConfig, end: int) -> None:
    """Raise ``ValueError`` unless decoder positions below ``end`` fit
    the learned table's ``max_seq`` rows.  The reference clamps the index
    past the table (it repeats the last row); the port refuses."""
    if end > cfg.max_seq:
        raise ValueError(f"{cfg.name}: decoder positions up to {end - 1} "
                         f"lie past the {cfg.max_seq} rows of pos_dec "
                         f"(max_seq)")


def _dec_embed(params: EncDec, cfg: ModelConfig, tokens: torch.Tensor,
               pos: int = 0) -> torch.Tensor:
    dt = _dtype(cfg)
    S = tokens.shape[1]
    check_positions(cfg, pos + S)
    return params.embed[tokens.long()].to(dt) \
        + params.pos_dec[pos:pos + S].to(dt)


def _logits(params: EncDec, cfg: ModelConfig, x: torch.Tensor):
    x = apply_norm(cfg.norm, x, params.norm_dec)
    return x @ params.embed.T.to(x.dtype)


def _dec_layer(p: DecLayer, x, enc_out, cfg: ModelConfig):
    h = apply_norm(cfg.norm, x, p.norm1)
    x = x + attn_forward(p.attn, h, causal=True, **_attn_kw(cfg))
    h = apply_norm(cfg.norm, x, p.norm_x)
    x = x + _cross_attend(p.xattn, h, *_cross_kv(p.xattn, enc_out, cfg),
                          cfg)
    return _mlp(p, x, cfg)


def forward(params: EncDec, cfg: ModelConfig, frames: torch.Tensor,
            tokens: torch.Tensor):
    """Full-sequence forward.  Returns (logits (B, S, V_padded), aux =
    0).  Where a gradient is needed, each encoder and decoder layer runs
    under remat as ``transformer.remat_layers`` says (the reference
    remats the audio family's layers whatever ``cfg.remat`` says; remat
    changes memory, not values)."""
    enc_out = encode(params, cfg, frames)
    remat = needs_grad(*params.parameters()) and remat_layers(cfg)
    x = _dec_embed(params, cfg, tokens)
    for p in params.dec:
        x = run_layer(_dec_layer, p, x, enc_out, cfg, remat=remat)
    return _logits(params, cfg, x), torch.zeros((), dtype=torch.float32,
                                                 device=x.device)


def init_cache(params: EncDec, cfg: ModelConfig, frames: torch.Tensor,
               cache_len: int):
    """The encoder's cross k / v for every decoder layer and zero self
    caches of ``cache_len`` slots."""
    enc_out = encode(params, cfg, frames)
    shape = (frames.shape[0], cache_len, cfg.n_kv_heads, cfg.head_dim)
    zeros = functools.partial(torch.zeros, shape, dtype=_dtype(cfg),
                              device=frames.device)
    return [((zeros(), zeros()), _cross_kv(p.xattn, enc_out, cfg))
            for p in params.dec]


def prefill_forward(params: EncDec, cfg: ModelConfig, frames: torch.Tensor,
                    tokens: torch.Tensor, cache_len: int | None = None):
    """Encode, then the decoder prefill.  Returns (last-token logits (B, 1,
    V_padded), cache)."""
    enc_out = encode(params, cfg, frames)
    cache_len = cache_len or tokens.shape[1]
    x = _dec_embed(params, cfg, tokens)
    cache = []
    for p in params.dec:
        h = apply_norm(cfg.norm, x, p.norm1)
        y, self_kv = attn_prefill(p.attn, h, cache_len, **_attn_kw(cfg))
        x = x + y
        h = apply_norm(cfg.norm, x, p.norm_x)
        cross_kv = _cross_kv(p.xattn, enc_out, cfg)
        x = x + _cross_attend(p.xattn, h, *cross_kv, cfg)
        x = _mlp(p, x, cfg)
        cache.append((self_kv, cross_kv))
    return _logits(params, cfg, x[:, -1:]), cache


def decode_step(params: EncDec, cfg: ModelConfig, cache,
                tokens: torch.Tensor, pos: int):
    """One token for the whole batch.  tokens: (B, 1); pos: Python int.
    Returns (logits (B, 1, V_padded), cache); the self caches are updated
    in place."""
    x = _dec_embed(params, cfg, tokens, pos)
    new_cache = []
    for p, (self_kv, cross_kv) in zip(params.dec, cache):
        h = apply_norm(cfg.norm, x, p.norm1)
        y, self_kv = attn_decode(p.attn, h, self_kv, pos, **_attn_kw(cfg))
        x = x + y
        h = apply_norm(cfg.norm, x, p.norm_x)
        x = x + _cross_attend(p.xattn, h, *cross_kv, cfg)
        x = _mlp(p, x, cfg)
        new_cache.append((self_kv, cross_kv))
    return _logits(params, cfg, x), new_cache
