"""GQA attention: full-sequence (chunked, causal / sliding-window), prefill
and decode-with-cache paths, ported from ``src/repro/models/attention.py``.

Full-sequence attention with no window and no query offset goes to
:func:`..kernels.flash.flash_attention` on every device: on the card that
is the CUDA flash kernel, on the CPU its plain version.  A causal call
(Sq == Sk) whose length is not a multiple of the kernel's tile is
zero-padded at the end and cut back (the causal mask hides the padded keys
from every real query).  A non-causal call with Sq > 1 (the encoder's self
attention, the cross attention of a prefill) goes as it is, at any Sq and
Sk: the kernel masks the keys past Sk itself.  Every other case takes the
plain chunked path, which is the reference's ``gqa_attend`` loop: the
windowed and offset calls, every decode step (Sq == 1), and every call
that needs a gradient (the kernels have no backward; the reference trains
through this loop too).  The
reference's opt-in ``causal_skip_min_seq`` / ``_causal_chunked_skip`` (a
CPU-memory workaround, off by default) is not ported: the flash kernel
already skips the masked upper triangle.

Precision: the chunked path rounds the softmax weights to v's dtype before
the PV product, as the reference does; the flash kernel keeps them in
float32, as the TPU kernel does.  In bfloat16 the two differ at bf16
rounding.

The decode step writes the new key and value into the cache in place (the
reference returns updated copies); it returns the same tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash import TILE, flash_attention, needs_grad
from .common import ParamInit, apply_rope, rope_inv_freq, rope_table

_NEG = -1e30


class Attention(nn.Module):
    """Projections ``x @ W`` with W of shape (in, out), as in the
    reference; optional q/k/v biases."""

    def __init__(self, init: ParamInit, d_model: int, n_heads: int,
                 n_kv: int, head_dim: int, qkv_bias: bool = False):
        super().__init__()
        self.wq = init.param((d_model, n_heads * head_dim))
        self.wk = init.param((d_model, n_kv * head_dim))
        self.wv = init.param((d_model, n_kv * head_dim))
        self.wo = init.param((n_heads * head_dim, d_model))
        for name, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            if qkv_bias:
                setattr(self, name, init.param((width * head_dim,),
                                               init="zeros"))
            else:
                self.register_parameter(name, None)


def init_attention(init: ParamInit, d_model: int, n_heads: int, n_kv: int,
                   head_dim: int, qkv_bias: bool = False) -> Attention:
    return Attention(init, d_model, n_heads, n_kv, head_dim, qkv_bias)


def _project_qkv(p: Attention, x, n_heads, n_kv, head_dim, rope_theta,
                 pos_offset=0, use_rope=True):
    B, S, D = x.shape
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if p.bq is not None:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    q = q.reshape(B, S, n_heads, head_dim)
    k = k.reshape(B, S, n_kv, head_dim)
    v = v.reshape(B, S, n_kv, head_dim)
    if use_rope:
        cos, sin = rope_table(S, head_dim, rope_theta, offset=pos_offset,
                              device=x.device)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _pick_chunk(S: int, target: int = 512) -> int:
    c = min(S, target)
    while S % c:
        c -= 1
    return c


def gqa_attend(q, k, v, *, causal: bool = True, window: int | None = None,
               q_offset: int = 0, chunk: int | None = None):
    """q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd).  Hq % Hkv == 0.

    ``q_offset`` is the absolute position of q[0] (for windows).  The plain
    path walks query chunks; each step computes a (chunk, Sk) strip of
    scores in float32.  Where a gradient is needed (grad mode on and q, k
    or v requiring grad) every call takes the plain path, which autograd
    differentiates: it is the reference's training attention, rounding
    included.
    """
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    if window is None and q_offset == 0 and not needs_grad(q, k, v) and (
            Sq == Sk if causal else Sq > 1):
        pad = -Sq % min(TILE, Sq) if causal else 0
        if pad:
            q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal)
        return out.transpose(1, 2)[:, :Sq]
    G = Hq // Hkv
    scale = hd ** -0.5
    qg = q.reshape(B, Sq, Hkv, G, hd)
    chunk = chunk or _pick_chunk(Sq)
    kpos = torch.arange(Sk, device=q.device)
    kf, vf = k.float(), v.float()
    outs = []
    for ci in range(Sq // chunk):
        qc = qg[:, ci * chunk:(ci + 1) * chunk].float()
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qc, kf) * scale
        qpos = q_offset + ci * chunk + torch.arange(chunk, device=q.device)
        mask = torch.ones((chunk, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        logits.masked_fill_(~mask, _NEG)
        p = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhgqk,bkhd->bqhgd", p.float(), vf))
    out = torch.cat(outs, dim=1).reshape(B, Sq, Hq, hd)
    return out.to(q.dtype)


def attn_forward(p: Attention, x, *, n_heads, n_kv, head_dim,
                 rope_theta=10000.0, causal=True, window=None,
                 use_rope=True):
    """Full-sequence path."""
    B, S, D = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, rope_theta,
                           use_rope=use_rope)
    out = gqa_attend(q, k, v, causal=causal, window=window)
    return out.reshape(B, S, n_heads * head_dim) @ p.wo


def attn_prefill(p: Attention, x, cache_len, *, n_heads, n_kv, head_dim,
                 rope_theta=10000.0, window=None, use_rope=True):
    """Prefill: forward + build the KV cache (zero-padded to cache_len)."""
    B, S, D = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, rope_theta,
                           use_rope=use_rope)
    out = gqa_attend(q, k, v, causal=True, window=window)
    y = out.reshape(B, S, n_heads * head_dim) @ p.wo
    if window is not None and cache_len <= S:
        # ring-buffer cache (hybrid local attention): keep the last
        # cache_len positions at slots pos % cache_len, matching attn_decode
        L = cache_len
        slots = torch.arange(S - L, S, device=x.device) % L
        kc = k.new_zeros((B, L, n_kv, head_dim))
        vc = v.new_zeros((B, L, n_kv, head_dim))
        kc[:, slots] = k[:, S - L:]
        vc[:, slots] = v[:, S - L:]
        return y, (kc, vc)
    kc = k.new_zeros((B, cache_len, n_kv, head_dim))
    vc = v.new_zeros((B, cache_len, n_kv, head_dim))
    kc[:, :S] = k
    vc[:, :S] = v
    return y, (kc, vc)


def attn_decode(p: Attention, x, cache, pos: int, *, n_heads, n_kv,
                head_dim, rope_theta=10000.0, window=None, use_rope=True):
    """One decode step.  x: (B, 1, D); cache: (k, v) each (B, L, Hkv, hd),
    updated in place; pos: the current absolute position (a Python int,
    the same across the batch).  Attention runs in float32 over the whole
    cache, masked to the filled slots."""
    B, _, D = x.shape
    kc, vc = cache
    L = kc.shape[1]
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, 1, n_heads, head_dim)
    k = k.reshape(B, 1, n_kv, head_dim)
    v = v.reshape(B, 1, n_kv, head_dim)
    if use_rope:
        ang = rope_inv_freq(head_dim, rope_theta, x.device) * float(pos)
        cos, sin = torch.cos(ang)[None, :], torch.sin(ang)[None, :]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    kpos = torch.arange(L, device=x.device)
    if window is None:
        kc[:, pos] = k[:, 0]
        vc[:, pos] = v[:, 0]
        valid = kpos <= pos
    else:
        slot = pos % L                     # ring buffer of size window
        kc[:, slot] = k[:, 0]
        vc[:, slot] = v[:, 0]
        age = (pos - kpos) % L             # ring: 0 = current
        valid = (age < L) & ((kpos <= pos) | (pos >= L))
    G = n_heads // n_kv
    qg = q.reshape(B, n_kv, G, head_dim)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                          kc.float()) * head_dim ** -0.5
    logits.masked_fill_(~valid, _NEG)
    pr = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", pr, vc.float())
    out = out.reshape(B, 1, n_heads * head_dim).to(x.dtype)
    return out @ p.wo, (kc, vc)
