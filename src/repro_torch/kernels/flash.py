"""Flash attention forward (online softmax), the LM stack's attention
kernel.

``flash_attention`` launches the hand-written CUDA kernel
``csrc/flash_attn.cu`` for tensors on the card.  It replaces the Pallas TPU
kernel ``src/repro/kernels/flash.py::flash_attention`` (body
``_flash_kernel``) and keeps its contract: (B, H, S, D) in, (B, H, S, D) out
in q's dtype, scale ``D^-1/2``, float32 softmax state, tiles of
``min(128, S)`` rows that must divide S.  The kernel tiles the work its own
way (the design note is in the source).  Beyond the TPU kernel, k and v may
have fewer heads than q (``Hkv`` dividing ``H``); the kernel reads kv head
``h // (H // Hkv)`` by index.

Inputs are read through their strides (the last axis contiguous), so a
(B, S, H, D) buffer passed as ``x.transpose(1, 2)`` is read in place, and
the output is allocated like q, with q's strides: the LM's attention hands
over its (B, S, H, D) projections this way and gets a (B, S, H, D) buffer
back without a transpose copy.

Tensors on the CPU go to the plain version
(:func:`.ref.flash_attention_ref`); on any other device the wrapper
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import flash_attention_ref

TILE = 128                        # the TPU kernel's bq = bk
HEAD_DIMS = (16, 64, 80, 128)     # the dense configs' head dims
_FN = {torch.float32: "flash_attn_f32", torch.bfloat16: "flash_attn_bf16"}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) -> (B, H, Sq, D) in q's
    dtype.  Softmax scale 1/sqrt(D).  Sq and Sk must be multiples of
    ``min(128, S)``; a causal call needs Sq == Sk (the TPU kernel's mask and
    its oracle's differ otherwise)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} are not "
                         "(B, H, S, D) with k and v alike")
    B, H, Sq, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    if Bk != B or Dk != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if Sq % min(TILE, Sq) or Sk % min(TILE, Sk):
        raise ValueError(f"flash_attention: pad sequence to tile multiples "
                         f"(Sq={Sq}, Sk={Sk}, tile {TILE})")
    if causal and Sq != Sk:
        raise ValueError(f"flash_attention: causal needs Sq == Sk "
                         f"(got {Sq}, {Sk})")
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"flash_attention: q, k, v must lie on one CUDA "
                         f"device (got {q.device}, {k.device}, {v.device})")
    if q.dtype not in _FN or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    if B * H > 65535:
        raise ValueError(f"flash_attention: B*H={B * H} exceeds the grid")
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    fn_name = _FN[q.dtype]
    fn = _build.launcher("flash", fn_name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, H, Hkv, Sq, Sk, D, strides, int(causal), stream)
    _build.check(err, fn_name)
    _build.count("flash")
    return out
