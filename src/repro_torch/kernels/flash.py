"""Flash attention forward (online softmax), the LM stack's attention
kernel.

``flash_attention`` launches one of two hand-written CUDA kernels for
tensors on the card, picked by :func:`flash_route` from dtype and head dim
alone:

* ``flash_sm90`` (``csrc/flash_attn_sm90.cu``): bf16 with head dim 64 or
  128, both products on the tensor cores (wgmma) with TMA-fed tiles; P is
  rounded to bf16 before the PV product;
* ``flash`` (``csrc/flash_attn.cu``): float32 (every head dim) and bf16
  with head dim 16 or 80, both products by ``mma.sync`` on the tensor
  cores: bf16 as bf16 with P rounded to bf16, float32 as 3xTF32 (each
  product split into three TF32 products, at float32's accuracy).

Both replace the Pallas TPU kernel
``src/repro/kernels/flash.py::flash_attention`` (body ``_flash_kernel``)
and keep its contract: (B, H, S, D) in, (B, H, S, D) out in q's dtype,
scale ``D^-1/2``, float32 softmax state; a causal call takes tiles of
``min(128, S)`` rows that must divide S.  Each kernel tiles the work its
own way (the design notes are in the sources).  Beyond the TPU kernel, k
and v may have fewer heads than q (``Hkv`` dividing ``H``), read as kv
head ``h // (H // Hkv)``; and a non-causal call takes any Sq and Sk, no
tile multiple needed: both kernels mask the keys at or past Sk, load the
rows past Sq or Sk as zeros (TMA's out-of-bounds fill, ``cp.async``'s
zero-size copy) and store only the rows below Sq.

Inputs are read through their strides (the last axis contiguous), so a
(B, S, H, D) buffer passed as ``x.transpose(1, 2)`` is read in place, and
the output is allocated like q, with q's strides: the LM's attention hands
over its (B, S, H, D) projections this way and gets a (B, S, H, D) buffer
back without a transpose copy.

Tensors on the CPU go to the plain version
(:func:`.ref.flash_attention_ref`); on any other device the wrapper
launches the kernel its route names or raises.

Neither kernel has a backward, nor has the TPU kernel (``jax.grad``
through it raises).  So the wrapper raises ``RuntimeError`` on every
device, the CPU's plain route included, when grad mode is on and q, k or
v requires grad: a kernel's output written through ctypes has no autograd
history, and the gradients of the projections before it would be lost
without an error.  Serving calls it under ``torch.no_grad()``; training
takes the plain attention.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import flash_attention_ref

TILE = 128                        # the TPU kernel's bq = bk
HEAD_DIMS = (16, 64, 80, 128)     # the dense configs' head dims
SM90_HEAD_DIMS = (64, 128)        # bf16 head dims of flash_sm90
_FN = {torch.float32: "flash_attn_f32", torch.bfloat16: "flash_attn_bf16"}


def flash_route(dtype: torch.dtype, head_dim: int, byte_strides,
                pointers) -> str:
    """The kernel library that takes a CUDA call: ``"flash_sm90"`` for
    bfloat16 with a head dim in :data:`SM90_HEAD_DIMS`, ``"flash"``
    otherwise.  The route depends on dtype and head dim alone.

    Both kernels copy with 16-byte units (TMA for ``flash_sm90``,
    ``cp.async`` for ``flash``), so the tensors must meet that contract,
    else this raises ``ValueError`` (never another route): the head dim
    contiguous, every base pointer and every outer byte stride a multiple
    of 16.  ``byte_strides`` holds, for each of q, k and v, the byte strides
    of its four axes, None for an axis of size 1 (whose stride is never
    used); ``pointers`` holds their data pointers."""
    route = ("flash_sm90" if dtype == torch.bfloat16
             and head_dim in SM90_HEAD_DIMS else "flash")
    copy = "TMA" if route == "flash_sm90" else "cp.async"
    for name, st, ptr in zip("qkv", byte_strides, pointers):
        if st[-1] != dtype.itemsize:
            raise ValueError(f"flash_attention: {name}'s head dim is not "
                             f"contiguous (byte stride {st[-1]})")
        if ptr % 16:
            raise ValueError(f"flash_attention: {name}'s data pointer is "
                             f"not 16-byte aligned, as {copy} needs")
        bad = [s for s in st[:-1] if s is not None and s % 16]
        if bad:
            raise ValueError(f"flash_attention: {name}'s byte strides "
                             f"{tuple(st)} are not multiples of 16, as "
                             f"{copy} needs")
    return route


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record an op on ``tensors``: grad mode is on
    and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensors)


def _byte_strides(t: torch.Tensor) -> tuple:
    return tuple(None if n == 1 else s * t.element_size()
                 for n, s in zip(t.shape, t.stride()))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) -> (B, H, Sq, D) in q's
    dtype.  Softmax scale 1/sqrt(D).  A causal call needs Sq == Sk (the
    TPU kernel's mask and its oracle's differ otherwise), a multiple of
    ``min(128, S)``; a non-causal call takes any Sq and Sk."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} are not "
                         "(B, H, S, D) with k and v alike")
    B, H, Sq, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    if Bk != B or Dk != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if causal and Sq != Sk:
        raise ValueError(f"flash_attention: causal needs Sq == Sk "
                         f"(got {Sq}, {Sk})")
    if causal and Sq % min(TILE, Sq):
        raise ValueError(f"flash_attention: pad a causal sequence to a tile "
                         f"multiple (S={Sq}, tile {TILE})")
    if needs_grad(q, k, v):
        raise RuntimeError("flash_attention has no backward: call it under "
                           "torch.no_grad(), or take the plain attention "
                           "(models.attention.gqa_attend does) where a "
                           "gradient is needed")
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
    name = flash_route(q.dtype, D, [_byte_strides(t) for t in (q, k, v)],
                       [t.data_ptr() for t in (q, k, v)])
    out = torch.empty_like(q)

    def outer(t):
        # element strides of b, h, s; an axis of size 1 is only ever
        # indexed at 0, so it gets D, which TMA also accepts
        return [st if n > 1 else D for n, st in zip(t.shape[:3],
                                                     t.stride()[:3])]

    strides = (ctypes.c_longlong * 12)(*outer(q), *outer(k), *outer(v),
                                       *outer(out))
    fn_name = "flash_sm90_bf16" if name == "flash_sm90" else _FN[q.dtype]
    fn = _build.launcher(name, fn_name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, H, Hkv, Sq, Sk, D, strides, int(causal), stream)
    _build.check(err, fn_name)
    _build.count(name)
    return out
