"""The port's flash attention on the CPU against the JAX package's Pallas
kernel (interpret mode) and its jnp oracle.

On the CPU ``repro_torch.kernels.flash.flash_attention`` takes its plain
version, so this holds the yardstick that ``chip_smoke.py`` holds the CUDA
kernel against on the card.  Tolerances: 2e-3 against the Pallas kernel
(the tolerance of tests/test_kernels.py: online vs one-shot softmax in
float32), 1e-5 against the jnp oracle in float32 (the same one-shot
softmax, summed in another order).  Inputs are drawn with numpy and handed
to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash import flash_attention as jax_flash
from repro_torch.kernels import _build
from repro_torch.kernels.flash import flash_attention
from repro_torch.kernels.ref import flash_attention_ref


def _qkv(rng, B, H, S, D, Hkv=None, Sk=None):
    Hkv = Hkv or H
    Sk = Sk or S
    return (rng.normal(size=(B, H, S, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# the shapes of tests/test_kernels.py::test_flash_attention_kernel / _sweep
@pytest.mark.parametrize("B,H,S,D,causal", [(2, 4, 256, 64, True),
                                            (1, 2, 128, 64, True),
                                            (1, 2, 128, 64, False),
                                            (1, 2, 384, 64, True)])
def test_flash_matches_pallas_interpret(B, H, S, D, causal):
    q, k, v = _qkv(np.random.default_rng(S + B), B, H, S, D)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                interpret=True))
    got = flash_attention(*_t(q, k, v), causal=causal)
    assert got.shape == (B, H, S, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("S,Sk,causal", [(64, 64, True), (128, 128, False),
                                         (32, 96, True), (96, 32, False)])
def test_plain_matches_jnp_oracle(S, Sk, causal):
    q, k, v = _qkv(np.random.default_rng(S * 7 + Sk), 2, 3, S, 16, Sk=Sk)
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = flash_attention_ref(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("H,Hkv", [(8, 2), (4, 1), (6, 3)])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_matches_oracle_on_expanded_heads(H, Hkv, causal):
    q, k, v = _qkv(np.random.default_rng(H * 10 + Hkv), 2, H, 128, 32,
                   Hkv=Hkv)
    G = H // Hkv
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(np.repeat(k, G, axis=1)),
        jnp.asarray(np.repeat(v, G, axis=1)), causal=causal))
    got = flash_attention(*_t(q, k, v), causal=causal)
    assert got.shape == (2, H, 128, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_bf16_in_bf16_out():
    """bf16 inputs give a bf16 output that matches the Pallas kernel on
    the same bf16 inputs within bf16 rounding (2e-2: both keep the
    softmax in float32 and round only the output)."""
    q, k, v = _qkv(np.random.default_rng(5), 1, 2, 128, 64)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(qb, kb, vb, causal=True)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_flash(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (qb, kb, vb)),
        causal=True, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                               rtol=2e-2)


def test_strided_bshd_view_matches_contiguous():
    """A (B, S, H, D) buffer passed as its (B, H, S, D) transpose view — the
    LM's layout — gives the result of the contiguous copy."""
    rng = np.random.default_rng(9)
    x = [torch.from_numpy(rng.normal(size=(2, 128, 4, 16)).astype(np.float32))
         for _ in range(3)]
    views = [t.transpose(1, 2) for t in x]
    got = flash_attention(*views, causal=True)
    want = flash_attention(*(t.contiguous() for t in views), causal=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("shapes,match", [
    (((1, 2, 200, 16), (1, 2, 200, 16)), "tile"),
    (((1, 2, 128, 16), (1, 2, 256, 16)), "Sq == Sk"),
    (((1, 4, 128, 16), (1, 3, 128, 16)), "do not fit"),
])
def test_contract_checks(shapes, match):
    qs, ks = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, k, causal=True)


def test_cpu_takes_the_plain_version_and_launches_nothing():
    q, k, v = _t(*_qkv(np.random.default_rng(3), 1, 2, 64, 16))
    before = _build.launches()["flash"]
    got = flash_attention(q, k, v, causal=True)
    assert _build.launches()["flash"] == before
    torch.testing.assert_close(got, flash_attention_ref(q, k, v),
                               atol=0, rtol=0)


def test_wrapper_refuses_tensors_off_cpu_and_cuda():
    x = torch.zeros(1, 2, 64, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(x, x, x)


# ---- the two CUDA routes and flash_sm90's arithmetic ----------------------

def _bshd(shape, dtype=torch.bfloat16, width=None):
    """A (B, S, H, D) buffer seen as (B, H, S, D), as gqa_attend hands it
    over; ``width`` pads each head row to that many elements first."""
    B, S, H, D = shape
    buf = torch.zeros(B, S, H, width or D, dtype=dtype)
    return buf[..., :D].transpose(1, 2)


def _route(q, k, v):
    from repro_torch.kernels.flash import _byte_strides, flash_route
    return flash_route(q.dtype, q.shape[-1],
                       [_byte_strides(t) for t in (q, k, v)],
                       [t.data_ptr() for t in (q, k, v)])


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, "flash_sm90"), (torch.bfloat16, 128, "flash_sm90"),
    (torch.bfloat16, 16, "flash"), (torch.bfloat16, 80, "flash"),
    (torch.float32, 64, "flash"), (torch.float32, 128, "flash"),
    (torch.float32, 16, "flash"), (torch.float32, 80, "flash")])
def test_route_depends_on_dtype_and_head_dim(dtype, D, want):
    q = _bshd((2, 256, 4, D), dtype)
    k = _bshd((2, 256, 2, D), dtype)
    assert _route(q, k, k) == want


def test_tma_contract_passes_a_contiguous_bshd_view():
    q, k = _bshd((2, 256, 16, 64)), _bshd((2, 256, 4, 64))
    assert _route(q, k, k) == "flash_sm90"
    # an axis of size 1 has no stride that matters
    q1 = _bshd((1, 128, 1, 128))
    assert _route(q1, q1, q1) == "flash_sm90"


@pytest.mark.parametrize("which", ["stride", "pointer", "head_dim"])
def test_tma_contract_violations_raise(which):
    good = _bshd((2, 256, 4, 64))
    if which == "stride":          # head rows 68 elements apart: 136 B
        bad = _bshd((2, 256, 4, 64), width=68)
    elif which == "pointer":       # one element past an aligned base
        flat = torch.zeros(2 * 256 * 4 * 64 + 1, dtype=torch.bfloat16)
        bad = flat[1:].view(2, 256, 4, 64).transpose(1, 2)
    else:                          # the head dim strided
        bad = torch.zeros(2, 4, 256, 128, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="TMA|contiguous"):
        _route(good, bad, good)
    # the same tensors in float32 go to the CUDA-core kernel unchecked
    assert _route(good.float(), bad.float(), good.float()) == "flash"


_LOG2E = np.float32(1.4426950408889634)


def _sm90_emulation(q, k, v, causal):
    """flash_sm90's arithmetic in plain PyTorch, for the test only: key
    tiles of 128 with the online rescale, scores as f32 sums of exact bf16
    products, the row max taken on the raw scores and scale*log2(e) applied
    with it (exp2(s c - m c)), P rounded to bf16 before the PV product, l
    summed from the rounded P, output in bf16."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    c = float(_LOG2E / np.sqrt(np.float32(D)))
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros(B, H, Sq, 1)
    acc = torch.zeros(B, H, Sq, D)
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, 128):
        kpos = k0 + torch.arange(128)[None, :]
        kt = torch.zeros(B, H, 128, D)
        vt = torch.zeros(B, H, 128, D)
        n = min(128, Sk - k0)           # TMA fills rows past Sk with zeros
        kt[:, :, :n], vt[:, :, :n] = kf[:, :, k0:k0 + n], vf[:, :, k0:k0 + n]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt)
        dead = kpos >= Sk
        if causal:
            dead = dead | (kpos > qpos)
        s = s.masked_fill(dead, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - m_new * c).to(torch.bfloat16).float()
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, vt)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


def _bf16_qkv(seed, B, H, Sq, D, Sk=None):
    q, k, v = _qkv(np.random.default_rng(seed), B, H, Sq, D, Sk=Sk)
    return [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]


# 8e-3 absolute and relative: chip_smoke.py's bf16 limit for the kernel
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", [
    (1, 2, 2048, 2048, 64, True), (1, 2, 1024, 1024, 128, True),
    (1, 2, 128, 384, 64, False), (1, 2, 128, 384, 128, False),
    (1, 2, 64, 64, 64, True)])
def test_sm90_arithmetic_matches_plain_version(B, H, Sq, Sk, D, causal):
    q, k, v = _bf16_qkv(Sq + D, B, H, Sq, D, Sk=Sk)
    got = _sm90_emulation(q, k, v, causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == want.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=8e-3, rtol=8e-3)


@pytest.mark.parametrize("causal", [True, False])
def test_sm90_arithmetic_matches_pallas_interpret(causal):
    q, k, v = _bf16_qkv(11, 1, 2, 256, 64)
    got = _sm90_emulation(q, k, v, causal)
    want = np.asarray(jax_flash(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        causal=causal, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=8e-3,
                               rtol=8e-3)
