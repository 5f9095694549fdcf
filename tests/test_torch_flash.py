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


# ---- the two CUDA routes and the kernels' arithmetic ----------------------

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
    # their float32 copies (68 floats = 272 B apart, or contiguous and
    # freshly allocated) meet flash's cp.async contract
    assert _route(good.float(), bad.float(), good.float()) == "flash"


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 80),
                                     (torch.bfloat16, 16),
                                     (torch.float32, 64),
                                     (torch.float32, 80)])
@pytest.mark.parametrize("which", ["stride", "pointer"])
def test_cp_async_contract_violations_raise(dtype, D, which):
    """flash's route copies 16-byte chunks with cp.async: a view whose
    row stride or data pointer is off a 16-byte boundary raises, an aligned
    one passes."""
    good = _bshd((2, 256, 4, D), dtype)
    assert _route(good, good, good) == "flash"
    half = 8 // good.element_size()           # elements in 8 bytes
    if which == "stride":          # head rows D + 8 B apart
        bad = _bshd((2, 256, 4, D), dtype, width=D + half)
    else:                          # 8 bytes past an aligned base
        flat = torch.zeros(2 * 256 * 4 * D + half, dtype=dtype)
        bad = flat[half:].view(2, 256, 4, D).transpose(1, 2)
    with pytest.raises(ValueError, match="cp.async"):
        _route(good, good, bad)


_LOG2E = np.float32(1.4426950408889634)


def _tf32(x):
    """float32 rounded to tf32 as ``cvt.rna.tf32.f32`` does: to 10 mantissa
    bits, ties away from zero.  On the int32 view the magnitude is the low
    31 bits, so adding half of the dropped 13 bits' range and clearing them
    rounds the magnitude whatever the sign."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product_3xtf32(eq, a, b):
    """einsum ``eq`` of float32 a and b as flash's 3xTF32 mma.sync does it:
    x = hi + lo with hi = tf32(x), lo = tf32(x - hi); lo*hi + hi*lo + hi*hi,
    lo*lo dropped."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _emulation(q, k, v, causal, tile, tf32x3=False):
    """A flash kernel's arithmetic in plain PyTorch, for the tests only: key
    tiles of ``tile`` with the online rescale, the row max taken on the raw
    scores and scale*log2(e) applied with it (exp2(s c - m c)), output in
    q's dtype.  bf16 (flash_sm90 with tile 128, flash with tile 64): scores
    as f32 sums of exact bf16 products, P rounded to bf16 before the PV
    product, l summed from the rounded P.  ``tf32x3`` (flash in float32,
    tile 32): both products in 3xTF32, P kept in float32."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    c = float(_LOG2E / np.sqrt(np.float32(D)))
    product = _product_3xtf32 if tf32x3 else torch.einsum
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros(B, H, Sq, 1)
    acc = torch.zeros(B, H, Sq, D)
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, tile):
        kpos = k0 + torch.arange(tile)[None, :]
        kt = torch.zeros(B, H, tile, D)
        vt = torch.zeros(B, H, tile, D)
        n = min(tile, Sk - k0)          # rows past Sk are zero-filled
        kt[:, :, :n], vt[:, :, :n] = kf[:, :, k0:k0 + n], vf[:, :, k0:k0 + n]
        s = product("bhqd,bhkd->bhqk", qf, kt)
        dead = kpos >= Sk
        if causal:
            dead = dead | (kpos > qpos)
        s = s.masked_fill(dead, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - m_new * c)
        if not tf32x3:
            p = p.to(torch.bfloat16).float()
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + product("bhqk,bhkd->bhqd", p, vt)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _bf16_qkv(seed, B, H, Sq, D, Sk=None):
    q, k, v = _qkv(np.random.default_rng(seed), B, H, Sq, D, Sk=Sk)
    return [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]


# 8e-3 absolute and relative: chip_smoke.py's bf16 limit for the kernels.
# Key tile 128 is flash_sm90's (head dims 64, 128), 64 is flash's (16, 80).
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,tile", [
    (1, 2, 2048, 2048, 64, True, 128), (1, 2, 1024, 1024, 128, True, 128),
    (1, 2, 128, 384, 64, False, 128), (1, 2, 128, 384, 128, False, 128),
    (1, 2, 64, 64, 64, True, 128),
    (1, 2, 2048, 2048, 80, True, 64), (1, 2, 256, 256, 16, True, 64),
    (1, 2, 128, 384, 80, False, 64), (1, 2, 96, 96, 80, True, 64),
    (1, 2, 64, 64, 16, False, 64)])
def test_sm90_arithmetic_matches_plain_version(B, H, Sq, Sk, D, causal,
                                               tile):
    q, k, v = _bf16_qkv(Sq + D, B, H, Sq, D, Sk=Sk)
    got = _emulation(q, k, v, causal, tile)
    want = flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == want.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=8e-3, rtol=8e-3)


@pytest.mark.parametrize("D,tile", [(64, 128), (16, 64), (80, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_sm90_arithmetic_matches_pallas_interpret(causal, D, tile):
    q, k, v = _bf16_qkv(11, 1, 2, 256, D)
    got = _emulation(q, k, v, causal, tile)
    want = np.asarray(jax_flash(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        causal=causal, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=8e-3,
                               rtol=8e-3)


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0 + 2.0 ** -11          # halfway between two tf32 values
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12,
                      3.0], dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 1.0 + 2.0 ** -10,
            3.0]
    assert _tf32(x).tolist() == want


# 3xTF32 against the plain float32 version: each product keeps about 21
# bits (the rounding of lo and the dropped lo*lo, 2^-22 of it), so outputs
# of magnitude below 4 at these lengths differ by about 1e-6; 1e-5 leaves
# a tenfold margin and is 200 times tighter than the kernel's 2e-3 limit.
@pytest.mark.parametrize("D", [16, 64, 80, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_arithmetic_matches_plain_version(D, causal):
    q, k, v = _t(*_qkv(np.random.default_rng(D + causal), 1, 2, 256, D))
    got = _emulation(q, k, v, causal, 32, tf32x3=True)
    want = flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_tf32_inputs_alone_miss_f32_level():
    """Why 3xTF32: rounding q, k and v to tf32 alone (hi*hi, the plain TF32
    product) moves the output by far more than the 1e-5 above."""
    q, k, v = _t(*_qkv(np.random.default_rng(2), 1, 2, 256, 64))
    want = flash_attention_ref(q, k, v).numpy()
    one_term = flash_attention_ref(*(_tf32(t) for t in (q, k, v))).numpy()
    assert np.abs(one_term - want).max() > 1e-4


# 2e-3: the tolerance of tests/test_kernels.py against the Pallas kernel
@pytest.mark.parametrize("D", [16, 64, 80, 128])
def test_3xtf32_arithmetic_matches_pallas_interpret(D):
    q, k, v = _qkv(np.random.default_rng(D), 1, 2, 256, D)
    got = _emulation(*_t(q, k, v), True, 32, tf32x3=True)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)
