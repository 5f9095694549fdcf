"""The port's audio family (``repro_torch.models.encdec``) on the CPU
against the JAX package's ``repro.models.encdec``: whisper's smoke config
(2 encoder and 2 decoder layers, d_model 64, 4 heads of 16, 32 frames,
layernorm, GELU, tied embeddings).

Parameters come from the reference's ``init_model(PRNGKey(0), cfg)`` as
numpy arrays, carried over by ``repro_torch.models.convert``; frames and
tokens are drawn with numpy and handed to both packages.  Tolerances as
tests/test_torch_lm.py: float32 atol = rtol = 1e-4, bfloat16 2e-2.  The
GeLU MLP in bfloat16 is held bit for bit: the port evaluates
``jax.nn.gelu`` with the reference's bf16-rounded constants.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import encdec as jed
from repro.models import mlp as jmlp
from repro_torch.configs import registry as treg
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import encdec as ted
from repro_torch.models import mlp as tmlp
from repro_torch.models import steps as tsteps
from repro_torch.models.convert import load_tree, params_from_jax, to_tensor

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
ARCH = "whisper-tiny"
CPU = torch.device("cpu")


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=F32):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want), **tol)


@functools.lru_cache(maxsize=None)
def _model(dtype="float32"):
    jcfg = dataclasses.replace(jreg.get_config(ARCH, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(treg.get_config(ARCH, smoke=True), dtype=dtype)
    params, _ = jed.init_model(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, tcfg, params_from_jax(tree, tcfg, CPU)


def _inputs(cfg, B, S, seed=0):
    """Frames (B, n_frames, d_model), float32 of scale 0.02 as the serving
    launcher draws them, and tokens (B, S)."""
    rng = np.random.default_rng(seed)
    frames = rng.normal(scale=0.02, size=(B, cfg.n_frames, cfg.d_model))
    tok = rng.integers(0, cfg.vocab, size=(B, S), dtype=np.int32)
    return frames.astype(np.float32), tok


def _check_cache(tc, jc):
    """The port's per-layer ((k, v), (xk, xv)) against the reference's
    layer-stacked ``self_k`` / ``self_v`` / ``cross_k`` / ``cross_v``."""
    assert len(tc) == jc["self_k"].shape[0]
    for i, ((k, v), (xk, xv)) in enumerate(tc):
        for got, key in ((k, "self_k"), (v, "self_v"), (xk, "cross_k"),
                         (xv, "cross_v")):
            assert got.shape == jc[key].shape[1:], key
            _close(got, jc[key][i])


@pytest.mark.parametrize("length,d", [(32, 64), (1500, 384), (7, 10)])
def test_sinusoid_bit_equal(length, d):
    want = np.asarray(jed._sinusoid(length, d))
    got = ted._sinusoid(length, d)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_params_from_jax():
    """Every leaf of the reference's tree (encoder and decoder layers
    stacked on a leading axis) lands on the port's parameter of the same
    name, bit for bit; the head is the tied embedding."""
    jcfg, jp, tcfg, tm = _model()
    assert len(tm.enc) == jcfg.enc_layers and len(tm.dec) == jcfg.n_layers
    for group, layers in (("enc", tm.enc), ("dec", tm.dec)):
        for name, param in layers.named_parameters():
            i, *keys = name.split(".")
            leaf = jp[group]
            for key in keys:
                leaf = leaf[key]
            np.testing.assert_array_equal(param.numpy(),
                                          np.asarray(leaf[int(i)]))
    for name in ("embed", "pos_dec"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(jp[name]))
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    assert not hasattr(tm, "lm_head")


def test_encode():
    jcfg, jp, tcfg, tm = _model()
    frames, _ = _inputs(jcfg, 2, 1)
    want = jed.encode(jp, jcfg, jnp.asarray(frames))
    got = ted.encode(tm, tcfg, torch.from_numpy(frames))
    assert got.shape == (2, jcfg.n_frames, jcfg.d_model)
    _close(got, want)


def test_forward_logits():
    jcfg, jp, tcfg, tm = _model()
    frames, tok = _inputs(jcfg, 2, 24, seed=1)
    jl, jaux = jed.forward(jp, jcfg, jnp.asarray(frames), jnp.asarray(tok))
    tl, taux = ted.forward(tm, tcfg, torch.from_numpy(frames),
                           torch.from_numpy(tok))
    assert tl.shape == (2, 24, jcfg.vocab_padded)
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0


def test_init_cache():
    """Cross k / v of every decoder layer from the encoder, zero self
    caches of ``cache_len`` slots."""
    jcfg, jp, tcfg, tm = _model()
    frames, _ = _inputs(jcfg, 2, 1, seed=2)
    jc = jed.init_cache(jp, jcfg, jnp.asarray(frames), 40)
    tc = ted.init_cache(tm, tcfg, torch.from_numpy(frames), 40)
    _check_cache(tc, jc)
    assert not any(t.any() for (k, v), _ in tc for t in (k, v))


def test_prefill_logits_and_every_cache_tensor():
    jcfg, jp, tcfg, tm = _model()
    frames, tok = _inputs(jcfg, 2, 20, seed=3)
    jl, jc = jed.prefill_forward(jp, jcfg, jnp.asarray(frames),
                                 jnp.asarray(tok), cache_len=32)
    tl, tc = ted.prefill_forward(tm, tcfg, torch.from_numpy(frames),
                                 torch.from_numpy(tok), cache_len=32)
    assert tl.shape == (2, 1, jcfg.vocab_padded)
    _close(tl, jl)
    _check_cache(tc, jc)


def test_prefill_cache_owns_its_storage():
    """Each cache tensor is its own allocation: no view keeps a larger
    per-layer tensor alive with the cache."""
    _, _, tcfg, tm = _model()
    frames, tok = _inputs(tcfg, 2, 20, seed=4)
    _, tc = ted.prefill_forward(tm, tcfg, torch.from_numpy(frames),
                                torch.from_numpy(tok), cache_len=32)
    for (k, v), (xk, xv) in tc:
        for t in (k, v, xk, xv):
            assert t.untyped_storage().nbytes() == \
                t.numel() * t.element_size()


def test_prefill_then_decode_sequence():
    """Prefill 24 tokens into a 32-slot cache, then feed 8 known tokens:
    logits and caches agree with the reference's at every step (the plain
    decode cross attention against the reference's), and the last equal
    the port's full forward at that position."""
    jcfg, jp, tcfg, tm = _model()
    frames, tok = _inputs(jcfg, 2, 32, seed=5)
    jf, tf = jnp.asarray(frames), torch.from_numpy(frames)
    jl, jc = jed.prefill_forward(jp, jcfg, jf, jnp.asarray(tok[:, :24]),
                                 cache_len=32)
    tl, tc = ted.prefill_forward(tm, tcfg, tf, torch.from_numpy(tok[:, :24]),
                                 cache_len=32)
    for t in range(24, 32):
        cur = tok[:, t:t + 1]
        jl, jc = jed.decode_step(jp, jcfg, jc, jnp.asarray(cur),
                                 jnp.int32(t))
        tl, tc = ted.decode_step(tm, tcfg, tc, torch.from_numpy(cur), t)
        assert tl.shape == (2, 1, jcfg.vocab_padded)
        _close(tl, jl)
    _check_cache(tc, jc)
    full, _ = ted.forward(tm, tcfg, tf, torch.from_numpy(tok))
    torch.testing.assert_close(tl[:, 0], full[:, -1], **F32)


def test_decode_from_init_cache():
    """Decode from position 0 on ``init_cache``'s empty self cache, as the
    reference's decode path allows."""
    jcfg, jp, tcfg, tm = _model()
    frames, tok = _inputs(jcfg, 2, 4, seed=6)
    jc = jed.init_cache(jp, jcfg, jnp.asarray(frames), 8)
    tc = ted.init_cache(tm, tcfg, torch.from_numpy(frames), 8)
    for t in range(4):
        cur = tok[:, t:t + 1]
        jl, jc = jed.decode_step(jp, jcfg, jc, jnp.asarray(cur),
                                 jnp.int32(t))
        tl, tc = ted.decode_step(tm, tcfg, tc, torch.from_numpy(cur), t)
        _close(tl, jl)


@pytest.mark.parametrize("Sq,Sk,H,Hkv", [(150, 300, 4, 2), (224, 1500, 6, 6),
                                         (7, 33, 4, 4)])
def test_non_causal_gqa_attend_at_ragged_lengths(Sq, Sk, H, Hkv,
                                                 monkeypatch):
    """A non-causal call with Sq > 1 reaches ``flash_attention`` once, as
    it is (no padding), and agrees with the reference's chunked
    ``gqa_attend``."""
    rng = np.random.default_rng(Sq + Sk)
    q = rng.normal(size=(2, Sq, H, 16)).astype(np.float32)
    k = rng.normal(size=(2, Sk, Hkv, 16)).astype(np.float32)
    v = rng.normal(size=(2, Sk, Hkv, 16)).astype(np.float32)
    seen = []
    flash = tattn.flash_attention

    def spy(q, k, v, *, causal):
        seen.append((tuple(q.shape), tuple(k.shape), causal))
        return flash(q, k, v, causal=causal)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    want = jattn.gqa_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=False)
    got = tattn.gqa_attend(*(torch.from_numpy(a) for a in (q, k, v)),
                           causal=False)
    assert seen == [((2, H, Sq, 16), (2, Hkv, Sk, 16), False)]
    assert got.shape == (2, Sq, H, 16)
    _close(got, want)


def test_decode_cross_attention_stays_plain(monkeypatch):
    """A non-causal call at Sq == 1 (every decode step's cross attention)
    takes the plain path: no flash call per decode step."""
    def spy(*a, **kw):
        raise AssertionError("flash_attention called at Sq == 1")

    monkeypatch.setattr(tattn, "flash_attention", spy)
    q = torch.randn(2, 1, 4, 16)
    k = v = torch.randn(2, 300, 4, 16)
    assert tattn.gqa_attend(q, k, v, causal=False).shape == (2, 1, 4, 16)


def test_gelu_mlp_bf16_bit_equal():
    """``mlp_forward`` with ``activation="gelu"`` in bfloat16 equals the
    reference's bit for bit on the same weights and inputs (whisper's
    dense MLP; ``F.gelu`` differed on about half the entries)."""
    col = jcommon.ParamCollector(jax.random.PRNGKey(3), dtype=jnp.bfloat16)
    p, _ = jmlp.init_mlp(col, 64, 176, "gelu")
    tp = load_tree(tmlp.init_mlp(tcommon.ParamInit(None, torch.bfloat16, CPU),
                                 64, 176, "gelu"),
                   jax.tree.map(np.asarray, p))
    x = np.random.default_rng(4).normal(size=(4, 32, 64)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jmlp.mlp_forward(p, jx, "gelu"))
    got = tmlp.mlp_forward(tp, to_tensor(np.asarray(jx), CPU), "gelu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


def test_bf16_forward_prefill_and_decode():
    """bfloat16 weights carried over bit for bit: logits within 2e-2 of
    the reference's through the forward, the prefill and 3 decode
    steps."""
    jcfg, jp, tcfg, tm = _model("bfloat16")
    assert tm.embed.dtype == torch.bfloat16
    frames, tok = _inputs(jcfg, 2, 32, seed=7)
    jf, tf = jnp.asarray(frames), torch.from_numpy(frames)
    jl, _ = jed.forward(jp, jcfg, jf, jnp.asarray(tok))
    tl, _ = ted.forward(tm, tcfg, tf, torch.from_numpy(tok))
    assert tl.dtype == torch.bfloat16
    _close(tl, jl, BF16)
    jl, jc = jed.prefill_forward(jp, jcfg, jf, jnp.asarray(tok[:, :29]),
                                 cache_len=32)
    tl, tc = ted.prefill_forward(tm, tcfg, tf, torch.from_numpy(tok[:, :29]),
                                 cache_len=32)
    _close(tl, jl, BF16)
    for t in range(29, 32):
        cur = tok[:, t:t + 1]
        jl, jc = jed.decode_step(jp, jcfg, jc, jnp.asarray(cur),
                                 jnp.int32(t))
        tl, tc = ted.decode_step(tm, tcfg, tc, torch.from_numpy(cur), t)
        _close(tl, jl, BF16)


def test_init_model_steps_and_shapes():
    """``init_model`` draws from its seed; ``steps`` routes the audio
    family to this module and hands ``batch["frames"]`` to its
    prefill."""
    cfg = treg.get_config(ARCH, smoke=True)
    a = ted.init_model(cfg, seed=0, device="cpu")
    b = ted.init_model(cfg, seed=0, device="cpu")
    c = ted.init_model(cfg, seed=1, device="cpu")
    assert torch.equal(a.dec[1].xattn.wk, b.dec[1].xattn.wk)
    assert not torch.equal(a.embed, c.embed)
    assert a.pos_dec.shape == (cfg.max_seq, cfg.d_model)
    assert not a.embed.requires_grad
    assert tsteps.model_module(cfg) is ted
    frames, tok = (torch.from_numpy(x) for x in _inputs(cfg, 2, 8))
    want, _ = ted.prefill_forward(a, cfg, frames, tok, cache_len=12)
    got, cache = tsteps.make_prefill(cfg, cache_len=12)(
        a, {"tokens": tok, "frames": frames})
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert cache[0][0][0].shape == (2, 12, cfg.n_kv_heads, cfg.head_dim)
    nxt, _ = tsteps.make_decode_step(cfg)(a, cache, tok[:, :1], 8)
    assert nxt.shape == (2, 1, cfg.vocab_padded)


def test_serves_on_the_cpu():
    """``serve_tokens`` serves the smoke config on the CPU: finite logits,
    ids in range, no kernel launched (the wrappers take their plain
    versions there)."""
    cfg = treg.get_config(ARCH, smoke=True)
    r = serve.serve_tokens(cfg, batch=2, prompt_len=24, gen=3, device="cpu")
    assert r["tokens"].shape == (2, 27)
    gen = r["tokens"][:, 24:]
    assert ((gen >= 0) & (gen < cfg.vocab)).all()
    assert torch.isfinite(r["logits"]).all()
    assert not any(r["launches_prefill"].values())
    assert not any(r["launches_decode"].values())


def test_positions_past_max_seq_raise():
    """A decoder position at or past ``max_seq`` (the rows of ``pos_dec``)
    raises ``ValueError``, where the reference clamps the index: in a
    decode step, in a prefill, and in ``serve_tokens`` before it draws the
    weights.  The last position that fits still decodes."""
    _, _, tcfg, tm = _model()
    frames, tok = (torch.from_numpy(x) for x in _inputs(tcfg, 1, 8))
    M = tcfg.max_seq
    _, cache = ted.prefill_forward(tm, tcfg, frames, tok, cache_len=M + 1)
    logits, cache = ted.decode_step(tm, tcfg, cache, tok[:, :1], M - 1)
    assert logits.shape == (1, 1, tcfg.vocab_padded)
    with pytest.raises(ValueError, match="max_seq"):
        ted.decode_step(tm, tcfg, cache, tok[:, :1], M)
    long = torch.zeros((1, M + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="max_seq"):
        ted.prefill_forward(tm, tcfg, frames, long)
    with pytest.raises(ValueError, match="max_seq"):
        serve.serve_tokens(tcfg, batch=1, prompt_len=M - 4, gen=8,
                           device="cpu")
