"""The port's VLM family on the CPU against the JAX package: internvl2's
smoke config (two dense layers, GQA 4 / 2 at head dim 16, untied head)
whose first ``n_img_tokens`` (8) positions take image embeddings.

Parameters come from the reference's ``init_model(PRNGKey(0), cfg)`` as
numpy arrays, carried over by ``repro_torch.models.convert``; tokens and
image embeddings are drawn with numpy and handed to both packages.
Tolerances as tests/test_torch_lm.py: float32 atol = rtol = 1e-4, bfloat16
2e-2 (the dense bound).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_jax

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
ARCH = "internvl2-76b"
CPU = torch.device("cpu")


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=F32):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want), **tol)


@functools.lru_cache(maxsize=None)
def _model(dtype="float32"):
    jcfg = dataclasses.replace(jreg.get_config(ARCH, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(treg.get_config(ARCH, smoke=True), dtype=dtype)
    params, _ = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, tcfg, params_from_jax(tree, tcfg, CPU)


def _inputs(cfg, B, S, seed=0):
    """Tokens (B, S) and image embeddings (B, n_img_tokens, d_model),
    float32 of scale 0.02 as the serving launcher draws them."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, size=(B, S), dtype=np.int32)
    img = rng.normal(scale=0.02, size=(B, cfg.n_img_tokens, cfg.d_model))
    return tok, img.astype(np.float32)


def test_params_from_jax():
    """Every leaf of the reference's tree lands on the port's parameter of
    the same name, bit for bit; the head is untied."""
    jcfg, jp, tcfg, tm = _model()
    assert jcfg.family == "vlm" and jcfg.n_img_tokens == 8
    stacked = jp["layers"]["0:dense"]
    assert len(tm.layers) == jcfg.n_layers
    for i, layer in enumerate(tm.layers):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                getattr(layer.attn, name).numpy(),
                np.asarray(stacked["attn"][name][i]))
        np.testing.assert_array_equal(layer.ffn.w3.numpy(),
                                      np.asarray(stacked["ffn"]["w3"][i]))
    np.testing.assert_array_equal(tm.lm_head.numpy(),
                                  np.asarray(jp["lm_head"]))
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))


def test_forward_with_image_prefix():
    """Full-sequence logits with the image prefix agree with the
    reference's, and the prefix changes them (the embeddings are used)."""
    jcfg, jp, tcfg, tm = _model()
    tok, img = _inputs(jcfg, 2, 32)
    jl, jaux = jtf.forward(jp, jcfg, jnp.asarray(tok),
                           img_embeds=jnp.asarray(img), remat=False)
    tl, taux = ttf.forward(tm, tcfg, torch.from_numpy(tok),
                           img_embeds=torch.from_numpy(img))
    assert tl.shape == (2, 32, jcfg.vocab_padded)
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0
    plain, _ = ttf.forward(tm, tcfg, torch.from_numpy(tok))
    assert (plain - tl).abs().max() > 1e-3


def test_prefill_with_image_prefix_and_cache():
    """Prefill 24 positions (8 of them image) into a 32-slot cache: the
    last-token logits and every layer's k and v agree."""
    jcfg, jp, tcfg, tm = _model()
    tok, img = _inputs(jcfg, 2, 24, seed=1)
    jl, jc = jtf.prefill_forward(jp, jcfg, jnp.asarray(tok), cache_len=32,
                                 img_embeds=jnp.asarray(img))
    tl, tc = ttf.prefill_forward(tm, tcfg, torch.from_numpy(tok),
                                 cache_len=32,
                                 img_embeds=torch.from_numpy(img))
    assert tl.shape == (2, 1, jcfg.vocab_padded)
    _close(tl, jl)
    jk, jv = jc["layers"]["0:dense"]
    assert len(tc) == jcfg.n_layers
    for i, (k, v) in enumerate(tc):
        assert k.shape == (2, 32, jcfg.n_kv_heads, jcfg.head_dim)
        _close(k, jk[i])
        _close(v, jv[i])


def test_prefill_then_five_decode_steps():
    """Prefill 20 positions with the image prefix, then feed 5 known
    tokens through ``decode_step``: logits agree with the reference's at
    every step, and the last equal the port's full forward at that
    position."""
    jcfg, jp, tcfg, tm = _model()
    tok, img = _inputs(jcfg, 2, 25, seed=2)
    jl, jc = jtf.prefill_forward(jp, jcfg, jnp.asarray(tok[:, :20]),
                                 cache_len=32, img_embeds=jnp.asarray(img))
    tl, tc = ttf.prefill_forward(tm, tcfg, torch.from_numpy(tok[:, :20]),
                                 cache_len=32,
                                 img_embeds=torch.from_numpy(img))
    _close(tl, jl)
    for t in range(20, 25):
        cur = tok[:, t:t + 1]
        jl, jc = jtf.decode_step(jp, jcfg, jc, jnp.asarray(cur),
                                 jnp.int32(t))
        tl, tc = ttf.decode_step(tm, tcfg, tc, torch.from_numpy(cur), t)
        _close(tl, jl)
    full, _ = ttf.forward(tm, tcfg, torch.from_numpy(tok),
                          img_embeds=torch.from_numpy(img))
    torch.testing.assert_close(tl[:, 0], full[:, -1], **F32)


def test_bf16_forward_prefill_and_decode():
    """bfloat16 weights carried over bit for bit: logits within 2e-2 of
    the reference's through the forward, the prefill and 3 decode
    steps."""
    jcfg, jp, tcfg, tm = _model("bfloat16")
    assert tm.embed.dtype == torch.bfloat16
    tok, img = _inputs(jcfg, 2, 32, seed=3)
    jimg, timg = jnp.asarray(img), torch.from_numpy(img)
    jl, _ = jtf.forward(jp, jcfg, jnp.asarray(tok), img_embeds=jimg,
                        remat=False)
    tl, _ = ttf.forward(tm, tcfg, torch.from_numpy(tok), img_embeds=timg)
    assert tl.dtype == torch.bfloat16
    _close(tl, jl, BF16)
    jl, jc = jtf.prefill_forward(jp, jcfg, jnp.asarray(tok[:, :29]),
                                 cache_len=32, img_embeds=jimg)
    tl, tc = ttf.prefill_forward(tm, tcfg, torch.from_numpy(tok[:, :29]),
                                 cache_len=32, img_embeds=timg)
    _close(tl, jl, BF16)
    for t in range(29, 32):
        cur = tok[:, t:t + 1]
        jl, jc = jtf.decode_step(jp, jcfg, jc, jnp.asarray(cur),
                                 jnp.int32(t))
        tl, tc = ttf.decode_step(tm, tcfg, tc, torch.from_numpy(cur), t)
        _close(tl, jl, BF16)


def test_steps_prefill_passes_the_image_embeddings():
    """``make_prefill`` hands ``batch["img_embeds"]`` to the transformer's
    prefill, as the reference's does."""
    _, _, tcfg, tm = _model()
    assert tsteps.model_module(tcfg) is ttf
    tok, img = (torch.from_numpy(a) for a in _inputs(tcfg, 2, 16))
    want, _ = ttf.prefill_forward(tm, tcfg, tok, cache_len=20,
                                  img_embeds=img)
    got, cache = tsteps.make_prefill(tcfg, cache_len=20)(
        tm, {"tokens": tok, "img_embeds": img})
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert cache[0][0].shape[1] == 20


@pytest.mark.parametrize("n_img", [0, 8])
def test_image_prefix_only_overwrites_its_positions(n_img):
    """Positions past ``n_img_tokens`` keep their token embeddings; with
    ``n_img_tokens = 0`` the embeddings are ignored, as the reference
    ignores them."""
    _, _, tcfg, tm = _model()
    cfg = dataclasses.replace(tcfg, n_img_tokens=n_img)
    tok, img = _inputs(tcfg, 2, 12, seed=4)
    x = ttf._embed(tm, cfg, torch.from_numpy(tok), torch.from_numpy(img))
    plain = tm.embed[torch.from_numpy(tok).long()]
    torch.testing.assert_close(x[:, n_img:], plain[:, n_img:], atol=0,
                               rtol=0)
    torch.testing.assert_close(x[:, :n_img],
                               torch.from_numpy(img)[:, :n_img], atol=0,
                               rtol=0)
