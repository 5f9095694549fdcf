"""The port's Mamba2 / SSD block and the SSM family on the CPU against the
JAX package, on the same parameters and inputs.

Parameters come from the reference's ``init_ssm`` / ``init_model``, as
numpy arrays, carried into the port by ``repro_torch.models.convert``;
inputs are drawn with numpy.  The block runs at d_model 64, ssm_state 16,
head dim 16 (eight heads) and the model on ``mamba2-smoke``.

Tolerances: the block in float32 within 1e-5 absolute plus relative (the
same arithmetic, contracted pairwise instead of by XLA's einsum); the
whole model within 1e-4 of the largest |logit| in float32 and within
atol = rtol = 2e-2 in bfloat16, as tests/test_torch_lm.py holds.
"""
import ast
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.serve import main as jax_main
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.launch import serve
from repro_torch.models import common as tcommon
from repro_torch.models import ssm as tssm
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import load_tree, params_from_jax

LAYER = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
CPU = torch.device("cpu")
D, N, HD = 64, 16, 16


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=LAYER):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want), **tol)


def _close_logits(got, want, share=1e-4):
    """Within ``share`` of the largest |logit| of the reference."""
    want = _np(want)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= share * np.abs(want).max(), (err, np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _block(seed=0):
    """Reference SSM params with drawn (not default) A_log, dt_bias, D,
    conv_b and norm_scale, and the port's module holding the same."""
    col = jcommon.ParamCollector(jax.random.PRNGKey(seed), dtype=jnp.float32)
    p, _ = jssm.init_ssm(col, D, N, HD)
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(seed)
    for name in ("A_log", "dt_bias", "D", "conv_b", "norm_scale"):
        p[name] = (rng.normal(size=p[name].shape) * 0.5).astype(np.float32)
    tp = load_tree(tssm.init_ssm(tcommon.ParamInit(None, torch.float32, CPU),
                                 D, N, HD), p)
    return jax.tree.map(jnp.asarray, p), tp


def _x(B, S, seed):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(
        np.float32)


# -- the block ----------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(20, 256), (18, 4), (7, 4)])
def test_ssm_forward_and_state(S, chunk):
    """One chunk (S 20), six chunks of three (S 18 at chunk 4: c = 3) and
    seven of one (S 7 at chunk 4: c = 1): output, conv tail and final
    state against the reference."""
    jp, tp = _block()
    x = _x(2, S, S)
    kw = dict(ssm_state=N, headdim=HD, chunk=chunk)
    jy, jc = jssm.ssm_forward(jp, jnp.asarray(x), return_state=True, **kw)
    ty, tc = tssm.ssm_forward(tp, torch.from_numpy(x), return_state=True,
                              **kw)
    _close(ty, jy)
    assert tc["conv"].shape == jc["conv"].shape
    _close(tc["conv"], jc["conv"])
    assert tc["h"].dtype == torch.float32
    _close(tc["h"], jc["h"])
    _close(tssm.ssm_forward(tp, torch.from_numpy(x), **kw), jy)


@pytest.mark.parametrize("S,chunk", [(20, 256), (18, 4), (7, 4)])
def test_ssm_decode_from_prefill_state(S, chunk):
    """Four decode steps from the prefill's state: outputs and caches."""
    jp, tp = _block()
    x = _x(2, S + 4, 100 + S)
    kw = dict(ssm_state=N, headdim=HD)
    _, jc = jssm.ssm_forward(jp, jnp.asarray(x[:, :S]), chunk=chunk,
                             return_state=True, **kw)
    _, tc = tssm.ssm_forward(tp, torch.from_numpy(x[:, :S]), chunk=chunk,
                             return_state=True, **kw)
    for t in range(S, S + 4):
        jy, jc = jssm.ssm_decode(jp, jnp.asarray(x[:, t:t + 1]), jc, **kw)
        ty, tc = tssm.ssm_decode(tp, torch.from_numpy(x[:, t:t + 1]), tc,
                                 **kw)
        assert ty.shape == (2, 1, D)
        _close(ty, jy)
        _close(tc["conv"], jc["conv"])
        _close(tc["h"], jc["h"])


def test_decode_continues_the_forward():
    """A prefill of S - 3 tokens and three decode steps give the last
    three rows of one S-token forward (the port against itself)."""
    _, tp = _block()
    x = torch.from_numpy(_x(2, 24, 9))
    kw = dict(ssm_state=N, headdim=HD)
    full = tssm.ssm_forward(tp, x, chunk=8, **kw)
    _, c = tssm.ssm_forward(tp, x[:, :21], chunk=8, return_state=True, **kw)
    for t in range(21, 24):
        y, c = tssm.ssm_decode(tp, x[:, t:t + 1], c, **kw)
        torch.testing.assert_close(y[:, 0], full[:, t], **LAYER)


def test_prefill_cache_owns_its_storage():
    """The conv tail and the state are copies: a view would keep the
    layer's whole (B, S, C) input and chunk states alive with the
    cache, for every layer of the model."""
    _, tp = _block()
    _, c = tssm.ssm_forward(tp, torch.from_numpy(_x(2, 40, 1)), ssm_state=N,
                            headdim=HD, chunk=8, return_state=True)
    for t in c.values():
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


@pytest.mark.parametrize("S,chunk,c", [
    (2048, 256, 256), (2560, 256, 256), (1920, 256, 240), (2432, 256, 152),
    (18, 4, 3), (7, 4, 1), (20, 256, 20)])
def test_chunk_rule(S, chunk, c):
    """The reference's rule: the largest divisor of S up to the chunk."""
    assert tssm._chunk(S, chunk) == c


def test_segsum():
    x = np.random.default_rng(3).normal(size=(2, 3, 6)).astype(np.float32)
    got = tssm._segsum(torch.from_numpy(x))
    want = _np(jssm._segsum(jnp.asarray(x)))
    upper = np.triu(np.ones((6, 6), bool), 1)
    assert np.isneginf(got.numpy()[..., upper]).all()
    np.testing.assert_allclose(got.numpy()[..., ~upper], want[..., ~upper],
                               **LAYER)


def test_ssm_bf16():
    """The block with bfloat16 weights and input: output in bfloat16, the
    state in float32, both within the bf16 tolerance."""
    jp, tp = _block()
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = tssm.init_ssm(tcommon.ParamInit(None, torch.bfloat16, CPU), D, N, HD)
    load_tree(tp, jax.tree.map(np.asarray, jp))
    x = jnp.asarray(_x(2, 16, 5)).astype(jnp.bfloat16)
    kw = dict(ssm_state=N, headdim=HD, chunk=8)
    jy, jc = jssm.ssm_forward(jp, x, return_state=True, **kw)
    ty, tc = tssm.ssm_forward(tp, torch.tensor(_np(x)).bfloat16(),
                              return_state=True, **kw)
    assert ty.dtype == tc["conv"].dtype == torch.bfloat16
    assert tc["h"].dtype == torch.float32
    _close(ty, jy, BF16)
    _close(tc["h"], jc["h"], BF16)


# -- the whole model ----------------------------------------------------------

def _configs(dtype="float32"):
    return (dataclasses.replace(jreg.get_config("mamba2-130m", smoke=True),
                                dtype=dtype),
            dataclasses.replace(treg.get_config("mamba2-130m", smoke=True),
                                dtype=dtype))


@functools.lru_cache(maxsize=None)
def _model(dtype="float32"):
    jcfg, tcfg = _configs(dtype)
    params, _ = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, tcfg, params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, CPU)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S),
                                                dtype=np.int32)


def test_forward_logits():
    jcfg, jp, tcfg, tm = _model()
    tok = _tokens(jcfg, 2, 40, 0)
    jl, _ = jtf.forward(jp, jcfg, jnp.asarray(tok), remat=False)
    tl, taux = ttf.forward(tm, tcfg, torch.from_numpy(tok))
    assert tl.shape == (2, 40, jcfg.vocab_padded)
    _close_logits(tl, jl)
    assert float(taux) == 0.0


def test_prefill_caches_and_decode():
    """Prefill 30 tokens, every cache leaf against the reference's
    stacked cache, then 4 decode steps; the last decode logits equal the
    port's forward."""
    jcfg, jp, tcfg, tm = _model()
    tok = _tokens(jcfg, 2, 34, 1)
    jl, jc = jtf.prefill_forward(jp, jcfg, jnp.asarray(tok[:, :30]),
                                 cache_len=34)
    tl, tc = ttf.prefill_forward(tm, tcfg, torch.from_numpy(tok[:, :30]),
                                 cache_len=34)
    _close_logits(tl, jl)

    def check_cache():
        stacked = jc["layers"]["0:ssm"]
        assert len(tc) == jcfg.n_layers and not jc["rem"]
        for i, c in enumerate(tc):
            for key in ("conv", "h"):
                _close(c[key], stacked[key][i], dict(atol=1e-4, rtol=1e-4))

    check_cache()
    step = jax.jit(lambda p, c, t, pos: jtf.decode_step(p, jcfg, c, t, pos))
    for t in range(30, 34):
        cur = tok[:, t:t + 1]
        jl, jc = step(jp, jc, jnp.asarray(cur), jnp.int32(t))
        tl, tc = ttf.decode_step(tm, tcfg, tc, torch.from_numpy(cur), t)
        _close_logits(tl, jl)
    check_cache()
    full, _ = ttf.forward(tm, tcfg, torch.from_numpy(tok))
    err = (tl[:, 0] - full[:, -1]).abs().max()
    assert err <= 1e-4 * full[:, -1].abs().max()


def test_bf16_forward_and_decode():
    jcfg, jp, tcfg, tm = _model("bfloat16")
    assert tm.embed.dtype == torch.bfloat16
    tok = _tokens(jcfg, 2, 24, 2)
    jl, _ = jtf.forward(jp, jcfg, jnp.asarray(tok), remat=False)
    tl, _ = ttf.forward(tm, tcfg, torch.from_numpy(tok))
    assert tl.dtype == torch.bfloat16
    _close(tl, jl, BF16)
    jl, jc = jtf.prefill_forward(jp, jcfg, jnp.asarray(tok[:, :20]),
                                 cache_len=24)
    tl, tc = ttf.prefill_forward(tm, tcfg, torch.from_numpy(tok[:, :20]),
                                 cache_len=24)
    _close(tl, jl, BF16)
    assert tc[0]["conv"].dtype == torch.bfloat16
    assert tc[0]["h"].dtype == torch.float32
    for t in range(20, 24):
        cur = tok[:, t:t + 1]
        jl, jc = jtf.decode_step(jp, jcfg, jc, jnp.asarray(cur),
                                 jnp.int32(t))
        tl, tc = ttf.decode_step(tm, tcfg, tc, torch.from_numpy(cur), t)
        _close(tl, jl, BF16)


def test_init_cache_matches_reference():
    _, _, tcfg, _ = _model()
    jcfg = _configs()[0]
    want = jtf._layer_cache("ssm", jcfg, 3, 12)
    cache = ttf.init_cache(tcfg, 3, 12, device="cpu")
    assert len(cache) == tcfg.n_layers
    for c in cache:
        assert set(c) == set(want)
        for key in want:
            assert tuple(c[key].shape) == want[key].shape
            assert str(c[key].dtype).split(".")[1] == str(want[key].dtype)
            assert not c[key].any()


def test_params_from_jax_fills_every_leaf():
    jcfg, jp, tcfg, tm = _model()
    assert all(isinstance(layer, ttf.SSMLayer) for layer in tm.layers)
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    stacked_leaves = len(jax.tree.leaves(jp["layers"]))
    assert len(list(tm.parameters())) == len(jax.tree.leaves(jp)) \
        + (jcfg.n_groups - 1) * stacked_leaves
    stacked = jp["layers"]["0:ssm"]["ssm"]
    for i, layer in enumerate(tm.layers):
        for name in ("w_dt", "conv_w", "A_log", "out_proj"):
            np.testing.assert_array_equal(getattr(layer.ssm, name).numpy(),
                                          np.asarray(stacked[name][i]))
    tree = jax.tree.map(np.asarray, jp)
    tree["layers"]["0:ssm"]["ssm"]["conv_w"] = np.zeros(
        (jcfg.n_groups, 3, 160), np.float32)
    with pytest.raises(ValueError, match="conv_w"):
        params_from_jax(tree, tcfg, CPU)


def test_init_model_steps_and_shapes():
    """Random init from a seed: the reference's shapes, the steps
    factories admit the family, and decode runs from a zero cache."""
    cfg = treg.get_config("mamba2-130m", smoke=True)
    m = ttf.init_model(cfg, seed=0, device="cpu")
    again = ttf.init_model(cfg, seed=0, device="cpu")
    assert torch.equal(m.layers[1].ssm.w_x, again.layers[1].ssm.w_x)
    ref = _model()[3]
    for (name, a), (_, b) in zip(m.named_parameters(),
                                 ref.named_parameters()):
        assert a.shape == b.shape, name
    assert m.lm_head is None
    tok = torch.from_numpy(_tokens(cfg, 2, 8, 3))
    logits, _ = tsteps.make_prefill(cfg)(m, {"tokens": tok})
    assert logits.shape == (2, 1, cfg.vocab_padded)
    logits, cache = tsteps.make_decode_step(cfg)(
        m, ttf.init_cache(cfg, 2, 8, "cpu"), tok[:, :1], 0)
    assert torch.isfinite(logits).all() and len(cache) == cfg.n_layers


def test_serves_from_the_cli(capsys, monkeypatch):
    """``--arch mamba2-130m --smoke`` serves on the CPU: the reference's
    first line and prompt ids, 32 + 2 ids printed, no kernel launched."""
    argv = ["--arch", "mamba2-130m", "--smoke", "--gen", "2"]
    monkeypatch.setattr("sys.argv", ["serve", *argv])
    jax_main()
    want = capsys.readouterr().out.splitlines()
    serve.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0].startswith(want[0] + " ")
    assert got[0].startswith("arch=mamba2-smoke batch=4 prompt=32 gen=2")
    assert "ms/token" in got[1]
    ids = ast.literal_eval(got[2].split(":", 1)[1])
    assert len(ids) == 34
    assert ids[:32] == ast.literal_eval(want[2].split(":", 1)[1])[:32]
    r = serve.serve_tokens(treg.get_config("mamba2-130m", smoke=True),
                           batch=2, prompt_len=16, gen=3, device="cpu")
    assert torch.isfinite(r["logits"]).all()
    assert not any(r["launches_prefill"].values())
    assert not any(r["launches_decode"].values())
