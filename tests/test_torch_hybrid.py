"""The port's RG-LRU block and the hybrid family (RG-LRU + local attention,
RecurrentGemma) on the CPU against the JAX package, on the same
parameters and inputs.

Parameters come from the reference's ``init_rglru`` / ``init_model``, as
numpy arrays, carried into the port by ``repro_torch.models.convert``;
inputs are drawn with numpy.  Models: ``rgemma-smoke`` (five layers: one
("rec", "rec", "attn") group and two unstacked ``rec`` remainder layers,
window 16) and the reference's ``test_decode_matches_forward`` hybrid
config (six layers, window 8: a 20-token run wraps the ring).

Tolerances: the block in float32 within 1e-5 absolute plus relative (the
same recurrence, scanned in another order); the whole model within 1e-4
of the largest |logit| in float32 and within atol = rtol = 2e-2 in
bfloat16, as tests/test_torch_lm.py holds.
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
from repro.models import rglru as jrglru
from repro.models import transformer as jtf
from repro.models.config import ModelConfig as JConfig
from repro_torch.configs import registry as treg
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import rglru as trglru
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.convert import load_tree, params_from_jax

LAYER = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
CPU = torch.device("cpu")
D = 64

# tests/test_models.py::test_decode_matches_forward's hybrid config
RING = dict(name="t-hybrid", family="hybrid", n_layers=6, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, dtype="float32",
            pattern=("rec", "rec", "attn"), window=8)


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
    """Reference RG-LRU params with drawn (not default) biases, conv bias
    and lambda, and the port's module holding the same."""
    col = jcommon.ParamCollector(jax.random.PRNGKey(seed), dtype=jnp.float32)
    p, _ = jrglru.init_rglru(col, D)
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(seed)
    for name in ("b_a", "b_x", "conv_b", "lam"):
        p[name] = rng.normal(size=p[name].shape).astype(np.float32)
    tp = load_tree(trglru.init_rglru(
        tcommon.ParamInit(None, torch.float32, CPU), D), p)
    return jax.tree.map(jnp.asarray, p), tp


def _x(B, S, seed):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(
        np.float32)


# -- the block ----------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 20, 64])
def test_rglru_forward_and_state(S):
    jp, tp = _block()
    x = _x(2, S, S)
    jy, jc = jrglru.rglru_forward(jp, jnp.asarray(x), return_state=True)
    ty, tc = trglru.rglru_forward(tp, torch.from_numpy(x), return_state=True)
    _close(ty, jy)
    assert tc["conv"].shape == jc["conv"].shape
    _close(tc["conv"], jc["conv"])
    assert tc["h"].dtype == torch.float32
    _close(tc["h"], jc["h"])
    _close(trglru.rglru_forward(tp, torch.from_numpy(x)), jy)


@pytest.mark.parametrize("S", [3, 20, 64])
def test_rglru_decode_from_prefill_state(S):
    """Four decode steps from the prefill's state: outputs and caches."""
    jp, tp = _block()
    x = _x(2, S + 4, 200 + S)
    _, jc = jrglru.rglru_forward(jp, jnp.asarray(x[:, :S]),
                                 return_state=True)
    _, tc = trglru.rglru_forward(tp, torch.from_numpy(x[:, :S]),
                                 return_state=True)
    for t in range(S, S + 4):
        jy, jc = jrglru.rglru_decode(jp, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = trglru.rglru_decode(tp, torch.from_numpy(x[:, t:t + 1]), tc)
        assert ty.shape == (2, 1, D)
        _close(ty, jy)
        _close(tc["conv"], jc["conv"])
        _close(tc["h"], jc["h"])


def test_prefill_cache_owns_its_storage():
    """The conv tail and the state are copies: a view would keep the
    layer's whole (B, S, D) input and scan output alive with the cache,
    for every rec layer of the model."""
    _, tp = _block()
    _, c = trglru.rglru_forward(tp, torch.from_numpy(_x(2, 40, 1)),
                                return_state=True)
    for t in c.values():
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


@pytest.mark.parametrize("S", [1, 2, 5, 64, 100])
def test_linear_scan_matches_the_loop(S):
    """The log-depth scan against the step-by-step recurrence in float64,
    with gates down to exp(-10.5) a step (no overflow, no NaN)."""
    rng = np.random.default_rng(S)
    la = -rng.uniform(0, 10.5, size=(2, S, 8))
    b = rng.normal(size=(2, S, 8))
    got = trglru.linear_scan(torch.from_numpy(la), torch.from_numpy(b))
    h = np.zeros((2, 8))
    for t in range(S):
        h = np.exp(la[:, t]) * h + b[:, t]
        np.testing.assert_allclose(got[:, t].numpy(), h, rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_tanh_matches_jax(dtype):
    """The gate's GeLU equals ``jax.nn.gelu`` bit for bit in bfloat16
    (the reference rounds its constants to bf16) and within 1e-6 in
    float32."""
    x = np.random.default_rng(8).normal(size=(4096,)).astype(np.float32) * 3
    jx = jnp.asarray(x).astype(dtype)
    want = _np(jax.nn.gelu(jx))
    got = trglru.gelu_tanh(torch.tensor(_np(jx)).to(getattr(torch, dtype)))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_rglru_bf16():
    jp, _ = _block()
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = load_tree(trglru.init_rglru(
        tcommon.ParamInit(None, torch.bfloat16, CPU), D),
        jax.tree.map(np.asarray, jp))
    x = jnp.asarray(_x(2, 16, 5)).astype(jnp.bfloat16)
    jy, jc = jrglru.rglru_forward(jp, x, return_state=True)
    ty, tc = trglru.rglru_forward(tp, torch.tensor(_np(x)).bfloat16(),
                                  return_state=True)
    assert ty.dtype == tc["conv"].dtype == torch.bfloat16
    assert tc["h"].dtype == torch.float32
    _close(ty, jy, BF16)
    _close(tc["h"], jc["h"], BF16)


# -- the whole model ----------------------------------------------------------

def _configs(which, dtype="float32"):
    if which == "ring":
        return (JConfig(**{**RING, "dtype": dtype}),
                TConfig(**{**RING, "dtype": dtype}))
    return (dataclasses.replace(jreg.get_config(which, smoke=True),
                                dtype=dtype),
            dataclasses.replace(treg.get_config(which, smoke=True),
                                dtype=dtype))


@functools.lru_cache(maxsize=None)
def _model(which, dtype="float32"):
    jcfg, tcfg = _configs(which, dtype)
    params, _ = jtf.init_model(jax.random.PRNGKey(1), jcfg)
    return jcfg, params, tcfg, params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, CPU)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S),
                                                dtype=np.int32)


def _ref_caches(jc, cfg):
    """The reference's cache as one entry per layer, in layer order."""
    U = len(cfg.unit)
    out = []
    for g in range(cfg.n_groups):
        for i, kind in enumerate(cfg.unit):
            out.append(jax.tree.map(lambda a: a[g],
                                    jc["layers"][f"{i}:{kind}"]))
    for j, kind in enumerate(cfg.remainder):
        out.append(jc["rem"][f"{j}:{kind}"])
    assert len(out) == cfg.n_groups * U + len(cfg.remainder)
    return out


def _check_caches(tc, jc, cfg):
    kinds = ttf.layer_kinds(cfg)
    for kind, got, want in zip(kinds, tc, _ref_caches(jc, cfg), strict=True):
        if kind == "attn":
            for a, b in zip(got, want, strict=True):
                assert a.shape == b.shape
                _close(a, b, dict(atol=1e-4, rtol=1e-4))
        else:
            assert set(got) == set(want) == {"conv", "h"}
            for key in want:
                _close(got[key], want[key], dict(atol=1e-4, rtol=1e-4))


MODELS = ("recurrentgemma-2b", "ring")


@pytest.mark.parametrize("which", MODELS)
def test_forward_logits(which):
    jcfg, jp, tcfg, tm = _model(which)
    tok = _tokens(jcfg, 2, 24, 0)
    jl, _ = jtf.forward(jp, jcfg, jnp.asarray(tok), remat=False)
    tl, taux = ttf.forward(tm, tcfg, torch.from_numpy(tok))
    assert tl.shape == (2, 24, jcfg.vocab_padded)
    _close_logits(tl, jl)
    assert float(taux) == 0.0


@pytest.mark.parametrize("which,S,cache_len", [
    ("recurrentgemma-2b", 20, 24),     # ring of 16 built at prefill, wraps
    ("recurrentgemma-2b", 10, 14),     # no ring: 14 slots, the first 10 set
    ("ring", 16, 20),                  # ring of 8 built at prefill, wraps
])
def test_prefill_caches_and_decode(which, S, cache_len):
    """Prefill S tokens, every cache leaf (the remainder's too) against
    the reference's, then 4 decode steps against the reference's; the
    last decode logits equal the port's forward at that position."""
    jcfg, jp, tcfg, tm = _model(which)
    tok = _tokens(jcfg, 2, S + 4, 1)
    jl, jc = jtf.prefill_forward(jp, jcfg, jnp.asarray(tok[:, :S]),
                                 cache_len=cache_len)
    tl, tc = ttf.prefill_forward(tm, tcfg, torch.from_numpy(tok[:, :S]),
                                 cache_len=cache_len)
    _close_logits(tl, jl)
    _check_caches(tc, jc, jcfg)
    step = jax.jit(lambda p, c, t, pos: jtf.decode_step(p, jcfg, c, t, pos))
    for t in range(S, S + 4):
        cur = tok[:, t:t + 1]
        jl, jc = step(jp, jc, jnp.asarray(cur), jnp.int32(t))
        tl, tc = ttf.decode_step(tm, tcfg, tc, torch.from_numpy(cur), t)
        _close_logits(tl, jl)
    _check_caches(tc, jc, jcfg)
    full, _ = ttf.forward(tm, tcfg, torch.from_numpy(tok))
    err = (tl[:, 0] - full[:, -1]).abs().max()
    assert err <= 1e-4 * full[:, -1].abs().max()


def test_decode_matches_forward_through_the_ring():
    """The reference test's run on the port: 20 decode steps from an
    empty cache (the ring of 8 wraps twice) against one forward, within
    1e-4 of the largest |logit|."""
    _, _, tcfg, tm = _model("ring")
    tok = torch.from_numpy(_tokens(tcfg, 2, 20, 2))
    full, _ = ttf.forward(tm, tcfg, tok)
    cache = ttf.init_cache(tcfg, 2, 20, device="cpu")
    assert cache[2][0].shape[1] == 8
    for t in range(20):
        lg, cache = ttf.decode_step(tm, tcfg, cache, tok[:, t:t + 1], t)
        err = (lg[:, 0] - full[:, t]).abs().max()
        assert err <= 1e-4 * full[:, t].abs().max(), (t, err)


def test_bf16_forward_and_decode():
    jcfg, jp, tcfg, tm = _model("recurrentgemma-2b", "bfloat16")
    assert tm.embed.dtype == torch.bfloat16
    tok = _tokens(jcfg, 2, 24, 3)
    jl, _ = jtf.forward(jp, jcfg, jnp.asarray(tok), remat=False)
    tl, _ = ttf.forward(tm, tcfg, torch.from_numpy(tok))
    assert tl.dtype == torch.bfloat16
    _close(tl, jl, BF16)
    jl, jc = jtf.prefill_forward(jp, jcfg, jnp.asarray(tok[:, :20]),
                                 cache_len=24)
    tl, tc = ttf.prefill_forward(tm, tcfg, torch.from_numpy(tok[:, :20]),
                                 cache_len=24)
    _close(tl, jl, BF16)
    for t in range(20, 24):
        cur = tok[:, t:t + 1]
        jl, jc = jtf.decode_step(jp, jcfg, jc, jnp.asarray(cur),
                                 jnp.int32(t))
        tl, tc = ttf.decode_step(tm, tcfg, tc, torch.from_numpy(cur), t)
        _close(tl, jl, BF16)


def test_local_attention_never_reaches_flash(monkeypatch):
    """The hybrid's attention takes the plain windowed path in forward
    and prefill, as the reference's does (and decode its own plain
    path): the flash wrapper is never called."""
    def refuse(*a, **k):
        raise AssertionError("the hybrid reached flash_attention")

    monkeypatch.setattr(tattn, "flash_attention", refuse)
    _, _, tcfg, tm = _model("recurrentgemma-2b")
    tok = torch.from_numpy(_tokens(tcfg, 2, 32, 4))
    ttf.forward(tm, tcfg, tok)
    _, cache = ttf.prefill_forward(tm, tcfg, tok, cache_len=34)
    ttf.decode_step(tm, tcfg, cache, tok[:, :1], 32)


@pytest.mark.parametrize("which", MODELS)
def test_init_cache_matches_reference(which):
    jcfg, _, tcfg, _ = _model(which)
    cache = ttf.init_cache(tcfg, 3, 24, device="cpu")
    kinds = ttf.layer_kinds(tcfg)
    assert len(cache) == len(kinds) == tcfg.n_layers
    for kind, c in zip(kinds, cache):
        want = jtf._layer_cache(kind, jcfg, 3, 24)
        got = c if kind == "attn" else [c[k] for k in sorted(want)]
        want = want if kind == "attn" else [want[k] for k in sorted(want)]
        for a, b in zip(got, want, strict=True):
            assert tuple(a.shape) == b.shape, kind
            assert str(a.dtype).split(".")[1] == str(b.dtype), kind
            assert not a.any()


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-130m"])
def test_layer_kinds_full_configs(arch):
    """Full configs: the unit repeated over the groups, then the
    remainder (recurrentgemma-2b: 8 x ("rec", "rec", "attn") + 2 rec)."""
    cfg = treg.get_config(arch)
    kinds = ttf.layer_kinds(cfg)
    jcfg = jreg.get_config(arch)
    assert kinds == list(jcfg.unit) * jcfg.n_groups + list(jcfg.remainder)
    assert len(kinds) == cfg.n_layers
    if arch == "recurrentgemma-2b":
        assert kinds.count("attn") == 8 and kinds[-2:] == ["rec", "rec"]


@pytest.mark.parametrize("which", MODELS)
def test_params_from_jax_fills_every_leaf(which):
    """Every leaf of the reference's tree, stacked groups and unstacked
    remainder, lands bit for bit on the port's parameter; a misfit leaf
    in the remainder is refused by name."""
    jcfg, jp, tcfg, tm = _model(which)
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    assert len(list(tm.parameters())) == len(jax.tree.leaves(jp)) \
        + (jcfg.n_groups - 1) * len(jax.tree.leaves(jp["layers"]))
    U = len(jcfg.unit)
    for l, (kind, layer) in enumerate(zip(tm.kinds, tm.layers)):
        assert isinstance(layer, ttf._LAYERS[kind])
        if kind == "rec":
            want = (jp["layers"][f"{l % U}:rec"]["rec"]["w_a"][l // U]
                    if l < jcfg.n_groups * U else
                    jp["rem"][f"{l - jcfg.n_groups * U}:rec"]["rec"]["w_a"])
            np.testing.assert_array_equal(layer.rec.w_a.numpy(),
                                          np.asarray(want))
    if jcfg.remainder:
        tree = jax.tree.map(np.asarray, jp)
        tree["rem"]["1:rec"]["rec"]["lam"] = np.ones(D + 1, np.float32)
        with pytest.raises(ValueError, match="lam"):
            params_from_jax(tree, tcfg, CPU)


def test_init_model_steps_and_shapes():
    cfg = treg.get_config("recurrentgemma-2b", smoke=True)
    m = ttf.init_model(cfg, seed=0, device="cpu")
    again = ttf.init_model(cfg, seed=0, device="cpu")
    assert torch.equal(m.layers[4].rec.w_x, again.layers[4].rec.w_x)
    ref = _model("recurrentgemma-2b")[3]
    for (name, a), (_, b) in zip(m.named_parameters(),
                                 ref.named_parameters(), strict=True):
        assert a.shape == b.shape, name
    tok = torch.from_numpy(_tokens(cfg, 2, 8, 5))
    logits, _ = tsteps.make_prefill(cfg)(m, {"tokens": tok})
    assert logits.shape == (2, 1, cfg.vocab_padded)
    logits, cache = tsteps.make_decode_step(cfg)(
        m, ttf.init_cache(cfg, 2, 8, "cpu"), tok[:, :1], 0)
    assert torch.isfinite(logits).all() and len(cache) == cfg.n_layers


def test_serves_from_the_cli(capsys, monkeypatch):
    """``--arch recurrentgemma-2b --smoke`` serves on the CPU: the
    reference's first line and prompt ids, 32 + 2 ids printed, no kernel
    launched (32 prompt tokens run past the smoke window of 16)."""
    argv = ["--arch", "recurrentgemma-2b", "--smoke", "--gen", "2"]
    monkeypatch.setattr("sys.argv", ["serve", *argv])
    jax_main()
    want = capsys.readouterr().out.splitlines()
    serve.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0].startswith(want[0] + " ")
    assert got[0].startswith("arch=rgemma-smoke batch=4 prompt=32 gen=2")
    assert "ms/token" in got[1]
    ids = ast.literal_eval(got[2].split(":", 1)[1])
    assert len(ids) == 34
    assert ids[:32] == ast.literal_eval(want[2].split(":", 1)[1])[:32]
    r = serve.serve_tokens(treg.get_config("recurrentgemma-2b", smoke=True),
                           batch=2, prompt_len=16, gen=3, device="cpu")
    assert torch.isfinite(r["logits"]).all()
    assert not any(r["launches_prefill"].values())
    assert not any(r["launches_decode"].values())
