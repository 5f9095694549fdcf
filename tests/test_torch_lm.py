"""The port's dense LM stack on the CPU against the JAX package, module by
module and as a whole, on the same parameters and inputs.

Parameters come from the reference's own ``init_model(PRNGKey(0), cfg)``
(or its ``init_*`` functions), as numpy arrays, carried into the port by
``repro_torch.models.convert``; inputs are drawn with numpy.  Configs:
``qwen1.5-smoke`` (QKV bias, tied embeddings), ``stablelm-smoke``
(layernorm, untied) and ``qwen2.5-smoke`` (GQA with one kv head, head dim
16).

The MoE family runs on ``granite-smoke`` (GQA, tied embeddings, 4
experts top-2) and ``olmoe-smoke`` (8 experts top-2).

Tolerances: float32 atol = rtol = 1e-4 (the same arithmetic in another
summation order).  bfloat16: atol = rtol = 2e-2 on logits of magnitude
below 1, about five bf16 ulps there, set above the largest difference
seen on the smoke configs (about 1e-2): the two frameworks round
intermediates to bf16 at different points, and the flash path keeps the
softmax weights in f32 where the reference's chunked path rounds them.
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
from repro.models import mlp as jmlp
from repro.models import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import load_tree, params_from_jax, to_tensor

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
LM_ARCHS = ("qwen1.5-0.5b", "stablelm-3b", "qwen2.5-14b")
CPU = torch.device("cpu")


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=F32):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want), **tol)


def _configs(arch, dtype="float32"):
    return (dataclasses.replace(jreg.get_config(arch, smoke=True),
                                dtype=dtype),
            dataclasses.replace(treg.get_config(arch, smoke=True),
                                dtype=dtype))


@functools.lru_cache(maxsize=None)
def _model(arch, dtype="float32"):
    jcfg, tcfg = _configs(arch, dtype)
    params, _ = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, tcfg, params_from_jax(tree, tcfg, CPU)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S),
                                                dtype=np.int32)


# -- configs ------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_config_copies_match_reference(arch, smoke):
    j, t = jreg.get_config(arch, smoke), treg.get_config(arch, smoke)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("vocab_padded", "unit", "n_groups", "remainder",
                 "param_count", "active_param_count"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert treg.ARCHS == jreg.ARCHS


# -- norms, RoPE, MLP ---------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms(kind, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=(48,)).astype(np.float32)
    bias = rng.normal(size=(48,)).astype(np.float32)
    jd = jnp.dtype(dtype)
    jx, js, jb = (jnp.asarray(a, jd) for a in (x, scale, bias))
    tx, ts, tb = (to_tensor(np.asarray(a), CPU) for a in (jx, js, jb))
    if kind == "rmsnorm":
        want, got = jcommon.rmsnorm(jx, js), tcommon.rmsnorm(tx, ts)
    else:
        want = jcommon.layernorm(jx, js, jb)
        got = tcommon.layernorm(tx, ts, tb)
    assert got.dtype == tx.dtype
    _close(got, want, F32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("seq,hd,theta,offset", [(16, 16, 1e4, 0),
                                                 (7, 64, 1e6, 100),
                                                 (33, 32, 1e4, 2000)])
def test_rope(seq, hd, theta, offset):
    jc, js = jcommon.rope_table(seq, hd, theta, offset=offset)
    tc, ts = tcommon.rope_table(seq, hd, theta, offset=offset)
    _close(tc, jc)
    _close(ts, js)
    x = np.random.default_rng(seq).normal(size=(2, seq, 3, hd)).astype(
        np.float32)
    _close(tcommon.apply_rope(torch.from_numpy(x), tc, ts),
           jcommon.apply_rope(jnp.asarray(x), jc, js))


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_mlp(activation):
    col = jcommon.ParamCollector(jax.random.PRNGKey(3), dtype=jnp.float32)
    p, _ = jmlp.init_mlp(col, 32, 80, activation)
    tp = load_tree(tmlp.init_mlp(tcommon.ParamInit(None, torch.float32, CPU),
                                 32, 80, activation),
                   jax.tree.map(np.asarray, p))
    x = np.random.default_rng(4).normal(size=(2, 6, 32)).astype(np.float32)
    _close(tmlp.mlp_forward(tp, torch.from_numpy(x), activation),
           jmlp.mlp_forward(p, jnp.asarray(x), activation))


# -- attention ----------------------------------------------------------------

def _attn(H, Hkv, hd, d=48, bias=True, seed=5):
    """Reference attention params (biases drawn, not zero) and the port's
    module holding the same values."""
    col = jcommon.ParamCollector(jax.random.PRNGKey(seed),
                                 dtype=jnp.float32)
    p, _ = jattn.init_attention(col, d, H, Hkv, hd, qkv_bias=bias)
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        if name in p:
            p[name] = rng.normal(size=p[name].shape).astype(np.float32)
    tp = load_tree(tattn.init_attention(
        tcommon.ParamInit(None, torch.float32, CPU), d, H, Hkv, hd, bias), p)
    return {k: jnp.asarray(v) for k, v in p.items()}, tp


@pytest.mark.parametrize("H,Hkv,hd", [(4, 4, 16), (4, 2, 16), (5, 1, 16)])
@pytest.mark.parametrize("case", [
    dict(Sq=32, Sk=32),                                  # flash route
    dict(Sq=200, Sk=200),                      # flash route, padded to 256
    dict(Sq=32, Sk=32, causal=False),
    dict(Sq=32, Sk=32, window=8),
    dict(Sq=8, Sk=32, q_offset=24),
    dict(Sq=12, Sk=40, q_offset=28, window=16),
    dict(Sq=32, Sk=32, causal=False, chunk=8),
])
def test_gqa_attend(H, Hkv, hd, case):
    case = dict(case)
    Sq, Sk = case.pop("Sq"), case.pop("Sk")
    rng = np.random.default_rng(Sq + Sk + H)
    q = rng.normal(size=(2, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(2, Sk, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(2, Sk, Hkv, hd)).astype(np.float32)
    want = jattn.gqa_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **case)
    got = tattn.gqa_attend(*(torch.from_numpy(a) for a in (q, k, v)),
                           **case)
    assert got.shape == (2, Sq, H, hd)
    _close(got, want)


@pytest.mark.parametrize("S", [32, 128, 200, 300])
def test_causal_full_sequence_always_takes_flash(S, monkeypatch):
    """Every causal, window-free, offset-0 call with Sq == Sk reaches
    flash_attention, a ragged S zero-padded to the tile multiple."""
    seen = []

    def spy(q, k, v, *, causal):
        seen.append((tuple(q.shape), causal))
        return torch.zeros_like(q)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    q = torch.zeros(1, S, 4, 16)
    k = v = torch.zeros(1, S, 2, 16)
    out = tattn.gqa_attend(q, k, v)
    padded = S if S <= 128 else -(-S // 128) * 128
    assert seen == [((1, 4, padded, 16), True)]
    assert out.shape == (1, S, 4, 16)


@pytest.mark.parametrize("S", [128, 200])
def test_causal_full_sequence_off_cpu_never_runs_the_chunked_loop(S):
    """Off the CPU the causal full-sequence call goes to the kernel's
    wrapper, which launches or raises; on a device with no kernel it
    raises rather than running the plain chunked loop."""
    q = torch.zeros(1, S, 4, 16, device="meta")
    k = v = torch.zeros(1, S, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tattn.gqa_attend(q, k, v)


@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
def test_attn_forward(H, Hkv):
    jp, tp = _attn(H, Hkv, 16)
    x = np.random.default_rng(6).normal(size=(2, 32, 48)).astype(np.float32)
    kw = dict(n_heads=H, n_kv=Hkv, head_dim=16, rope_theta=1e4)
    _close(tattn.attn_forward(tp, torch.from_numpy(x), **kw),
           jattn.attn_forward(jp, jnp.asarray(x), **kw))


@pytest.mark.parametrize("window,cache_len", [(None, 40), (8, 8), (16, 16),
                                              (16, 40)])
def test_attn_prefill_then_decode(window, cache_len):
    """Prefill output and cache (the ring branch when window and
    cache_len <= S), then 4 decode steps: outputs and caches."""
    H, Hkv, hd, S = 4, 2, 16, 32
    jp, tp = _attn(H, Hkv, hd)
    kw = dict(n_heads=H, n_kv=Hkv, head_dim=hd, rope_theta=1e4,
              window=window)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, S, 48)).astype(np.float32)
    jy, jc = jattn.attn_prefill(jp, jnp.asarray(x), cache_len, **kw)
    ty, tc = tattn.attn_prefill(tp, torch.from_numpy(x), cache_len, **kw)
    _close(ty, jy)
    for a, b in zip(tc, jc):
        assert a.shape == b.shape
        _close(a, b)
    for step in range(4):
        xs = rng.normal(size=(2, 1, 48)).astype(np.float32)
        jy, jc = jattn.attn_decode(jp, jnp.asarray(xs), jc,
                                   jnp.int32(S + step), **kw)
        ty, tc = tattn.attn_decode(tp, torch.from_numpy(xs), tc, S + step,
                                   **kw)
        _close(ty, jy)
        for a, b in zip(tc, jc):
            _close(a, b)


# -- the whole model ----------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_logits(arch):
    jcfg, jp, tcfg, tm = _model(arch)
    tok = _tokens(jcfg, 2, 32)
    jl, jaux = jtf.forward(jp, jcfg, jnp.asarray(tok), remat=False)
    tl, taux = ttf.forward(tm, tcfg, torch.from_numpy(tok))
    assert tl.shape == (2, 32, jcfg.vocab_padded)
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_teacher_forced_decode(arch):
    """Prefill 24 tokens into a 32-slot cache, then feed 4 known tokens:
    logits and caches agree at every step, and the last decode logits equal
    the full forward's at that position."""
    jcfg, jp, tcfg, tm = _model(arch)
    tok = _tokens(jcfg, 2, 28, seed=1)
    jl, jc = jtf.prefill_forward(jp, jcfg, jnp.asarray(tok[:, :24]),
                                 cache_len=32)
    tl, tc = ttf.prefill_forward(tm, tcfg, torch.from_numpy(tok[:, :24]),
                                 cache_len=32)
    assert tl.shape == (2, 1, jcfg.vocab_padded)
    _close(tl, jl)

    def check_cache():
        jk, jv = jc["layers"]["0:dense"]
        assert len(tc) == jcfg.n_layers
        for i, (k, v) in enumerate(tc):
            _close(k, jk[i])
            _close(v, jv[i])

    check_cache()
    for t in range(4):
        cur = tok[:, 24 + t:25 + t]
        jl, jc = jtf.decode_step(jp, jcfg, jc, jnp.asarray(cur),
                                 jnp.int32(24 + t))
        tl, tc = ttf.decode_step(tm, tcfg, tc, torch.from_numpy(cur),
                                 24 + t)
        _close(tl, jl)
    check_cache()
    full, _ = ttf.forward(tm, tcfg, torch.from_numpy(tok))
    torch.testing.assert_close(tl[:, 0], full[:, -1], **F32)


# stablelm-smoke widened to stablelm-3b's head dim of 80 (d_model 160, two
# heads): the head dim of the bf16 path of the flash kernel
HD80 = dict(d_model=160, n_heads=2, n_kv_heads=2, head_dim=80)


def test_head_dim_80_prefill_and_teacher_forced_decode():
    """Prefill 32 tokens into a 40-slot cache, then feed 8 known tokens:
    last-token logits agree with the JAX package at every step."""
    jcfg = dataclasses.replace(jreg.get_config("stablelm-3b", smoke=True),
                               **HD80)
    tcfg = dataclasses.replace(treg.get_config("stablelm-3b", smoke=True),
                               **HD80)
    assert jcfg.head_dim == tcfg.head_dim == 80 and tcfg.n_layers == 2
    params, _ = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    tm = params_from_jax(jax.tree.map(np.asarray, params), tcfg, CPU)
    tok = _tokens(jcfg, 2, 40, seed=4)
    jl, jc = jtf.prefill_forward(params, jcfg, jnp.asarray(tok[:, :32]),
                                 cache_len=40)
    tl, tc = ttf.prefill_forward(tm, tcfg, torch.from_numpy(tok[:, :32]),
                                 cache_len=40)
    _close(tl, jl)
    for t in range(8):
        cur = tok[:, 32 + t:33 + t]
        jl, jc = jtf.decode_step(params, jcfg, jc, jnp.asarray(cur),
                                 jnp.int32(32 + t))
        tl, tc = ttf.decode_step(tm, tcfg, tc, torch.from_numpy(cur), 32 + t)
        _close(tl, jl)


def test_steps_factories_match_direct_calls():
    _, _, tcfg, tm = _model("qwen1.5-0.5b")
    tok = torch.from_numpy(_tokens(tcfg, 2, 16))
    want, cache = ttf.prefill_forward(tm, tcfg, tok)
    got, cache2 = tsteps.make_prefill(tcfg)(tm, {"tokens": tok})
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    cache = ttf.init_cache(tcfg, 2, 20, device="cpu")
    nxt = tok[:, :1]
    a, _ = tsteps.make_decode_step(tcfg)(tm, cache, nxt, 0)
    b, _ = ttf.decode_step(tm, tcfg, ttf.init_cache(tcfg, 2, 20, "cpu"),
                           nxt, 0)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_bf16_forward_and_decode():
    """bfloat16 weights (the reference's init cast to bf16, carried over
    bit for bit): logits within the bf16 tolerance of the module
    docstring, through the flash route and through decode."""
    jcfg, jp, tcfg, tm = _model("qwen1.5-0.5b", "bfloat16")
    assert tm.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tm.layers[1].attn.wq.view(torch.int16).numpy(),
        np.asarray(jp["layers"]["0:dense"]["attn"]["wq"][1]).view(np.int16))
    tok = _tokens(jcfg, 2, 32, seed=2)
    jl, _ = jtf.forward(jp, jcfg, jnp.asarray(tok), remat=False)
    tl, _ = ttf.forward(tm, tcfg, torch.from_numpy(tok))
    assert tl.dtype == torch.bfloat16
    _close(tl, jl, BF16)
    jl, jc = jtf.prefill_forward(jp, jcfg, jnp.asarray(tok[:, :28]),
                                 cache_len=32)
    tl, tc = ttf.prefill_forward(tm, tcfg, torch.from_numpy(tok[:, :28]),
                                 cache_len=32)
    _close(tl, jl, BF16)
    for t in range(4):
        cur = tok[:, 28 + t:29 + t]
        jl, jc = jtf.decode_step(jp, jcfg, jc, jnp.asarray(cur),
                                 jnp.int32(28 + t))
        tl, tc = ttf.decode_step(tm, tcfg, tc, torch.from_numpy(cur),
                                 28 + t)
        _close(tl, jl, BF16)


# -- construction -------------------------------------------------------------

def test_init_model_shapes_and_seed():
    cfg = treg.get_config("qwen1.5-0.5b", smoke=True)
    a = ttf.init_model(cfg, seed=0, device="cpu")
    b = ttf.init_model(cfg, seed=0, device="cpu")
    c = ttf.init_model(cfg, seed=1, device="cpu")
    ref_shapes = jax.tree.map(lambda x: x.shape, _model("qwen1.5-0.5b")[1])
    assert a.embed.shape == ref_shapes["embed"]
    assert a.layers[0].ffn.w3.shape == \
        ref_shapes["layers"]["0:dense"]["ffn"]["w3"][1:]
    assert a.lm_head is None and not a.embed.requires_grad
    n = sum(p.numel() for p in a.parameters())
    assert n == sum(int(np.prod(s)) for s in jax.tree.leaves(
        ref_shapes, is_leaf=lambda x: isinstance(x, tuple)))
    assert torch.equal(a.embed, b.embed)
    assert not torch.equal(a.embed, c.embed)
    torch.testing.assert_close(a.layers[0].attn.bq,
                               torch.zeros_like(a.layers[0].attn.bq))


@pytest.mark.parametrize("arch,module", [("internvl2-76b", "transformer"),
                                         ("whisper-tiny", "encdec")])
def test_vlm_and_audio_families_build(arch, module):
    """The last two families are ported: ``model_module`` routes each to
    its module, whose ``init_model`` builds the smoke config."""
    cfg = treg.get_config(arch, smoke=True)
    mod = tsteps.model_module(cfg)
    assert mod.__name__ == f"repro_torch.models.{module}"
    model = mod.init_model(cfg, device="cpu")
    assert model.embed.shape == (cfg.vocab_padded, cfg.d_model)
    tsteps.make_prefill(cfg)


def test_every_family_is_ported_and_unknown_kinds_are_refused():
    assert ttf._NOT_PORTED == {}
    for arch in treg.ARCHS:
        ttf.require_ported(treg.get_config(arch, smoke=True))
    cfg = dataclasses.replace(treg.get_config("recurrentgemma-2b",
                                              smoke=True),
                              pattern=("rec", "conv"))
    with pytest.raises(NotImplementedError, match="layer kinds"):
        ttf.require_ported(cfg)
    with pytest.raises(NotImplementedError, match="layer kinds"):
        tsteps.make_prefill(cfg)


def test_convert_refuses_a_misfit_leaf():
    p = tmlp.init_mlp(tcommon.ParamInit(None, torch.float32, CPU), 8, 16)
    tree = {"w1": np.zeros((8, 16), np.float32),
            "w2": np.zeros((16, 8), np.float32),
            "w3": np.zeros((8, 17), np.float32)}
    with pytest.raises(ValueError, match="w3"):
        load_tree(p, tree)


# -- the MoE family -----------------------------------------------------------

MOE_ARCHS = ("granite-moe-1b-a400m", "olmoe-1b-7b")


@functools.lru_cache(maxsize=None)
def _moe_model(arch, no_drops=False):
    """``_model`` for an MoE smoke config; ``no_drops`` sets
    ``moe_capacity = E / K``, so that no (token, k) entry overflows its
    expert in any group (C >= S)."""
    jcfg, tcfg = _configs(arch)
    if no_drops:
        cf = jcfg.n_experts / jcfg.top_k
        jcfg = dataclasses.replace(jcfg, moe_capacity=cf)
        tcfg = dataclasses.replace(tcfg, moe_capacity=cf)
    params, _ = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, tcfg, params_from_jax(tree, tcfg, CPU)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_params_from_jax(arch):
    """Every leaf of the reference's tree (stacked under ``0:moe``) lands
    on the port's parameter of the same name, bit for bit; no ``perm``
    until the experts are placed."""
    jcfg, jp, tcfg, tm = _moe_model(arch)
    stacked = jp["layers"]["0:moe"]
    assert len(tm.layers) == jcfg.n_layers
    for i, layer in enumerate(tm.layers):
        assert isinstance(layer, ttf.MoELayer) and layer.ffn.perm is None
        for name in ("router", "w1", "w2", "w3"):
            np.testing.assert_array_equal(
                getattr(layer.ffn, name).numpy(),
                np.asarray(stacked["ffn"][name][i]))
        np.testing.assert_array_equal(layer.attn.wq.numpy(),
                                      np.asarray(stacked["attn"]["wq"][i]))
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    assert (tm.lm_head is None) == jcfg.tie_embeddings


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_logits_and_aux(arch):
    jcfg, jp, tcfg, tm = _moe_model(arch)
    tok = _tokens(jcfg, 2, 32, seed=3)
    jl, jaux = jtf.forward(jp, jcfg, jnp.asarray(tok), remat=False)
    tl, taux = ttf.forward(tm, tcfg, torch.from_numpy(tok))
    assert tl.shape == (2, 32, jcfg.vocab_padded)
    _close(tl, jl)
    assert float(jaux) > 0
    assert abs(float(taux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_teacher_forced_decode(arch):
    """With ``moe_capacity = E / K`` nothing drops: prefill 24 tokens into
    a 32-slot cache, then feed 4 known tokens; logits agree with the
    reference at every step, and the last decode logits equal the port's
    full forward's at that position."""
    jcfg, jp, tcfg, tm = _moe_model(arch, no_drops=True)
    tok = _tokens(jcfg, 2, 28, seed=4)
    jl, jc = jtf.prefill_forward(jp, jcfg, jnp.asarray(tok[:, :24]),
                                 cache_len=32)
    tl, tc = ttf.prefill_forward(tm, tcfg, torch.from_numpy(tok[:, :24]),
                                 cache_len=32)
    _close(tl, jl)
    jk, jv = jc["layers"]["0:moe"]
    for i, (k, v) in enumerate(tc):
        _close(k, jk[i])
        _close(v, jv[i])
    for t in range(4):
        cur = tok[:, 24 + t:25 + t]
        jl, jc = jtf.decode_step(jp, jcfg, jc, jnp.asarray(cur),
                                 jnp.int32(24 + t))
        tl, tc = ttf.decode_step(tm, tcfg, tc, torch.from_numpy(cur),
                                 24 + t)
        _close(tl, jl)
    full, _ = ttf.forward(tm, tcfg, torch.from_numpy(tok))
    torch.testing.assert_close(tl[:, 0], full[:, -1], **F32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_placed_tree_carries_perm(arch):
    """A reference tree placed layer by layer (``permute_expert_params`` on
    each layer's experts, stacked) carries a ``perm`` leaf; the port keeps
    it as each MoE's buffer, and forward matches the placed reference and
    the unplaced model."""
    from repro.core import expert_placement as jep
    from repro.core.topology import PU, Topology

    jcfg, jp, tcfg, tm0 = _moe_model(arch)
    E, L = jcfg.n_experts, jcfg.n_layers
    topo = Topology(pus=[PU(speed=2.0, memory=1e9),
                         PU(speed=1.0, memory=1e9)])
    rng = np.random.default_rng(6)
    ffn = jax.tree.map(np.asarray, jp["layers"]["0:moe"]["ffn"])
    placed = []
    for i in range(L):
        loads = jep.expert_loads(rng.integers(1, 50, E))
        perm = jep.place_experts(loads, topo).perm
        assert not np.array_equal(perm, np.arange(E))
        placed.append(jep.permute_expert_params(
            {k: ffn[k][i] for k in ("w1", "w2", "w3")}, perm))
    stacked = {k: np.stack([np.asarray(p[k]) for p in placed])
               for k in placed[0]}
    tree = jax.tree.map(np.asarray, jp)
    tree["layers"]["0:moe"]["ffn"].update(stacked)
    tm = params_from_jax(tree, tcfg, CPU)
    for i, layer in enumerate(tm.layers):
        np.testing.assert_array_equal(layer.ffn.perm.numpy(),
                                      stacked["perm"][i])
        assert layer.ffn.perm.dtype == torch.int64
    tok = _tokens(jcfg, 2, 32, seed=7)
    jl, _ = jtf.forward(jax.tree.map(jnp.asarray, tree), jcfg,
                        jnp.asarray(tok), remat=False)
    tl, _ = ttf.forward(tm, tcfg, torch.from_numpy(tok))
    _close(tl, jl)
    tl0, _ = ttf.forward(tm0, tcfg, torch.from_numpy(tok))
    torch.testing.assert_close(tl, tl0, **F32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_init_model_and_cache(arch):
    """Random init: the reference's shapes, one MoE per layer; the cache
    holds one (k, v) pair per layer; the steps factories admit the
    family."""
    cfg = treg.get_config(arch, smoke=True)
    m = ttf.init_model(cfg, seed=0, device="cpu")
    ffn = _moe_model(arch)[1]["layers"]["0:moe"]["ffn"]
    assert all(isinstance(layer.ffn, tmlp.MoE) for layer in m.layers)
    assert m.layers[0].ffn.w2.shape == ffn["w2"].shape[1:]
    cache = ttf.init_cache(cfg, 2, 8, device="cpu")
    assert len(cache) == cfg.n_layers
    assert cache[0][0].shape == (2, 8, cfg.n_kv_heads, cfg.head_dim)
    tok = torch.from_numpy(_tokens(cfg, 2, 8))
    logits, _ = tsteps.make_prefill(cfg)(m, {"tokens": tok})
    assert logits.shape == (2, 1, cfg.vocab_padded)
    assert torch.isfinite(logits).all()
