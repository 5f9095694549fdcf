"""The port's training path on the CPU against the JAX package: loss and
gradients of every family, gradient accumulation, AdamW, whole train
steps, and the two faults that kept the port from training.

Parameters come from the reference's ``init_model(PRNGKey(0), cfg)`` as
numpy arrays, carried into the port by ``repro_torch.models.convert``; the
reference's gradient tree goes through the same converter into a second
module, so the two are compared parameter by parameter.  Batches are
drawn with numpy as ``tests/test_models.py::_batch`` draws them.

Tolerances (float32 unless said):
- loss within 1e-5 relative; each gradient within 1e-4 of its leaf's
  largest |g|, the reference's own 1e-4 (``tests/test_models.py:150``);
- bf16 losses within 2e-2;
- ``accum_steps=2`` against 1 within 1e-4, as
  ``tests/test_models.py::test_accum_steps_equivalent``;
- AdamW from equal parameters and gradients within 1e-6 relative, to
  each entry and to its leaf's largest entry: ``p - lr delta`` can cancel
  to an entry far below its leaf's scale, where one rounding of the
  subtraction is more than 1e-6 of the entry (seen: 7.5e-9 on 1.8e-3);
- five train steps: losses within 1e-4 relative.  Parameters: nearly all
  entries within 1e-5 of the reference, and every entry within 2 lr per
  step taken.  Adam's first step moves an entry by about lr whatever its
  gradient's size (m / sqrt(v) = g / |g|), so an entry whose gradient is
  near zero can take the other sign in the other framework, which moves
  it by 2 lr; a bound tighter than that would fail on arithmetic order,
  not on a fault.
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
from repro.models import encdec as jed
from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro.models.config import ModelConfig as JModelConfig
from repro.train import optimizer as jopt
from repro_torch.configs import registry as treg
from repro_torch.kernels.flash import flash_attention
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.train import optimizer as topt

CPU = torch.device("cpu")


def _configs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jreg.get_config(arch, smoke=True),
                                dtype=dtype, **kw),
            dataclasses.replace(treg.get_config(arch, smoke=True),
                                dtype=dtype, **kw))


@functools.lru_cache(maxsize=None)
def _tree(arch, dtype="float32"):
    jcfg, _ = _configs(arch, dtype)
    mod = jed if jcfg.family == "audio" else jtf
    params, _ = mod.init_model(jax.random.PRNGKey(0), jcfg)
    return jax.tree.map(np.asarray, params)


def _batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["img_embeds"] = rng.normal(
            scale=0.02, size=(B, cfg.n_img_tokens, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "audio":
        b["frames"] = rng.normal(
            scale=0.02, size=(B, cfg.n_frames, cfg.d_model)).astype(
            np.float32)
    return b


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _trainable(tree, cfg):
    model = params_from_jax(tree, cfg, CPU)
    return model.requires_grad_(True)


def _jax_value_and_grad(jcfg, params, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jsteps.loss_fn(p, jcfg, b)))
    return fn(params, {k: jnp.asarray(v) for k, v in batch.items()})


def _grad_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the leaf's largest |want|."""
    got, want = got.detach().double(), want.detach().double()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err / scale if scale else err


# -- 0. the two faults ----------------------------------------------------------

@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_loss_and_grads_match_reference(arch):
    """Every family: loss within 1e-5 relative and each gradient within
    1e-4 of its leaf's largest |g| against ``jax.value_and_grad``; every
    parameter gets a finite gradient.  mamba2 raised in ``ssd``'s
    backward before its in-place ops were made conditional."""
    jcfg, tcfg = _configs(arch)
    tree = _tree(arch)
    batch = _batch(jcfg)
    jloss, jgrads = _jax_value_and_grad(jcfg, tree, batch)
    model = _trainable(tree, tcfg)
    loss = tsteps.loss_fn(model, tcfg, _torch(batch))
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg, CPU)
    want = dict(want.named_parameters())
    errs = {}
    for name, p in model.named_parameters():
        assert p.grad is not None, f"{name} got no gradient"
        assert bool(torch.isfinite(p.grad).all()), name
        errs[name] = _grad_err(p.grad, want[name])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])


def test_ssd_serving_and_training_forms_agree():
    """``ssd`` forms its decay matrix in place for serving and out of place
    under grad; both give the same output and state."""
    cfg = treg.get_config("mamba2-130m", smoke=True)
    torch.manual_seed(0)
    p = tssm.init_ssm(ttf.ParamInit(torch.Generator().manual_seed(0),
                                    torch.float32, CPU),
                      cfg.d_model, cfg.ssm_state, cfg.ssm_headdim,
                      cfg.ssm_expand, cfg.conv_kernel)
    g = torch.Generator().manual_seed(1)
    B, S, d_in = 2, 48, cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_headdim
    xs = torch.randn(B, S, d_in, generator=g)
    Bm, Cm = (torch.randn(B, S, cfg.ssm_state, generator=g)
              for _ in range(2))
    dt = torch.randn(B, S, H, generator=g)
    with torch.no_grad():
        y0, h0 = tssm.ssd(p, xs, Bm, Cm, dt, headdim=cfg.ssm_headdim,
                          chunk=16)
    xs.requires_grad_(True)
    y1, h1 = tssm.ssd(p, xs, Bm, Cm, dt, headdim=cfg.ssm_headdim, chunk=16)
    (y1.sum() + h1.sum()).backward()
    assert torch.equal(y0, y1.detach()) and torch.equal(h0, h1.detach())
    assert bool(torch.isfinite(xs.grad).all())


def test_flash_refuses_under_grad():
    """Like the reference's Pallas kernel under ``jax.grad``, the wrapper
    raises where a gradient would be needed, the CPU's plain route
    included; under ``no_grad``, or with no input requiring grad, it
    runs."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 128, 16, generator=g) for _ in range(3))
    want = flash_attention(q, k, v)
    for t in (q, k, v):
        t.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            flash_attention(q, k, v)
        with torch.no_grad():
            assert torch.equal(flash_attention(q, k, v), want)
        t.requires_grad_(False)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("case", [
    dict(B=2, Sq=64, Sk=64, H=4, Hkv=2, D=16, causal=True),
    dict(B=1, Sq=200, Sk=200, H=2, Hkv=2, D=16, causal=True),
    dict(B=2, Sq=24, Sk=40, H=4, Hkv=4, D=16, causal=False)],
    ids=["gqa", "off_tile", "cross"])
def test_gqa_attend_under_grad_matches_reference(case, dtype, tol):
    """Under grad ``gqa_attend`` takes the plain chunked loop (flash would
    raise): output and the gradients of q, k, v against the reference's
    ``gqa_attend`` and ``jax.vjp``."""
    rng = np.random.default_rng(3)
    B, Sq, Sk, H, Hkv, D = (case[k] for k in ("B", "Sq", "Sk", "H", "Hkv",
                                              "D"))
    arrs = [rng.normal(size=s).astype(np.float32) for s in
            ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]
    w = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrs)
    jout, vjp = jax.vjp(lambda q, k, v: jattn.gqa_attend(
        q, k, v, causal=case["causal"]), jq, jk, jv)
    jgrads = vjp(jnp.asarray(w).astype(jdt))
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True)
                  for a in arrs)
    out = tattn.gqa_attend(tq, tk, tv, causal=case["causal"])
    out.backward(torch.from_numpy(w).to(tdt))

    def close(got, want):
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   atol=tol, rtol=tol)

    close(out, jout)
    for t, jg in zip((tq, tk, tv), jgrads):
        close(t.grad, jg)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-tiny"])
def test_prefill_with_trainable_params_serves_the_same_logits(arch):
    """``make_prefill`` runs under ``no_grad``: a model whose parameters
    require grad gives the frozen model's logits and caches (through the
    flash wrapper, which would refuse under grad)."""
    _, tcfg = _configs(arch)
    tree = _tree(arch)
    batch = _torch(_batch(tcfg, S=24))
    batch.pop("labels")
    prefill = tsteps.make_prefill(tcfg, cache_len=32)
    want, want_cache = prefill(params_from_jax(tree, tcfg, CPU), batch)
    got, cache = prefill(_trainable(tree, tcfg), batch)
    assert not got.requires_grad
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(cache), jax.tree.leaves(want_cache)))


def test_serve_tokens_with_trainable_params(monkeypatch):
    """``serve_tokens`` on a model whose parameters require grad serves the
    tokens of the frozen one."""
    cfg = treg.get_config("qwen1.5-0.5b", smoke=True)
    want = serve.serve_tokens(cfg, batch=2, prompt_len=16, gen=4,
                              device="cpu")
    init = ttf.init_model
    monkeypatch.setattr(ttf, "init_model", lambda *a, **k: init(
        *a, **k).requires_grad_(True))
    got = serve.serve_tokens(cfg, batch=2, prompt_len=16, gen=4,
                             device="cpu")
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert torch.equal(got["logits"], want["logits"])


# -- 1. losses in bf16, remat -----------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-130m"])
def test_bf16_loss_matches_reference(arch):
    jcfg, tcfg = _configs(arch, "bfloat16")
    tree = _tree(arch, "bfloat16")
    batch = _batch(jcfg)
    jloss = jsteps.loss_fn(tree, jcfg, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    model = _trainable(tree, tcfg)
    loss = tsteps.loss_fn(model, tcfg, _torch(batch))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 2e-2
    assert all(bool(torch.isfinite(p.grad.float()).all())
               for p in model.parameters())


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-tiny"])
def test_remat_changes_no_value(arch, monkeypatch):
    """``remat="full"`` runs each layer under ``torch.utils.checkpoint``
    (counted here) and gives the gradients of ``remat="none"`` bit for
    bit; the unported policies raise."""
    import torch.utils.checkpoint as tuc
    tree = _tree(arch)
    runs = {}
    for remat in ("full", "none"):
        _, tcfg = _configs(arch, remat=remat)
        calls = []
        real = tuc.checkpoint
        monkeypatch.setattr(ttf, "checkpoint", lambda *a, **k: (
            calls.append(1), real(*a, **k))[1])
        model = _trainable(tree, tcfg)
        tsteps.loss_fn(model, tcfg, _torch(_batch(tcfg))).backward()
        runs[remat] = ({n: p.grad for n, p in model.named_parameters()},
                       len(calls))
    n_layers = tcfg.n_layers + (tcfg.enc_layers if arch == "whisper-tiny"
                                else 0)
    assert runs["full"][1] == n_layers and runs["none"][1] == 0
    for name, g in runs["none"][0].items():
        assert torch.equal(runs["full"][0][name], g), name
    for kw in (dict(remat="dots"), dict(remat="dots_nb"),
               dict(remat_chunks=2)):
        _, tcfg = _configs(arch, **kw)
        model = _trainable(tree, tcfg)
        with pytest.raises(NotImplementedError, match="item 21"):
            tsteps.loss_fn(model, tcfg, _torch(_batch(tcfg)))
        with torch.no_grad():        # serving never remats: no error
            tsteps.loss_fn(model, tcfg, _torch(_batch(tcfg)))


# -- 2. accumulation, optimizer, train steps ------------------------------------

_TINY = ("t", "dense", 2, 32, 2, 2, 64, 128)


def _tiny_pair():
    jcfg = JModelConfig(*_TINY, dtype="float32")
    tcfg = TModelConfig(*_TINY, dtype="float32")
    params, _ = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params)


def _port_state(tree, tcfg):
    model = _trainable(tree, tcfg)
    return {"params": model, "opt": topt.init_opt_state(model)}


def test_accum_steps_equivalent():
    """The port's ``accum_steps=2`` against 1 (the reference test's case),
    and against the reference's accumulated step."""
    jcfg, tcfg, params, tree = _tiny_pair()
    batch = _batch(tcfg, B=4, S=16)
    opt_j, opt_t = jopt.AdamWConfig(lr=1e-3), topt.AdamWConfig(lr=1e-3)
    s1, m1 = tsteps.make_train_step(tcfg, opt_t, 1)(
        _port_state(tree, tcfg), _torch(batch))
    s2, m2 = tsteps.make_train_step(tcfg, opt_t, 2)(
        _port_state(tree, tcfg), _torch(batch))
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    p1 = dict(s1["params"].named_parameters())
    for name, p in s2["params"].named_parameters():
        assert float((p - p1[name]).detach().abs().max()) < 1e-4, name
    js, jm = jax.jit(jsteps.make_train_step(jcfg, opt_j, accum_steps=2))(
        {"params": params, "opt": jopt.init_opt_state(params)},
        {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(m2["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
        float(jm["loss"]))
    assert abs(float(m2["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5 \
        * float(jm["grad_norm"])
    want = dict(params_from_jax(jax.tree.map(np.asarray, js["params"]),
                                tcfg, CPU).named_parameters())
    for name, p in s2["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


class _Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        for k, a in arrays.items():
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(a.copy())))


def test_adamw_steps_match_reference():
    """Five AdamW steps from equal parameters and gradients (the clip
    active on the larger ones): parameters, m, v, grad_norm and lr within
    1e-6 relative, warmup and decay both crossed."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}
    arrays = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    cfg_j = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=4,
                             grad_clip=3.0)
    cfg_t = topt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=4,
                             grad_clip=3.0)
    jp = {k: jnp.asarray(a) for k, a in arrays.items()}
    js = jopt.init_opt_state(jp)
    tp = _Params(arrays)
    ts = topt.init_opt_state(tp)
    for step in range(5):
        grads = {k: (rng.normal(size=s) * (step + 0.5)).astype(np.float32)
                 for k, s in shapes.items()}
        jp, js, jm = jopt.adamw_update(
            cfg_j, jp, {k: jnp.asarray(g) for k, g in grads.items()}, js)
        tp, ts, tm = topt.adamw_update(
            cfg_t, tp, {k: torch.from_numpy(g) for k, g in grads.items()},
            ts)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6, err_msg=key)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for k in shapes:
            for got, want in ((getattr(tp, k), jp[k]), (ts["m"][k], js["m"][k]),
                              (ts["v"][k], js["v"][k])):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got.detach().numpy(), want, rtol=1e-6,
                    atol=1e-6 * float(np.abs(want).max()), err_msg=k)


def test_adamw_minimizes_quadratic():
    p = _Params({"w": np.asarray([5.0, -3.0], np.float32)})
    state = topt.init_opt_state(p)
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                           total_steps=200)
    for _ in range(150):
        p, state, _ = topt.adamw_update(cfg, p, {"w": 2 * p.w.detach()},
                                        state)
    assert float(p.w.detach().abs().max()) < 0.1


def test_grad_clip():
    p = _Params({"w": np.zeros(3, np.float32)})
    state = topt.init_opt_state(p)
    cfg = topt.AdamWConfig(lr=1.0, grad_clip=1.0, warmup_steps=1)
    _, _, m = topt.adamw_update(
        cfg, p, {"w": torch.tensor([1e6, 0.0, 0.0])}, state)
    assert float(m["grad_norm"]) > 1e5          # reported before the clip


def test_lr_schedule_shape():
    cfg = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                           min_lr_frac=0.1)
    lrs = [float(topt.lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0
    assert abs(lrs[99] - 0.1) < 0.05
    assert max(lrs) <= 1.0 + 1e-6
    jcfg = jopt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_frac=0.1)
    want = [float(jopt.lr_schedule(jcfg, jnp.int32(s))) for s in range(100)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6)


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert abs(float(topt.global_norm(t)) - 5.0) < 1e-6


def test_five_train_steps_match_reference():
    """qwen-smoke, five jitted reference steps against five port steps from
    the same parameters and batches (the Trainer's AdamW schedule)."""
    jcfg, tcfg = _configs("qwen1.5-0.5b")
    tree = _tree("qwen1.5-0.5b")
    kw = dict(lr=3e-3, total_steps=5, warmup_steps=5)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt.AdamWConfig(**kw)))
    tstep = tsteps.make_train_step(tcfg, topt.AdamWConfig(**kw))
    jparams = jax.tree.map(jnp.asarray, tree)
    js = {"params": jparams, "opt": jopt.init_opt_state(jparams)}
    ts = _port_state(tree, tcfg)
    lrs = []
    for step in range(5):
        batch = _batch(jcfg, B=4, S=32, seed=step)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tstep(ts, _torch(batch))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-4 * abs(
            float(jm["loss"])), step
        lrs.append(float(jm["lr"]))
    want = dict(params_from_jax(jax.tree.map(np.asarray, js["params"]),
                                tcfg, CPU).named_parameters())
    bound = 2 * sum(lrs)
    n_far = n_all = 0
    for name, p in ts["params"].named_parameters():
        err = (p.detach() - want[name].detach()).abs()
        assert float(err.max()) <= bound, (name, float(err.max()), bound)
        n_far += int((err > 1e-5).sum())
        n_all += err.numel()
    assert n_far <= 1e-3 * n_all, (n_far, n_all)
