"""The port's token-choice MoE (``repro_torch.models.mlp``) on the CPU
against the JAX package's ``moe_forward`` (dense impl), on the same
parameters and numpy-seeded inputs.

Parameters come from the reference's ``init_moe`` and are carried into
the port by ``convert.load_tree``.  Tolerances: float32 ``y`` within
atol = rtol = 1e-5 (the same sums in another order; outputs reach about
20 here), ``aux`` within 1e-6.  bfloat16: the router logits are built
exact (entries of x and of the router in {-1, 0, 1}, so every logit is a
small integer) and tie often: the chosen experts must be the reference's;
``y`` within atol = rtol = 5e-2: outputs reach 12 here and the two
differ by at most one bf16 ulp (0.0625 on [8, 16), 58% of the limit),
since the reference adds the K contributions one by one in bf16 and the
port sums them in one reduction.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import expert_placement as jep
from repro.core.topology import PU as JPU, Topology as JTopology
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro_torch.core import expert_placement as tep
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models.convert import load_tree, to_tensor

CPU = torch.device("cpu")
F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=5e-2, rtol=5e-2)
D, F = 32, 16


def _pair(E, activation="swiglu", dtype="float32", seed=0, d=D):
    """Reference MoE params (jnp) and the port's module with their
    values."""
    col = jcommon.ParamCollector(jax.random.PRNGKey(seed),
                                 dtype=jnp.dtype(dtype))
    p, _ = jmlp.init_moe(col, d, E, F, activation)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tp = load_tree(tmlp.init_moe(tcommon.ParamInit(None, tdt, CPU), d, E, F,
                                 activation),
                   jax.tree.map(np.asarray, p))
    return p, tp


def _x(B, S, seed=1, d=D):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(
        np.float32)


def _run(jp, tp, x, E, K, expert_perm=None, **kw):
    """Both packages on x; ``expert_perm`` goes to the port only (the
    reference's placed tree carries its own)."""
    jy, jaux = jmlp.moe_forward(jp, jnp.asarray(x), n_experts=E, top_k=K,
                                impl="dense", **kw)
    ty, taux = tmlp.moe_forward(tp, to_tensor(np.asarray(x), CPU),
                                n_experts=E, top_k=K,
                                expert_perm=expert_perm, **kw)
    return (jy, jaux), (ty, taux)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _dropped(tp, x, E, K, cf) -> int:
    """(token, k) entries past their expert's capacity, per the port's
    routing."""
    _, _, ids = tmlp.route(tp, torch.from_numpy(x), K)
    B, S, _ = x.shape
    C = tmlp.capacity(S, E, K, cf)
    per_row = [np.bincount(ids[b].reshape(-1).numpy(), minlength=E)
               for b in range(B)]
    return int(sum(np.maximum(c - C, 0).sum() for c in per_row))


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("B,S,E,K,cf,drops", [
    (2, 16, 8, 2, 8.0, False),            # ample capacity
    (2, 64, 8, 2, 1.25, True),            # tight: some entries drop
    (1, 32, 4, 2, 0.01, True),            # C = 4: most entries drop
    (3, 1, 8, 2, 2.0, False),             # the decode shape
    (2, 24, 6, 3, 1.0, True),
])
def test_moe_forward_matches_reference(activation, B, S, E, K, cf, drops):
    jp, tp = _pair(E, activation, seed=E + K)
    x = _x(B, S, seed=S)
    assert (_dropped(tp, x, E, K, cf) > 0) == drops
    (jy, jaux), (ty, taux) = _run(jp, tp, x, E, K, activation=activation,
                                  capacity_factor=cf)
    assert ty.shape == (B, S, D) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), _np(jy), **F32)
    assert abs(float(taux) - float(jaux)) <= 1e-6


def _placement(E, ep=4):
    topo = JTopology(pus=[JPU(speed=2.0, memory=1e9)]
                     + [JPU(speed=1.0, memory=1e9) for _ in range(ep - 1)])
    loads = jep.expert_loads(np.random.default_rng(E).integers(1, 50, E))
    return jep.place_experts(loads, topo).perm


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_expert_perm_passed_and_carried(carried, cf):
    """The placed module (weights reordered by argsort(perm)) with the
    permutation passed as ``expert_perm`` or carried in its ``perm``
    buffer gives the reference's placed output, and the unplaced one's."""
    E, K = 8, 2
    perm = _placement(E)
    assert not np.array_equal(perm, np.arange(E))
    jp, tp = _pair(E, seed=3)
    x = _x(2, 64, seed=4)
    jp2 = dict(jp)
    jp2.update(jep.permute_expert_params(
        {k: jp[k] for k in ("w1", "w2", "w3")}, perm))
    (jy0, _), (ty0, _) = _run(jp, tp, x, E, K, capacity_factor=cf)
    if carried:
        tep.permute_expert_params(tp, perm)
        assert tp.perm.dtype == torch.int64
        kw = {}
    else:
        inv = torch.from_numpy(np.argsort(perm))
        for name in ("w1", "w2", "w3"):
            w = getattr(tp, name)
            w.data = w.data[inv]
        kw = dict(expert_perm=torch.from_numpy(perm))
    (jy, jaux), (ty, taux) = _run(jp2, tp, x, E, K, capacity_factor=cf,
                                  **kw)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **F32)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    np.testing.assert_allclose(ty.numpy(), ty0.numpy(), **F32)
    np.testing.assert_allclose(_np(jy), _np(jy0), **F32)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_bf16_router_ties_pick_the_reference_experts(activation):
    E, K, B, S, d = 8, 2, 2, 48, 32
    rng = np.random.default_rng(5)
    jp, tp = _pair(E, activation, dtype="bfloat16", seed=6, d=d)
    router = rng.integers(-1, 2, size=(d, E)).astype(np.float32)
    jp = dict(jp, router=jnp.asarray(router, jnp.bfloat16))
    tp.router.data = torch.from_numpy(router).to(torch.bfloat16)
    x = rng.integers(-1, 2, size=(B, S, d)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)

    jprobs = jax.nn.softmax((xb @ jp["router"]).astype(jnp.float32), -1)
    jgate, jids = jax.lax.top_k(jprobs, K)
    tprobs, tgate, tids = tmlp.route(tp, to_tensor(np.asarray(xb), CPU), K)
    # the case holds ties at the top-k boundary
    srt = np.sort(_np(jprobs), axis=-1)[..., ::-1]
    assert (srt[..., K - 1] == srt[..., K]).sum() >= 10
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    # the two softmaxes differ in the last bit; equal logits give equal
    # probabilities within each
    np.testing.assert_allclose(tprobs.numpy(), _np(jprobs), rtol=1e-6)
    np.testing.assert_allclose(tgate.numpy(), _np(jgate), rtol=1e-6)

    (jy, jaux), (ty, taux) = _run(jp, tp, xb, E, K, activation=activation,
                                  capacity_factor=1.25)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(), _np(jy), **BF16)
    assert abs(float(taux) - float(jaux)) <= 1e-6


def test_route_matches_top_k_on_f32_logits():
    jp, tp = _pair(16, seed=7)
    x = _x(3, 40, seed=8)
    jprobs = jax.nn.softmax((jnp.asarray(x) @ jp["router"]), -1)
    _, jids = jax.lax.top_k(jprobs, 4)
    _, _, tids = tmlp.route(tp, torch.from_numpy(x), 4)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("impl", ["auto", "dense", "shard_map"])
def test_every_impl_takes_the_grouped_dispatch(impl):
    """Without a mesh the reference runs the grouped dense dispatch for
    each impl; so does the port."""
    jp, tp = _pair(8, seed=9)
    x = _x(2, 32, seed=10)
    kw = dict(n_experts=8, top_k=2, capacity_factor=1.25)
    jy, _ = jmlp.moe_forward(jp, jnp.asarray(x), impl=impl, **kw)
    ty, _ = tmlp.moe_forward(tp, torch.from_numpy(x), impl=impl, **kw)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **F32)


def test_unknown_impl_raises():
    _, tp = _pair(4)
    with pytest.raises(ValueError, match="impl"):
        tmlp.moe_forward(tp, torch.zeros(1, 4, D), n_experts=4, top_k=2,
                         impl="ring")


@pytest.mark.parametrize("S,E,K,cf,want", [
    (2048, 64, 8, 1.25, 320),     # olmoe's prefill
    (1, 64, 8, 2.0, 4),           # decode
    (2048, 32, 8, 4.0, 2048),     # granite at cf = E / K: C = S
    (1920, 32, 8, 4.0, 1920),
    (16, 8, 2, 8.0, 32),
    (17, 8, 2, 1.25, 8),
])
def test_capacity(S, E, K, cf, want):
    assert tmlp.capacity(S, E, K, cf) == want


def test_init_moe_shapes_and_draw_order():
    """The reference's shapes; router, w1, w2, w3 drawn in that order
    (each draw's scale 1/sqrt(shape[0]))."""
    gen = torch.Generator().manual_seed(0)
    m = tmlp.init_moe(tcommon.ParamInit(gen, torch.float32, CPU), D, 8, F)
    jp, _ = _pair(8)
    assert [(n, tuple(p.shape)) for n, p in m.named_parameters()] == \
        [(n, jp[n].shape) for n in ("router", "w1", "w2", "w3")]
    assert m.perm is None and not m.w1.requires_grad
    gen = torch.Generator().manual_seed(0)
    want = torch.randn((D, 8), generator=gen) * (1 / np.sqrt(D))
    torch.testing.assert_close(m.router, want, atol=0, rtol=0)
    want = torch.randn((8, D, F), generator=gen) * (1 / np.sqrt(8))
    torch.testing.assert_close(m.w1, want, atol=0, rtol=0)
