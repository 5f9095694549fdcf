"""The port's LDHT expert placement (``repro_torch.core.expert_placement``)
against the JAX package's: the host NumPy functions are copies and must
give bit-equal results over a sweep of seeds and topologies; the port's
``permute_expert_params`` must reorder the module's weights as the
reference reorders its tree, and give the reference's output through
``moe_forward``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import expert_placement as jep
from repro.core import topology as jtopo
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro_torch.core import expert_placement as tep
from repro_torch.core import topology as ttopo
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models.convert import load_tree

CPU = torch.device("cpu")


def _topos(ep, fast):
    """Reference and port topologies: ``fast`` ranks at speed 2.0 (the
    example's heterogeneous pool) and the rest at 1.0."""
    speeds = [2.0 if i < fast else 1.0 for i in range(ep)]
    return (jtopo.Topology(pus=[jtopo.PU(speed=s, memory=1e9)
                                for s in speeds]),
            ttopo.Topology(pus=[ttopo.PU(speed=s, memory=1e9)
                                for s in speeds]))


def _routing(E, K, seed, T=256):
    """Top-k id rows from a skewed router: a Zipf-like preference over the
    experts, K distinct ids per token."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, E + 1) ** 0.8
    w = rng.permutation(w / w.sum())
    return np.stack([rng.choice(E, size=K, replace=False, p=w)
                     for _ in range(T)])


def _assert_same(got, want):
    assert type(got).__name__ == type(want).__name__ == "PlacementResult"
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("E,K,ep,fast", [
    (8, 2, 2, 0), (8, 2, 4, 1), (16, 4, 4, 0), (16, 4, 4, 1),
    (32, 8, 4, 1), (32, 8, 8, 0), (64, 8, 4, 1), (64, 8, 8, 2),
])
def test_placement_bit_equal(E, K, ep, fast, seed):
    ids = _routing(E, K, seed)
    counts = np.bincount(ids.ravel(), minlength=E)
    loads = tep.expert_loads(counts)
    np.testing.assert_array_equal(loads, jep.expert_loads(counts))
    W = tep.coactivation_graph(ids, E)
    np.testing.assert_array_equal(W, jep.coactivation_graph(ids, E))
    jt, tt = _topos(ep, fast)
    for coact in (W, None):
        _assert_same(tep.place_experts(loads, tt, coact=coact),
                     jep.place_experts(loads, jt, coact=coact))


@pytest.mark.parametrize("E,ep", [(16, 4), (64, 8)])
def test_placement_bit_equal_on_tied_loads(E, ep):
    """Equal loads: every LPT pick and swap is a tie, so only the copied
    scan order gives the reference's placement."""
    loads = tep.expert_loads(np.ones(E))
    ids = np.array([[2 * i % E, (2 * i + 1) % E] for i in range(E)] * 8)
    W = tep.coactivation_graph(ids, E)
    jt, tt = _topos(ep, 1)
    _assert_same(tep.place_experts(loads, tt, coact=W),
                 jep.place_experts(loads, jt, coact=W))


def test_expert_loads_of_no_hits_is_uniform():
    np.testing.assert_array_equal(tep.expert_loads(np.zeros(8)),
                                  jep.expert_loads(np.zeros(8)))


def test_place_experts_refuses_indivisible_counts():
    _, tt = _topos(3, 0)
    with pytest.raises(ValueError, match="not divisible"):
        tep.place_experts(np.full(8, 1 / 8), tt)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_permute_expert_params_matches_reference(activation):
    E, K, D, F = 16, 4, 32, 16
    ids = _routing(E, K, 3)
    jt, tt = _topos(4, 1)
    loads = tep.expert_loads(np.bincount(ids.ravel(), minlength=E))
    perm = tep.place_experts(loads, tt,
                             coact=tep.coactivation_graph(ids, E)).perm
    col = jcommon.ParamCollector(jax.random.PRNGKey(4), dtype=jnp.float32)
    jp, _ = jmlp.init_moe(col, D, E, F, activation)
    tp = load_tree(tmlp.init_moe(tcommon.ParamInit(None, torch.float32, CPU),
                                 D, E, F, activation),
                   jax.tree.map(np.asarray, jp))
    placed = jep.permute_expert_params(
        {k: jp[k] for k in ("w1", "w2", "w3") if k in jp}, perm)
    assert tep.permute_expert_params(tp, perm) is tp
    for name in ("w1", "w2", "w3"):
        if name in placed:
            np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                          np.asarray(placed[name]))
    np.testing.assert_array_equal(tp.perm.numpy(), np.asarray(placed["perm"]))

    x = np.random.default_rng(5).normal(size=(2, 48, D)).astype(np.float32)
    kw = dict(n_experts=E, top_k=K, activation=activation,
              capacity_factor=1.25)
    jy, jaux = jmlp.moe_forward(dict(jp, **placed), jnp.asarray(x),
                                impl="dense", **kw)
    ty, taux = tmlp.moe_forward(tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    assert abs(float(taux) - float(jaux)) <= 1e-6


def test_example_runs_on_the_cpu(capsys):
    """``examples/moe_expert_placement_torch.py --device cpu``: the
    placement is numerics-neutral at the example's sizes."""
    import runpy
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "moe_expert_placement_torch.py"
    mod = runpy.run_path(str(path))
    mod["main"](["--device", "cpu"])
    out = capsys.readouterr().out
    assert "Eq.2 max load/speed" in out
    assert "OK — placement is numerics-neutral" in out
