"""geoKM (balanced k-means) in the port against the JAX package on
rdg(2000), k = 8, TOPO1 targets.

The loop runs the same float32 arithmetic in another order, so an argmin
near a tie can fall the other way.  Held to: SFC seeding bit-equal; at
least 98% of vertices in the same block (after the loop, and after the
exact rebalance); block sizes after ``_exact_rebalance`` identical; edge
cut within 3% — on TOPO1 with Table III's exp-2 and exp-3 fast specs.

With exp-4 specs and |F| = 2/8 (examples/heterogeneous_cg.py) the
reference's own price loop does not converge on this instance and is
chaotic: a one-ulp change of the coordinates moves 75% of its vertices.
No port can agree vertex by vertex there; it is held to identical block
sizes on target, and the numbers are logged in ROADMAP.md queue 3."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.balanced_kmeans as rkm
from repro.core import Topology, scale_to_load, target_block_sizes
from repro.core.metrics import edge_cut
from repro.sparse.generators import rdg
import repro_torch.core.balanced_kmeans as tkm
from repro_torch.core.api import partition as port_partition


SPECS = {"exp2": (1 / 12, 2.0, 3.2), "exp3": (1 / 6, 4.0, 5.2)}


def _instance(fast_fraction, fast_speed, fast_memory):
    g = rdg(2000, seed=0)
    topo = scale_to_load(
        Topology.topo1(8, fast_fraction, fast_speed, fast_memory), g.n)
    return g, topo, target_block_sizes(g.n, topo)


@pytest.fixture(scope="module", params=sorted(SPECS))
def inst(request):
    return _instance(*SPECS[request.param])


def test_init_centers_bit_equal(inst):
    g, _, tw = inst
    coords = np.asarray(g.coords, np.float32)
    want = rkm._init_centers(coords, tw)
    got = tkm._init_centers(coords, tw, torch.device("cpu"))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_bkm_loop_agrees(inst, use_pallas):
    g, _, tw = inst
    coords = np.asarray(g.coords, np.float32)
    c0 = rkm._init_centers(coords, tw)
    rp, rc, _ = rkm._bkm_loop(jnp.asarray(coords), jnp.asarray(c0),
                              jnp.asarray(tw, jnp.float32), iters=30,
                              price_steps=12, use_pallas=use_pallas)
    tp, tc, _ = tkm._bkm_loop(torch.from_numpy(coords),
                              torch.from_numpy(c0),
                              torch.from_numpy(tw.astype(np.float32)),
                              iters=30, price_steps=12,
                              use_pallas=use_pallas)
    agree = float(np.mean(tp.numpy() == np.asarray(rp)))
    assert agree >= 0.98, agree
    np.testing.assert_allclose(tc.numpy(), np.asarray(rc), atol=1e-2)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_partition_balanced_kmeans_agrees(inst, use_pallas):
    g, _, tw = inst
    want = rkm.partition_balanced_kmeans(g, tw, use_pallas=use_pallas)
    got = tkm.partition_balanced_kmeans(g, tw, use_pallas=use_pallas,
                                        device="cpu")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(np.bincount(got, minlength=8),
                                  np.bincount(want, minlength=8))
    assert float(np.mean(got == want)) >= 0.98
    cut_t, cut_r = edge_cut(g, got), edge_cut(g, want)
    assert abs(cut_t - cut_r) <= 0.03 * cut_r, (cut_t, cut_r)


def test_partition_entry_point(inst):
    from repro.core import partition as ref_partition
    g, topo, tw = inst
    part, tw_p = port_partition(g, topo, "geoKM", device="cpu")
    ref_part, ref_tw = ref_partition(g, topo, "geoKM")
    np.testing.assert_array_equal(tw_p, ref_tw)
    np.testing.assert_array_equal(np.bincount(part, minlength=8),
                                  np.bincount(ref_part, minlength=8))
    assert float(np.mean(part == ref_part)) >= 0.98
    for method in ("geoRef", "sfc", "greedyRef"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port_partition(g, topo, method, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_partition(g, topo, "geoKM", pods=2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_partition(g, topo, "geoKM", objective="bottleneck",
                       device="cpu")
    with pytest.raises(ValueError):
        port_partition(g, topo, "nope", device="cpu")


def test_exp4_instance_where_the_reference_loop_diverges():
    """The reference's loop ends far from its targets here, and one ulp
    of coordinate noise moves most of its vertices, so vertex agreement
    with any port is out of reach.  Both packages still land exactly on
    the target sizes after the rebalance."""
    g, topo, tw = _instance(2 / 8, 8.0, 8.5)
    coords = np.asarray(g.coords, np.float32)
    c0 = rkm._init_centers(coords, tw)
    loop_part, _, _ = rkm._bkm_loop(jnp.asarray(coords), jnp.asarray(c0),
                                    jnp.asarray(tw, jnp.float32), iters=30,
                                    price_steps=12)
    loop_sizes = np.bincount(np.asarray(loop_part), minlength=8)
    assert np.abs(loop_sizes - tw).max() > 0.5 * tw.max()   # not converged
    want = rkm.partition_balanced_kmeans(g, tw)
    g_ulp = rdg(2000, seed=0)
    g_ulp.coords = np.nextafter(g_ulp.coords, np.float32(2))
    jittered = rkm.partition_balanced_kmeans(g_ulp, tw)
    assert float(np.mean(jittered == want)) < 0.5            # chaotic
    got = tkm.partition_balanced_kmeans(g, tw, device="cpu")
    target = np.round(tw).astype(np.int64)
    target[np.argmax(target)] += g.n - target.sum()
    np.testing.assert_array_equal(np.bincount(want, minlength=8), target)
    np.testing.assert_array_equal(np.bincount(got, minlength=8), target)
