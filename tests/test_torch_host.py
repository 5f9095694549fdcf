"""Host code the port copied from the JAX package is bit-equal to it, field
by field with dtypes; the ported tensor functions of core/ agree with their
JAX counterparts (Morton codes as equal integers, Algorithm 1 within
1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.block_sizes as rbs
import repro.core.geometry as rgeo
import repro.core.metrics as rmet
import repro.core.refinement as rref
import repro.core.topology as rtopo
import repro.kernels.spmv_bell as rbell
import repro.sparse.generators as rgen
import repro.sparse.graph as rgraph
import repro.sparse.spmv as rspmv
import repro_torch.core.block_sizes as tbs
import repro_torch.core.geometry as tgeo
import repro_torch.core.metrics as tmet
import repro_torch.core.refinement as tref
import repro_torch.core.topology as ttopo
import repro_torch.kernels.spmv_bell as tbell
import repro_torch.sparse.generators as tgen
import repro_torch.sparse.graph as tgraph
import repro_torch.sparse.spmv as tspmv


def assert_same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _topologies(mod):
    T = mod.Topology
    return [
        mod.scale_to_load(T.topo1(8, 2 / 8, 8.0, 8.5), 1000),
        mod.scale_to_load(T.topo1(12), 5000),
        mod.scale_to_load(T.topo2(24, 1 / 6, 16.0, 13.8), 777),
        T.topo3(nodes=3, cores_per_node=4),
        T.homogeneous(5, memory=3.0),
    ]


@pytest.mark.parametrize("i", range(5))
def test_topology_and_algorithm1_bit_equal(i):
    ref, port = _topologies(rtopo)[i], _topologies(ttopo)[i]
    assert port.fanouts == ref.fanouts and port.k == ref.k
    assert [p.name for p in port.pus] == [p.name for p in ref.pus]
    assert_same(port.speeds, ref.speeds, "speeds")
    assert_same(port.memories, ref.memories, "memories")
    n = 0.9 * ref.total_memory
    assert_same(tbs.target_block_sizes(n, port),
                rbs.target_block_sizes(n, ref), "tw")
    m = float(int(0.8 * ref.total_memory))
    assert_same(tbs.target_block_sizes(m, port, integral=True),
                rbs.target_block_sizes(m, ref, integral=True), "tw int")
    tw = rbs.target_block_sizes(n, ref)
    assert tbs.max_load_ratio(tw, port) == rbs.max_load_ratio(tw, ref)


def test_waterfill_bit_equal_including_overfull():
    rng = np.random.default_rng(0)
    for _ in range(20):
        w = rng.random(9) * 4
        caps = rng.random(9) * 10 + 0.1
        for load in (0.5 * caps.sum(), caps.sum(), 1.3 * caps.sum()):
            strict = load <= caps.sum()
            assert_same(tbs.waterfill(load, w, caps, strict=strict),
                        rbs.waterfill(load, w, caps, strict=strict))
    with pytest.raises(ValueError):
        tbs.waterfill(3.0, np.ones(2), np.ones(2))


@pytest.mark.parametrize("i", range(5))
def test_target_block_sizes_torch_matches_jax(i):
    topo = _topologies(rtopo)[i]
    n = 0.9 * topo.total_memory
    want = np.asarray(rbs.target_block_sizes_jax(
        jnp.float32(n), jnp.asarray(topo.speeds, jnp.float32),
        jnp.asarray(topo.memories, jnp.float32)))
    got = tbs.target_block_sizes_torch(
        n, torch.tensor(topo.speeds, dtype=torch.float32),
        torch.tensor(topo.memories, dtype=torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # and both solve Algorithm 1
    np.testing.assert_allclose(got.numpy(), rbs.target_block_sizes(n, topo),
                               rtol=1e-5)


@pytest.mark.parametrize("dim,n", [(2, 1000), (3, 700), (2, 1)])
def test_morton_codes_are_equal_integers(dim, n):
    coords = np.random.default_rng(dim + n).random((n, dim)).astype(
        np.float32) * 7 - 3
    want = np.asarray(rgeo.morton_codes(jnp.asarray(coords)))
    got = tgeo.morton_codes(torch.from_numpy(coords))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_weighted_split_assignment_bit_equal():
    rng = np.random.default_rng(1)
    order = rng.permutation(1000)
    for tw in (np.full(8, 125.0), rng.random(5) * 300, np.array([1000.0])):
        tw = tw * 1000 / tw.sum()
        assert_same(tgeo.weighted_split_assignment(order, tw),
                    rgeo.weighted_split_assignment(order, tw))


@pytest.mark.parametrize("m,weighted", [(12, True), (40, True), (40, False)])
def test_vizing_edge_coloring_bit_equal(m, weighted):
    rng = np.random.default_rng(m)
    pairs = set()
    while len(pairs) < m:
        a, b = sorted(rng.choice(10, 2, replace=False))
        pairs.add((a, b))
    pairs = np.array(sorted(pairs), dtype=np.int64)
    w = rng.random(m) if weighted else None
    assert_same(tref.vizing_edge_coloring(pairs, w),
                rref.vizing_edge_coloring(pairs, w))


def test_generators_and_laplacian_bit_equal():
    for ref_g, port_g in ((rgen.rdg(500, seed=3), tgen.rdg(500, seed=3)),
                          (rgen.grid((9, 7)), tgen.grid((9, 7))),
                          (rgen.grid((3, 4, 5)), tgen.grid((3, 4, 5)))):
        for f in ("indptr", "indices", "weights", "coords"):
            assert_same(getattr(port_g, f), getattr(ref_g, f), f)
        for shift in (1e-2, 0.1):
            for a, b in zip(tgraph.laplacian_csr(port_g, shift=shift),
                            rgraph.laplacian_csr(ref_g, shift=shift)):
                assert_same(a, b, "laplacian")
    src = np.array([0, 1, 2, 2, 3])
    dst = np.array([1, 2, 0, 0, 3])
    w = np.array([1, 2, 3, 4, 5], np.float32)
    for sym in (False, True):
        a = tgraph.from_edges(4, src, dst, w, symmetrize=sym)
        b = rgraph.from_edges(4, src, dst, w, symmetrize=sym)
        for f in ("indptr", "indices", "weights"):
            assert_same(getattr(a, f), getattr(b, f), f)


def test_metrics_bit_equal():
    g_ref, g_port = rgen.rdg(400, seed=2), tgen.rdg(400, seed=2)
    part = np.random.default_rng(0).integers(0, 6, 400).astype(np.int32)
    tw = np.full(6, 400 / 6)
    assert tmet.edge_cut(g_port, part) == rmet.edge_cut(g_ref, part)
    assert_same(tmet.comm_volumes(g_port, part, 6),
                rmet.comm_volumes(g_ref, part, 6))
    assert tmet.max_comm_volume(g_port, part, 6) == \
        rmet.max_comm_volume(g_ref, part, 6)
    assert tmet.imbalance(part, tw) == rmet.imbalance(part, tw)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_padded_coo_and_diagonal_bit_equal(dtype):
    g = rgen.rdg(200, seed=4)
    indptr, indices, data = rgraph.laplacian_csr(g, shift=0.1)
    data = data.astype(dtype)
    for pad in (None, len(indices) + 17):
        for a, b in zip(tspmv.csr_to_padded_coo(indptr, indices, data, pad),
                        rspmv.csr_to_padded_coo(indptr, indices, data, pad)):
            assert_same(a, b, "padded coo")
    assert_same(tspmv.csr_diagonal(indptr, indices, data),
                rspmv.csr_diagonal(indptr, indices, data), "diag")


@pytest.mark.parametrize("bm,bk,nnzb", [(8, 128, None), (16, 128, None),
                                        (8, 256, 2)])
def test_padded_coo_to_block_ell_bit_equal(bm, bk, nnzb):
    rng = np.random.default_rng(bm + bk)
    n = 700
    rows = rng.integers(0, n, 3000)
    cols = rng.integers(0, n, 3000)
    vals = rng.normal(size=3000).astype(np.float32)
    vals[::7] = 0.0                          # padding entries are dropped
    a = tbell.padded_coo_to_block_ell(rows, cols, vals, n, bm, bk, nnzb)
    b = rbell.padded_coo_to_block_ell(rows, cols, vals, n, bm, bk, nnzb)
    assert_same(a[0], b[0], "blocks")
    assert_same(a[1], b[1], "cols")
    assert a[2] == b[2]
