"""``repro_torch.launch.serve.SolverService`` against the JAX package's
``repro.launch.serve.SolverService``: the scenarios of
``tests/test_serving.py`` run on the port (on the CPU), and the reference's
own runs beside them.

  * ``matrix_fingerprint`` is bit-equal to the reference's;
  * LRU hits, misses and evictions, bucket classes and padding counters
    equal the reference's on the same traffic;
  * served batches match per-column solves and scipy, and the reference's
    served batches within 1e-5 with iteration counts within 2;
  * ``update_matrix`` moves the fingerprint and purges on eviction; the
    ``dist_hier`` patch / drift / migration scenario (``DELTA_SCRIPT``)
    gives the reference's counters, run in a subprocess on 8 forced host
    devices;
  * ``--solver`` prints the reference's counter lines;
  * ``static_cost`` raises, naming the unported auditor and roofline."""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.launch import serve as ref_serve
from repro.sparse.generators import grid
from repro.sparse.graph import laplacian_csr
from repro_torch.core.replan_policy import DriftPolicy
from repro_torch.launch import serve
from repro_torch.launch.serve import SolverService, matrix_fingerprint
from repro_torch.sparse.operator import cg_solve_global, make_operator
from repro_torch.sparse.replan import EdgeDelta, apply_delta_csr

from test_serving import DELTA_SCRIPT


def _system(side=10, shift=0.05):
    return laplacian_csr(grid((side, side)), shift=shift)


def _svc(**kw):
    return SolverService(device="cpu", **kw)


def _reweight_pair(indptr, indices, data, i, j, val):
    n = len(indptr) - 1
    delta = EdgeDelta(n, set_rows=[i, j], set_cols=[j, i],
                      set_vals=[val, val])
    return delta, apply_delta_csr(indptr, indices, data, delta)


# --------------------------------------------------------------------------
# fingerprint, admission, cache
# --------------------------------------------------------------------------

@pytest.mark.parametrize("side,shift,dtype", [(10, 0.05, np.float32),
                                               (8, 0.1, np.float32),
                                               (10, 0.05, np.float64)])
def test_fingerprint_bit_equal_to_reference(side, shift, dtype):
    indptr, indices, data = _system(side, shift)
    data = data.astype(dtype)
    fp = matrix_fingerprint(indptr, indices, data)
    assert fp == ref_serve.matrix_fingerprint(indptr, indices, data)
    n, nnz, digest = fp.split(":")
    assert int(n) == len(indptr) - 1 and int(nnz) == len(indices)
    assert len(digest) == 32
    bumped = data.copy()
    bumped[0] += 1e-3
    assert matrix_fingerprint(indptr, indices, bumped) != fp


def test_bucket_classes_and_validation():
    svc = _svc(buckets=(1, 2, 4, 8, 16))
    ref = ref_serve.SolverService(buckets=(1, 2, 4, 8, 16))
    for nb in (1, 2, 3, 5, 16, 40):
        assert svc.bucket_for(nb) == ref.bucket_for(nb)
    assert svc.bucket_for(40) == 40
    for kw in (dict(buckets=(4, 2, 1)), dict(buckets=()),
               dict(capacity=0)):
        with pytest.raises(ValueError):
            _svc(**kw)


def _traffic(svc, rng, systems, n_req):
    out = []
    for r in range(n_req):
        sysm = systems[int(rng.integers(0, len(systems)))]
        n = len(sysm[0]) - 1
        nb = int(rng.integers(1, 7))
        b = rng.normal(size=(n, nb) if nb > 1 else n).astype(np.float32)
        out.append(svc.solve(*sysm, b))
    return out


def test_cache_counters_and_results_match_reference():
    systems = [_system(8, 0.05), _system(8, 0.10), _system(6, 0.2)]
    port, ref = _svc(capacity=2, max_iters=300), \
        ref_serve.SolverService(capacity=2, max_iters=300)
    got = _traffic(port, np.random.default_rng(0), systems, 10)
    want = _traffic(ref, np.random.default_rng(0), systems, 10)
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    assert port.stats.operator_evictions > 0
    for g, w in zip(got, want):
        assert (g.fingerprint, g.bucket, g.cache_hit, g.warm) == \
            (w.fingerprint, w.bucket, w.cache_hit, w.warm)
        x, wx = np.atleast_2d(g.x.T).T, np.atleast_2d(np.asarray(w.x).T).T
        scale = np.maximum(np.abs(wx).max(axis=0), 1.0)
        assert (np.abs(x - wx).max(axis=0) / scale).max() < 1e-5
        assert np.abs(np.asarray(g.iters) - np.asarray(w.iters)).max() <= 2
    assert set(port._csr) == set(port._ops)
    assert {fp for fp, _ in port._warm} <= set(port._ops)


def test_operator_cache_hits_and_lru_eviction():
    A, B = _system(8, 0.05), _system(8, 0.10)
    b = np.random.default_rng(0).normal(size=len(A[0]) - 1).astype(
        np.float32)
    svc = _svc(capacity=1, max_iters=200)
    r1 = svc.solve(*A, b)
    assert not r1.cache_hit and not r1.warm
    r2 = svc.solve(*A, b)
    assert r2.cache_hit and r2.warm
    svc.solve(*B, b)
    r4 = svc.solve(*A, b)
    assert not r4.cache_hit and not r4.warm
    s = svc.stats
    assert (s.operator_hits, s.operator_misses, s.operator_evictions) == \
        (1, 3, 2)
    assert s.solves == 4
    assert {fp for fp, _ in svc._warm} <= set(svc._ops)


def test_padding_counters_and_shapes():
    indptr, indices, data = _system(8)
    n = len(indptr) - 1
    rng = np.random.default_rng(1)
    svc = _svc(max_iters=200)
    resp = svc.solve(indptr, indices, data,
                     rng.normal(size=(n, 3)).astype(np.float32))
    assert resp.bucket == 4
    assert resp.x.shape == (n, 3)
    assert resp.iters.shape == resp.residual.shape == (3,)
    assert svc.stats.real_cols == 3 and svc.stats.padded_cols == 1
    assert svc.stats.padding_waste == pytest.approx(0.25)
    single = svc.solve(indptr, indices, data,
                       rng.normal(size=n).astype(np.float32))
    assert single.bucket == 1 and single.x.shape == (n,)
    assert np.ndim(single.iters) == 0


# --------------------------------------------------------------------------
# served solves
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend,kw", [
    ("coo", {}), ("bell", {}),
    ("dist_halo", {"k": 4}), ("dist_hier", {"k": 4, "pods": 2})])
def test_served_batch_matches_sequential_and_scipy(backend, kw):
    indptr, indices, data = _system(10)
    n = len(indptr) - 1
    A = sp.csr_matrix((data, indices, indptr), shape=(n, n))
    rng = np.random.default_rng(2)
    hard = rng.normal(size=n).astype(np.float32)
    easy = (A @ np.eye(n, dtype=np.float32)[:, 3]).astype(np.float32)
    zero = np.zeros(n, np.float32)
    b = np.stack([hard, easy, zero], axis=1)
    if backend.startswith("dist"):
        kw = dict(kw, part=(np.arange(n) * kw["k"] // n).astype(np.int32))
    svc = _svc(backend=backend, tol=1e-7, max_iters=1000, **kw)
    resp = svc.solve(indptr, indices, data, b)
    assert resp.bucket == 4
    op = svc._ops[resp.fingerprint]
    for j, col in enumerate((hard, easy, zero)):
        xs, its, _ = cg_solve_global(op, col, tol=1e-7, max_iters=1000,
                                     device="cpu")
        scale = max(float(np.abs(xs).max()), 1.0)
        assert np.abs(resp.x[:, j] - xs).max() / scale < 1e-5
        assert abs(int(resp.iters[j]) - its) <= 2
    assert int(resp.iters[2]) == 0
    assert int(resp.iters[1]) < int(resp.iters[0])
    dense = sp.linalg.spsolve(A.astype(np.float64), hard.astype(np.float64))
    assert np.abs(resp.x[:, 0] - dense).max() / np.abs(dense).max() < 1e-4


def test_dist_bell_service_raises_on_batched_requests():
    indptr, indices, data = _system(8)
    n = len(indptr) - 1
    svc = _svc(backend="dist_bell", k=4,
               part=(np.arange(n) * 4 // n).astype(np.int32))
    b = np.ones((n, 2), np.float32)
    with pytest.raises(ValueError, match="single-RHS"):
        svc.solve(indptr, indices, data, b)


# --------------------------------------------------------------------------
# streaming updates
# --------------------------------------------------------------------------

def test_update_matrix_moves_fingerprint():
    indptr, indices, data = _system(8)
    n = len(indptr) - 1
    b = np.random.default_rng(2).normal(size=n).astype(np.float32)
    svc = _svc(max_iters=400, tol=1e-7)
    r0 = svc.solve(indptr, indices, data, b)
    delta, (ip2, ix2, d2) = _reweight_pair(indptr, indices, data, 0, 1,
                                           -0.5)
    resp = svc.update_matrix(r0.fingerprint, delta)
    assert resp.old_fingerprint == r0.fingerprint
    assert resp.fingerprint == matrix_fingerprint(ip2, ix2, d2)
    assert resp.fingerprint != r0.fingerprint
    assert not resp.patched and not resp.repartitioned
    assert resp.drift is None and resp.state is None
    assert svc.stats.plan_rebuilds == 1 and svc.stats.plan_patches == 0
    r_new = svc.solve(ip2, ix2, d2, b)
    assert r_new.cache_hit and r_new.fingerprint == resp.fingerprint
    assert not svc.solve(indptr, indices, data, b).cache_hit
    A2 = sp.csr_matrix((d2, ix2, ip2), shape=(n, n))
    want = sp.linalg.spsolve(A2.astype(np.float64), b.astype(np.float64))
    assert np.abs(r_new.x - want).max() / np.abs(want).max() < 1e-4


def test_update_matrix_unknown_or_evicted_fingerprint_raises():
    indptr, indices, data = _system(8)
    B = _system(8, 0.10)
    b = np.random.default_rng(3).normal(size=len(indptr) - 1).astype(
        np.float32)
    svc = _svc(capacity=1, max_iters=200)
    delta = _reweight_pair(indptr, indices, data, 0, 1, -0.5)[0]
    with pytest.raises(KeyError):
        svc.update_matrix("0:0:deadbeef", delta)
    rA = svc.solve(indptr, indices, data, b)
    svc.solve(*B, b)
    with pytest.raises(KeyError):
        svc.update_matrix(rA.fingerprint, delta)


def test_eviction_purges_update_state():
    indptr, indices, data = _system(8)
    B = _system(8, 0.10)
    n = len(indptr) - 1
    b = np.random.default_rng(4).normal(size=n).astype(np.float32)
    svc = _svc(capacity=1, max_iters=200,
               part=((np.arange(n) * 4) // n).astype(np.int32),
               drift=DriftPolicy(max_objective_ratio=1e6,
                                 max_imbalance_ratio=1e6))
    r0 = svc.solve(indptr, indices, data, b)
    delta, (ip2, ix2, d2) = _reweight_pair(indptr, indices, data, 0, 1,
                                           -0.5)
    resp = svc.update_matrix(r0.fingerprint, delta)
    assert resp.drift is not None and not resp.drift.repartition
    assert resp.fingerprint in svc._monitors
    assert resp.old_fingerprint not in svc._csr
    assert resp.fingerprint in svc._csr and resp.fingerprint in svc._ops
    svc.solve(ip2, ix2, d2, b)
    svc.solve(*B, b)
    assert resp.fingerprint not in svc._ops
    assert resp.fingerprint not in svc._csr
    assert resp.fingerprint not in svc._monitors
    assert not any(fp == resp.fingerprint for fp, _ in svc._warm)
    assert set(svc._csr) == set(svc._ops)
    assert set(svc._monitors) <= set(svc._ops)


def _port_delta_scenario():
    """``tests/test_serving.py``'s DELTA_SCRIPT on the port (CPU)."""
    g = grid((16, 16))
    indptr, indices, data = laplacian_csr(g, shift=0.1)
    n, k = g.n, 8
    part = ((np.arange(n) * k) // n).astype(np.int32)
    repart_calls = []

    def repartition(gs):
        repart_calls.append(gs.n)
        return part

    svc = _svc(backend="dist_hier", capacity=4, max_iters=400, tol=1e-7,
               part=part, k=k, fanouts=(2, 4),
               drift=DriftPolicy(max_objective_ratio=1.2),
               repartition=repartition)
    b = np.random.default_rng(0).normal(size=n).astype(np.float32)
    r0 = svc.solve(indptr, indices, data, b)
    dv = EdgeDelta(n, set_rows=[0, 1], set_cols=[1, 0],
                   set_vals=[-0.5, -0.5])
    ip2, ix2, d2 = apply_delta_csr(indptr, indices, data, dv)
    r1 = svc.update_matrix(r0.fingerprint, dv)
    assert r1.patched and not r1.repartitioned
    assert r1.drift is not None and not r1.drift.repartition
    hit = svc.solve(ip2, ix2, d2, b)
    assert hit.cache_hit and hit.fingerprint == r1.fingerprint
    assert not svc.solve(indptr, indices, data, b).cache_hit
    fresh = make_operator(ip2, ix2, d2, "dist_hier", part=part, k=k,
                          fanouts=(2, 4), device="cpu")
    xf = fresh.gather(fresh.solve(b, tol=1e-7, max_iters=400).x)
    assert np.abs(hit.x - xf).max() / np.abs(xf).max() < 1e-5
    A2 = sp.csr_matrix((d2, ix2, ip2), shape=(n, n)).astype(np.float64)
    ref = sp.linalg.spsolve(A2, b.astype(np.float64))
    rel = float(np.abs(hit.x - ref).max() / np.abs(ref).max())

    plan = svc._ops[r1.fingerprint].plan
    xs = torch.from_numpy(plan.scatter_vec(b))
    u = np.arange(0, 30, dtype=np.int64)
    v = n - 1 - u
    ds = EdgeDelta(n, set_rows=np.concatenate([u, v]),
                   set_cols=np.concatenate([v, u]),
                   set_vals=np.full(60, -1.0))
    r2 = svc.update_matrix(r1.fingerprint, ds, state=(xs,))
    assert r2.drift.repartition and "objective" in r2.drift.reason
    assert r2.repartitioned and not r2.patched
    assert len(repart_calls) == 1
    assert isinstance(r2.state[0], torch.Tensor)
    new_plan = svc._ops[r2.fingerprint].plan
    s = svc.stats
    return {"rel": rel,
            "state_exact": bool(np.array_equal(
                new_plan.gather_vec(r2.state[0]), b)),
            "patches": s.plan_patches, "rebuilds": s.plan_rebuilds,
            "trips": s.drift_trips,
            "fp_moved": r2.fingerprint != r1.fingerprint != r0.fingerprint,
            "decision": (r2.drift.objective, r2.drift.objective_ratio,
                         r2.drift.imbalance)}


def test_update_matrix_patches_dist_plan_like_reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    script = DELTA_SCRIPT.replace(
        '"trips": s.drift_trips,',
        '"trips": s.drift_trips, "decision": [r2.drift.objective, '
        'r2.drift.objective_ratio, r2.drift.imbalance],')
    assert script != DELTA_SCRIPT
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    got = _port_delta_scenario()
    assert (got["patches"], got["rebuilds"], got["trips"]) == \
        (want["patches"], want["rebuilds"], want["trips"]) == (1, 1, 1)
    assert got["state_exact"] and want["state_exact"]
    assert got["fp_moved"] and want["fp_moved"]
    assert got["rel"] < 1e-4 and want["rel"] < 1e-4
    assert abs(got["rel"] - want["rel"]) < 1e-5
    assert list(got["decision"]) == want["decision"]     # host pricing


# --------------------------------------------------------------------------
# entry point, static_cost
# --------------------------------------------------------------------------

def test_solver_main_prints_the_reference_counters(capsys):
    serve.main(["--solver", "--requests", "8", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    ref_serve._solver_traffic(argparse.Namespace(requests=8, pool=3,
                                                 capacity=8))
    want = capsys.readouterr().out.splitlines()
    assert got[0].startswith("requests=8 solves/sec=")
    assert got[0].endswith("device=cpu")
    assert got[1].startswith("latency ms: p50=")
    assert got[2:] == want[2:]
    assert got[2].startswith("operator cache: hits=")
    assert got[3].startswith("buckets: hits=")


def test_static_cost_names_its_roadmap_items():
    svc = _svc()
    with pytest.raises(NotImplementedError, match="item 10.*item 19"):
        svc.static_cost(*_system(6), nb=2)
