"""The slice end to end in both packages: grid((32, 32)) -> Algorithm 1 on
TOPO1(8) -> geoKM -> build_plan -> dist_halo / dist_bell CG.

The JAX side runs in a subprocess on 8 forced host devices (``XLA_FLAGS``
is set in the child only), with its Pallas block-ELL kernel in interpret
mode.  The JAX partition feeds both packages' plans, so the solve
comparison sees one matrix layout; solutions agree within 1e-5 relative to
the largest entry (tests/test_operator.py:78)."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import scipy.sparse as sp

from repro.sparse.distributed import build_plan as ref_build_plan
from repro.sparse.generators import grid
from repro.sparse.graph import laplacian_csr
import repro_torch.core.api as tapi
import repro_torch.core.topology as ttopo
import repro_torch.sparse.generators as tgen
import repro_torch.sparse.graph as tgraph
from repro_torch.sparse.operator import cg_solve_global, make_operator

SIDE = 32
TOL = 1e-7

SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    from repro.core import Topology, partition, scale_to_load
    from repro.sparse import make_operator, cg_solve_global
    from repro.sparse.generators import grid
    from repro.sparse.graph import laplacian_csr

    side, tol = int(sys.argv[1]), float(sys.argv[2])
    g = grid((side, side))
    indptr, indices, data = laplacian_csr(g, shift=1e-2)
    topo = scale_to_load(Topology.topo1(8), g.n)
    part, tw = partition(g, topo, "geoKM")
    b = np.random.default_rng(1).normal(size=g.n).astype(np.float32)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("pu",))
    out = {"part": part.tolist(), "tw": tw.tolist()}
    for backend in ("dist_halo", "dist_bell"):
        op = make_operator(indptr, indices, data, backend, part=part, k=8,
                           mesh=mesh)
        res = op.solve(b, tol=tol, max_iters=2000)
        out[backend] = op.gather(res.x).tolist()
        out[backend + "_iters"] = int(res.iters)
    x, it, _ = cg_solve_global(make_operator(indptr, indices, data, "coo"),
                               b, tol=tol, max_iters=2000)
    out["coo"] = x.tolist()
    out["coo_iters"] = it
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_run():
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(SIDE),
                           str(TOL)], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    return {k: np.asarray(v) if isinstance(v, list) else v
            for k, v in out.items()}


@pytest.fixture(scope="module")
def system():
    g = tgen.grid((SIDE, SIDE))
    csr = tgraph.laplacian_csr(g, shift=1e-2)
    b = np.random.default_rng(1).normal(size=g.n).astype(np.float32)
    return g, csr, b


def rel_err(x, ref):
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def test_partition_agrees_with_jax(jax_run, system):
    g, _, _ = system
    topo = ttopo.scale_to_load(ttopo.Topology.topo1(8), g.n)
    part, tw = tapi.partition(g, topo, "geoKM", use_pallas=True,
                              device="cpu")
    np.testing.assert_array_equal(tw, jax_run["tw"])
    np.testing.assert_array_equal(np.bincount(part, minlength=8),
                                  np.bincount(jax_run["part"], minlength=8))
    assert float(np.mean(part == jax_run["part"])) >= 0.98


def test_plans_from_the_jax_partition_are_bit_equal(jax_run, system):
    from repro_torch.sparse.distributed import build_plan
    g, (indptr, indices, data), _ = system
    ref = ref_build_plan(indptr, indices, data, jax_run["part"], 8,
                         validate=True)
    port = build_plan(indptr, indices, data, jax_run["part"], 8,
                      device="cpu")
    assert port.round_perms == ref.round_perms
    for f in ("perm", "rows", "cols", "vals", "send_idx", "send_mask",
              "rows_int", "vals_bnd", "diag"):
        a = getattr(port, f)
        a = a if isinstance(a, np.ndarray) else a.numpy()
        np.testing.assert_array_equal(a, np.asarray(getattr(ref, f)), f)


@pytest.mark.parametrize("backend", ["dist_halo", "dist_bell"])
def test_fused_solve_matches_jax_on_8_devices(jax_run, system, backend):
    g, (indptr, indices, data), b = system
    op = make_operator(indptr, indices, data, backend, part=jax_run["part"],
                       k=8, device="cpu")
    res = op.solve(b, tol=TOL, max_iters=2000)
    x = op.gather(res.x)
    A = sp.csr_matrix((data, indices, indptr), shape=(g.n, g.n))
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-4
    assert rel_err(x, jax_run[backend]) < 1e-5
    assert rel_err(x, jax_run["coo"]) < 1e-5


@pytest.mark.parametrize("backend", ["coo", "bell"])
def test_single_device_backends_match_jax(jax_run, system, backend):
    g, (indptr, indices, data), b = system
    op = make_operator(indptr, indices, data, backend, device="cpu")
    x, it, _ = cg_solve_global(op, b, tol=TOL, max_iters=2000,
                               device="cpu")
    assert rel_err(x, jax_run["coo"]) < 1e-5


def test_inputs_are_the_reference_inputs(system):
    g, (indptr, indices, data), _ = system
    for a, r in zip((indptr, indices, data),
                    laplacian_csr(grid((SIDE, SIDE)), shift=1e-2)):
        np.testing.assert_array_equal(a, r)
