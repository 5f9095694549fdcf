#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--side 1024] [--seed 0]

Phases (any failure exits non-zero and prints no result line):
  1. device banner (name, nvidia-smi power limit);
  2. build the CUDA kernels from src/repro_torch/kernels/csrc (nvcc, sm_90a);
  3. hold each kernel against its plain PyTorch version on the card;
  4. the main path at full size, through the entry points: grid((side,
     side)) Laplacian -> Algorithm 1 on topo1(8) -> geoKM partition with the
     pdist kernel -> build_plan -> make_operator for dist_halo and
     dist_bell -> op.solve, checked against scipy; the launch counts are
     reset just before this phase and read just after it;
  5. numbers (JSON lines tagged with the card's name and power limit):
     phase seconds, CG iterations, per-iteration and per-matvec times,
     each kernel's time at its main-path shapes beside its plain version,
     a library call and its bound, peak device memory; then the
     ``{"kernels": [...]}`` line;
  6. last line: ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def event_ms(fn, reps: int = 10, inner: int = 1) -> float:
    """Median over ``reps`` samples of CUDA-event time per call, each
    sample ``inner`` back-to-back calls, after one warm-up sample."""
    import torch
    fn()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def close(got, want, atol: float, rtol: float) -> tuple[bool, float]:
    err = (got.double() - want.double()).abs()
    ok = bool((err <= atol + rtol * want.double().abs()).all())
    return ok, float(err.max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=1024,
                    help="grid side of the main-path mesh (n = side^2)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import scipy.sparse as sp
    from repro_torch.core.api import partition
    from repro_torch.core.block_sizes import (target_block_sizes,
                                              target_block_sizes_torch)
    from repro_torch.core.metrics import (edge_cut, imbalance,
                                          max_comm_volume)
    from repro_torch.core.topology import Topology, scale_to_load
    from repro_torch.kernels import _build
    from repro_torch.kernels.pdist import pairwise_sqdist
    from repro_torch.kernels.ref import (pairwise_sqdist_ref,
                                         spmv_block_ell_ref)
    from repro_torch.kernels.spmv_bell import (csr_to_block_ell,
                                               spmv_block_ell)
    from repro_torch.sparse.distributed import make_dist_cg
    from repro_torch.sparse.generators import grid
    from repro_torch.sparse.graph import laplacian_csr
    from repro_torch.sparse.operator import make_operator

    # plain versions must not quietly use TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. banner ------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi_line = smi()
    tag = {"device": name, "nvidia_smi": smi_line}
    print(f"device: {name}")
    print(f"nvidia-smi: {smi_line}")

    def emit(**kw):
        print(json.dumps({**kw, **tag}), flush=True)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    build_s = _build.build_all()
    emit(phase="build", seconds=time.perf_counter() - t0,
         per_source_s=build_s)

    # ---- 3. kernels against their plain versions ------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    errs = {}
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        x = torch.randn(1 << 20, 2, generator=gen, device=dev).to(dt)
        c = torch.randn(8, 2, generator=gen, device=dev).to(dt)
        ok, err = close(pairwise_sqdist(x, c), pairwise_sqdist_ref(x, c),
                        tol, tol)
        emit(check="pdist", dtype=str(dt), n=1 << 20, k=8, d=2,
             max_abs_err=err, tol=tol, ok=ok)
        check(ok, f"pdist {dt} disagrees with its plain version: {err}")
        errs.setdefault("pdist", err)
    g256 = grid((256, 256))
    ip, ix, dat = laplacian_csr(g256, shift=1e-2)
    A256 = sp.csr_matrix((dat, ix, ip), shape=(g256.n, g256.n))
    x256 = np.random.default_rng(args.seed).normal(
        size=g256.n).astype(np.float32)
    for bm, bk in ((8, 128), (16, 128), (8, 256), (16, 256)):
        blocks, cols, _ = csr_to_block_ell(ip, ix, dat, g256.n, bm=bm,
                                           bk=bk)
        bt = torch.from_numpy(blocks).to(dev)
        ct = torch.from_numpy(cols).to(dev)
        xt = torch.from_numpy(x256).to(dev)
        got = spmv_block_ell(bt, ct, xt)
        ok, err = close(got, spmv_block_ell_ref(bt, ct, xt), 1e-4, 1e-4)
        ok_sp, err_sp = close(got.cpu(), torch.from_numpy(A256 @ x256),
                              1e-4, 1e-4)
        emit(check="spmv_bell", grid=256, bm=bm, bk=bk,
             nnzb=int(cols.shape[1]), max_abs_err=err,
             max_abs_err_scipy=err_sp, tol=1e-4, ok=ok and ok_sp)
        check(ok and ok_sp, f"spmv_bell bm={bm} bk={bk} disagrees: "
                            f"{err} (plain) / {err_sp} (scipy)")
    torch.cuda.synchronize()

    # ---- 4. main path ---------------------------------------------------
    side = args.side
    t0 = time.perf_counter()
    g = grid((side, side))
    indptr, indices, data = laplacian_csr(g, shift=1e-2)
    A = sp.csr_matrix((data, indices, indptr), shape=(g.n, g.n))
    topo = scale_to_load(Topology.topo1(8, 2 / 8, 8.0, 8.5), g.n)
    tw = target_block_sizes(g.n, topo)
    tw_dev = target_block_sizes_torch(
        float(g.n), torch.tensor(topo.speeds, device=dev),
        torch.tensor(topo.memories, device=dev)).cpu().numpy()
    check(np.allclose(tw_dev, tw, rtol=1e-9, atol=1e-6),
          f"Algorithm 1 on the card {tw_dev} != host {tw}")
    emit(phase="setup", seconds=time.perf_counter() - t0, n=g.n,
         nnz=int(len(indices)), tw=tw.tolist())
    b = np.random.default_rng(args.seed + 1).normal(
        size=g.n).astype(np.float32)

    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    part, tw = partition(g, topo, "geoKM", use_pallas=True)
    partition_s = time.perf_counter() - t0
    sizes = np.bincount(part, minlength=8)
    emit(phase="partition", seconds=partition_s, sizes=sizes.tolist(),
         edge_cut=edge_cut(g, part), imbalance=imbalance(part, tw),
         max_comm_volume=max_comm_volume(g, part, 8))
    check(imbalance(part, tw) < 1.01, "geoKM missed its target sizes")

    t0 = time.perf_counter()
    op_h = make_operator(indptr, indices, data, "dist_halo", part=part, k=8)
    torch.cuda.synchronize()
    halo_op_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    op_b = make_operator(indptr, indices, data, "dist_bell", part=part, k=8)
    torch.cuda.synchronize()
    bell_op_s = time.perf_counter() - t0
    plan = op_b.plan
    blocks, bcols = plan.bell_local()
    bell_bytes = blocks.numel() * blocks.element_size()
    emit(phase="operators", plan_build_s=halo_op_s,
         dist_bell_operator_s=bell_op_s,
         bell_conversion_s=bell_op_s - halo_op_s, k=plan.k, B=plan.B,
         S=plan.S, n_rounds=plan.n_rounds, bell_shape=list(blocks.shape),
         NNZB=int(blocks.shape[2]), bell_bytes=bell_bytes)

    sols = {}
    for label, op in (("dist_halo", op_h), ("dist_bell", op_b)):
        t0 = time.perf_counter()
        res = op.solve(b, tol=1e-6, max_iters=2000)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        x = op.gather(res.x)
        iters = int(res.iters.cpu())
        rel = float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))
        emit(phase="solve", backend=label, seconds=solve_s, iters=iters,
             rel_residual=rel, finite=bool(np.isfinite(x).all()))
        check(np.isfinite(x).all() and x.shape == (g.n,),
              f"{label}: non-finite or misshapen solution")
        check(rel < 1e-4, f"{label}: relative residual {rel} >= 1e-4")
        check(0 < iters < 2000, f"{label}: {iters} iterations")
        sols[label] = (x, iters)
    main_launches = _build.launches()
    peak = torch.cuda.max_memory_allocated()
    xh, xb = sols["dist_halo"][0], sols["dist_bell"][0]
    agree = float(np.abs(xh - xb).max() / np.abs(xh).max())
    emit(phase="main_path", launches=main_launches, agreement=agree,
         max_memory_allocated=peak)
    check(agree < 1e-5, f"dist_halo and dist_bell disagree: {agree}")
    for kname in ("pdist", "spmv_bell"):
        check(main_launches[kname] > 0,
              f"the main path never launched {kname}")

    # ---- 5. kernels at main-path shapes, times, bounds -------------------
    xs = torch.randn(plan.k, plan.B, generator=gen, device=dev)
    xs = xs * plan.row_mask
    want = spmv_block_ell_ref(blocks, bcols, xs)
    ok, err_bell = close(spmv_block_ell(blocks, bcols, xs), want, 1e-4,
                         1e-4)
    emit(check="spmv_bell_stacked", shape=list(blocks.shape),
         max_abs_err=err_bell, tol=1e-4, ok=ok)
    check(ok, f"stacked spmv_bell disagrees with its plain version: "
              f"{err_bell}")
    del want

    coords = torch.from_numpy(g.coords).to(dev)
    centers = coords[torch.randperm(g.n, generator=gen, device=dev)[:8]]
    n_pts, d = coords.shape
    rows = []
    pd_bytes = (coords.numel() + centers.numel() + n_pts * 8) * 4
    pd_bound, pd_by = bound_ms(pd_bytes, (6 * d + 2) * n_pts * 8)
    rows.append(dict(
        name="pdist", route="cuda",
        source="src/repro_torch/kernels/csrc/pdist.cu",
        replaces="src/repro/kernels/pdist.py:31",
        launches=main_launches["pdist"], max_abs_err=errs["pdist"],
        ms=event_ms(lambda: pairwise_sqdist(coords, centers), inner=20),
        plain_ms=event_ms(lambda: pairwise_sqdist_ref(coords, centers)),
        bound_ms=pd_bound, bound_by=pd_by, library_ms=None,
        cdist_ms=event_ms(lambda: torch.cdist(coords, centers), inner=20),
        shape=[n_pts, 8, d]))

    # the same function as one library call: the interior matrix of every
    # PU block as one block-diagonal CSR tensor
    boff = torch.arange(plan.k, device=dev)[:, None] * plan.B
    live = plan.vals_int != 0
    r = (boff + plan.rows_int.long())[live]
    cidx = (boff + plan.cols_int.long())[live]
    a_int = torch.sparse_coo_tensor(
        torch.stack([r, cidx]), plan.vals_int[live],
        (plan.k * plan.B, plan.k * plan.B)).coalesce().to_sparse_csr()
    x_flat = xs.reshape(-1, 1)
    bl_bytes = (bell_bytes + bcols.numel() * 4 + 2 * xs.numel() * 4)
    bl_bound, bl_by = bound_ms(bl_bytes, 2 * blocks.numel())
    rows.append(dict(
        name="spmv_bell", route="cuda",
        source="src/repro_torch/kernels/csrc/spmv_bell.cu",
        replaces="src/repro/kernels/spmv_bell.py:169",
        launches=main_launches["spmv_bell"], max_abs_err=err_bell,
        ms=event_ms(lambda: spmv_block_ell(blocks, bcols, xs)),
        plain_ms=event_ms(lambda: spmv_block_ell_ref(blocks, bcols, xs)),
        bound_ms=bl_bound, bound_by=bl_by,
        library_ms=event_ms(lambda: a_int @ x_flat),
        shape=list(blocks.shape)))
    del a_int

    xop = op_h.scatter(b)
    n_it = 40
    for label, op in (("dist_halo", op_h), ("dist_bell", op_b)):
        mv_ms = event_ms(lambda: op.matvec(xop))
        # tol=0 never converges: exactly n_it iterations per solve
        fused = make_dist_cg(op.plan, tol=0.0, max_iters=n_it,
                             local_format=op.local_format)
        it_ms = event_ms(lambda: fused(xop), reps=5) / n_it
        emit(timing="cg", backend=label, matvec_ms=mv_ms, iteration_ms=it_ms,
             iters=sols[label][1], iters_timed=n_it)
    emit(timing="memory", max_memory_allocated=peak,
         max_memory_allocated_all=torch.cuda.max_memory_allocated())

    print(json.dumps({"kernels": rows}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
