#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--side 1024] [--prompt-len 2048] [--seed 0]

Phases (any failure exits non-zero and prints no result line):
  1. device banner (name, nvidia-smi power limit);
  2. build the CUDA kernels from src/repro_torch/kernels/csrc (nvcc, sm_90a,
     one nvcc per source, all started together);
  3. hold pdist, and the block-ELL kernel (spmv_sell, over the blocks'
     nonzeros) in each form (single, also without an index; stacked over
     three PU blocks; batched with nb = 1, 3, 16 and 33; f32 and f64),
     against their plain PyTorch versions and scipy, and an Inf and a NaN
     in x against the dense product's pattern;
  4. sparse path at full size, through the entry points: grid((side,
     side)) Laplacian -> Algorithm 1 on topo1(8) -> geoKM partition with the
     pdist kernel -> build_plan -> make_operator for dist_halo and
     dist_bell -> op.solve, checked against scipy; the launch counts are
     reset just before this phase and read just after it (dist_bell must
     launch the sell route);
  4b. geoKM again from the same seed: the same partition, vertex for
     vertex;
  5. sparse numbers: phase seconds, CG iterations, per-iteration and
     per-matvec times, pdist and the sell route at their main-path shapes
     beside their plain versions, a library call (the stacked one without
     and with the plan's padding rows) and their bounds (the block-ELL
     rows on the nonzeros, with the block stream as the floor of a kernel
     that streams the blocks);
  5b. the other exchange schedules on the same system, partition and
     right-hand side, each through ``make_operator`` and ``op.solve`` with
     the counts reset just before and read just after: dist_halo_seq,
     dist_allgather, dist_hier on two pods (``topo.pod_assignment(2)``)
     and on the tree fanouts (2, 2, 2), dist_hier_bell on two pods (which
     must launch the sell route; the others never do); each solution
     against
     scipy and against dist_halo's, with its plan seconds, rounds per
     level, matvec and CG iteration times and peak memory;
  5c. block-Jacobi PCG on grid((96, 96)), where the dense (k, B, B)
     inverses fit (at 1024^2 they would take 4.35 TB): dist_halo fused
     and dist_hier on two pods fused and through cg_solve_global, against
     plain dist_halo CG, with the host inversion seconds;
  5d. solver service (``repro_torch.launch.serve.SolverService``) on phase
     4's system, topology and partition, buckets (1, 2, 4, 8, 16): a
     dist_halo service over two matrices (shift 1e-2 and 2e-2) serving
     ``SOLVER_REQUESTS`` batched requests of widths 1-16; a bell service
     (the sell route, one launch per matvec) serving widths 16 and 3,
     each column against its own single-column solve; a dist_hier
     service on two pods taking a value delta (an O(delta) plan patch)
     and a cross-partition insertion (a drift trip, a rebuild and an
     exact migration of the solver state); one JSON line per request and
     per update, and the block-ELL kernel's times on the 1024^2 blocks
     for an (n,) x and at nb = 1, 4 and 16;
  4c. (run after 5d, once phase 4's operators are freed) geoRef on the main
     path: ``partition(g, topo, use_pallas=True)`` with its default method
     on phase 4's system, topology and seed, the counts reset just before
     and read just after (pdist must launch); its k-means start must equal
     phase 4's geoKM partition vertex for vertex, its edge cut must not
     exceed geoKM's, and every block must stay within ``min(ceil(tw
     1.03), floor(mem))`` or, where the start already stood above it, no
     higher; the seconds of each stage (k-means, then matching,
     contraction and FM per level), cut, comm volumes, imbalance beside
     geoKM's; then ``make_operator("dist_bell", part=<geoRef>)`` and
     ``op.solve`` (residual below 1e-4, the sell route launched) with the
     plan's halo rounds and bytes, CG iterations, ms per iteration and
     memory beside phase 4's;
  4d. the tree-aware pipelines with geoRef on phase 4's system and
     topology: ``partition_tree(fanouts=(2, 2, 2))``
     and ``partition_hier(pods=2)``, each ``HierPartition`` through
     ``make_operator("dist_hier_bell", part=...)`` and ``op.solve``
     (residual below 1e-4, pdist and the sell route launched); the tree
     objective and per-level cut beside phase 5b's tables over the geoKM
     partition;
  4e. Table IV: ``evaluate`` over the eight methods on grid((256, 256))
     under TOPO1 exp 4 scaled to it, one line
     per method; no memory violations, the refined methods within their
     caps as in 4c, geoRef's cut at most geoKM's and sfcRef's at most
     sfc's; the winner of each metric is reported, not asserted;
  4f. the analysis layer (``repro_torch.analysis``) on the operators
     that phases 4, 5b and 4d build anyway: phase 4's dist_bell plan and
     phase 5b's (2, 2, 2) tree plan built with ``validate=True``, and
     phase 4d's ``partition_tree`` / ``partition_hier`` with
     ``validate=True``, the verifier's seconds (the ``verify_report``
     each builder keeps) on an ``analysis_verify`` line; one warm-up audit
     of a small dist_halo operator, which takes torch's one-time
     dispatch-mode imports; the exchange audit (``audit_operator``: one
     matvec and one CG chunk on the card, the counts reset just before
     and read just after) of dist_halo and dist_bell (after phase 5's timings), dist_hier on
     the tree and dist_hier_bell on two pods (in phase 5b), each with no
     diagnostic, its payload bytes per level equal to the partition's
     comm volumes x 4, and the sell route launched by the block-ELL
     ones; and on the tree operator a consistent swap of two rounds,
     which the verifier must pass and the audit must report as exactly
     TRACE002;
  6. hold both flash kernels against their plain version and check the
     route of each call: bf16 with head dim 64 or 128 goes to flash_sm90
     (wgmma + TMA), f32 and bf16 with head dim 16 or 80 to flash (mma.sync
     + cp.async; bf16, and f32 as 3xTF32); the reference test shapes,
     every head dim in both of flash's dtypes, causal and not, GQA, Sq !=
     Sk, S below one tile and off a tile multiple, the MoE prefill shapes
     (olmoe, granite), stablelm-3b's prefill shape and the float32 shapes
     of phase 8; and show that the LM's causal
     attention reaches flash at a length that is not a tile multiple;
  7. LM serving at the full width of qwen1.5-0.5b (random weights from a
     seed): batch 8, prompt 2048, 32 generated tokens through
     ``repro_torch.launch.serve.serve_tokens``; the counts are reset just
     before and read just after, and the prefill must launch flash_sm90
     once per layer and flash never, the decode loop neither;
  7b. the same at the full width and depth of stablelm-3b (head dim 80,
     layernorm), the path of flash in bf16: the prefill must launch flash
     once per layer and flash_sm90 never, the decode loop neither;
  7c. MoE serving at the full width and depth of olmoe-1b-7b (64 experts
     top-8, head dim 128), as phase 7: 16 flash_sm90 launches per prefill,
     flash never, the decode loop neither; the dispatch capacities and the
     bytes every decode step reads (the grouped dispatch multiplies every
     expert);
  7d. the same for granite-moe-1b-a400m (32 experts top-8, 16 heads over 8
     KV heads at head dim 64, tied embeddings): 24 flash_sm90 launches per
     prefill;
  7f. one MoE layer of each of the two at full width, bf16: the time of
     each stage of ``moe_forward`` (router, slots, dispatch, experts,
     combine) at the prefill and the decode shape, the experts' bound;
  8. whole-model consistency in float32: last-token logits of a 2048-token
     prefill (flash attention) against a 1920-token prefill plus 128
     teacher-forced decode steps (plain decode attention), within 1e-3 of
     the largest |logit|; the counts are reset just before and read just
     after, and this path must launch flash (the f32 route), never
     flash_sm90;
  8b. the same for granite-moe-1b-a400m in float32 at full width and
     depth with ``moe_capacity = E / K`` (nothing drops on either path):
     48 flash launches, flash_sm90 never; the tokens whose top-k experts
     differ between the paths are counted per layer;
  7e. LDHT expert placement on that float32 model: per-layer router counts
     and co-activation from one 2048-token row of the serving prompts,
     ``place_experts`` onto four EP ranks (one at speed 2.0), every
     layer's experts permuted in place; last-token prefill logits placed
     against unplaced within 1e-5 of the largest |logit|; Eq. 2 max
     load/speed and the co-activation cut against the contiguous
     placement, the host seconds of ``coactivation_graph`` and
     ``place_experts``;
  9. each flash kernel at the shapes its paths give it (flash_sm90: qwen's
     prefill in bf16, nested: olmoe's prefill at head dim 128 and
     granite's launches; flash: stablelm-3b's prefill in bf16 and phase
     8's float32 prefill, nested: 8b's launches) beside its plain version,
     SDPA and its bound; peak device memory; then the ``{"kernels":
     [...]}`` line;
 10. last line: ``{"ok": true, "device": {...}}``.

Numbers are JSON lines tagged with the card's name and power limit.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
PEAK_FLOPS = {                   # H100 SXM data sheet, dense
    "float32": 67e12,            # float32 outside the tensor cores
    "bfloat16": 989e12,          # bf16 tensor cores
    "tf32": 495e12,              # TF32 tensor cores
}
SOLVER_REQUESTS = 8              # requests of phase 5d's dist_halo service
TABLE_SIDE = 256                 # phase 4e: evaluate runs all eight methods
BELL_COUNTS = ("spmv_bell:sell", "spmv_bell_multi:sell")   # block-ELL


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


def bound_ms(nbytes: float, flops: float,
             dtype: str = "float32") -> tuple[float, str]:
    """The larger of the bytes' time at the HBM rate and the operations'
    time at the card's peak for ``dtype``, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def close(got, want, atol: float, rtol: float) -> tuple[bool, float]:
    err = (got.double() - want.double()).abs()
    ok = bool((err <= atol + rtol * want.double().abs()).all())
    return ok, float(err.max())


def limit_share(got, want, atol: float, rtol: float) -> float:
    """The largest error as a share of its limit ``atol + rtol |want|``."""
    err = (got.double() - want.double()).abs()
    return float((err / (atol + rtol * want.double().abs())).max())


def sparse_path(args, dev, gen, emit) -> list[dict]:
    """Phases 3-5: pdist and the block-ELL kernel against their plain
    versions, the sparse path at full size, its numbers.  Returns the
    sparse kernel rows."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from repro_torch.core.api import partition
    from repro_torch.core.block_sizes import (target_block_sizes,
                                              target_block_sizes_torch)
    from repro_torch.core.metrics import (comm_volumes, edge_cut, imbalance,
                                          max_comm_volume)
    from repro_torch.core.topology import Topology, scale_to_load
    from repro_torch.kernels import _build
    from repro_torch.kernels.pdist import pairwise_sqdist
    from repro_torch.kernels.ref import (pairwise_sqdist_ref,
                                         spmv_block_ell_ref, spmv_sell_ref)
    from repro_torch.kernels.spmv_bell import bell_index, spmv_block_ell
    from repro_torch.sparse.generators import grid
    from repro_torch.sparse.graph import laplacian_csr
    from repro_torch.sparse.operator import make_operator

    # ---- 3. kernels against their plain versions ------------------------
    errs = {}
    # k = 8, d = 2: the main path's shape (16-byte stores, d = 2 kernel);
    # k = 7, d = 3: scalar stores and the d = 3 kernel; d = 5 and 8: the
    # generic d loop, with k > 1024 centres staged in two chunks, once with
    # scalar and once with 16-byte stores
    for (n, k, d) in ((1 << 20, 8, 2), (1 << 20, 7, 3), (1 << 16, 1030, 5),
                      (1 << 14, 2048, 8)):
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
            x = torch.randn(n, d, generator=gen, device=dev).to(dt)
            c = torch.randn(k, d, generator=gen, device=dev).to(dt)
            ok, err = close(pairwise_sqdist(x, c),
                            pairwise_sqdist_ref(x, c), tol, tol)
            emit(check="pdist", dtype=str(dt), n=n, k=k, d=d,
                 max_abs_err=err, tol=tol, ok=ok)
            check(ok, f"pdist {dt} {(n, k, d)} disagrees with its plain "
                      f"version: {err}")
            errs.setdefault("pdist", err)
    bell_checks(args, dev, gen, emit, errs)
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
    bytes0 = torch.cuda.memory_allocated()
    op_b = make_operator(indptr, indices, data, "dist_bell", part=part,
                         k=8, validate=True)
    torch.cuda.synchronize()
    bell_verify_s = emit_verified("dist_bell", op_b.plan.verify_report,
                                  emit)
    bell_op_s = time.perf_counter() - t0 - bell_verify_s
    bell_op_bytes = torch.cuda.memory_allocated() - bytes0
    plan = op_b.plan
    blocks, bcols = plan.bell_local()
    index = plan.bell_index()
    bell_bytes = blocks.numel() * blocks.element_size()
    # what the index adds to make_operator("dist_bell"): the same build
    # again, on the card
    t0 = time.perf_counter()
    bell_index(blocks, bcols, plan.B)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    # phase 4c compares the geoRef partition's plan and solve with these
    geokm = dict(part=part, partition_s=partition_s, **plan_halo(plan),
                 operator_bytes=bell_op_bytes)
    emit(phase="operators", plan_build_s=halo_op_s,
         dist_bell_operator_s=bell_op_s, dist_bell_verify_s=bell_verify_s,
         bell_conversion_s=bell_op_s - halo_op_s, bell_index_s=index_s,
         k=plan.k, B=plan.B, S=plan.S, n_rounds=plan.n_rounds,
         bell_shape=list(blocks.shape), NNZB=int(blocks.shape[2]),
         bell_bytes=bell_bytes, index_nnz=index.nnz,
         index_entries=len(index.cols),
         index_bytes=len(index.cols) * 8 + index.ptr.numel() * 4)

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
    for kname in ("pdist", "spmv_bell:sell"):
        check(main_launches[kname] > 0,
              f"the main path never launched {kname}")
    check(main_launches["spmv_bell_multi:sell"] == 0,
          f"the main path took the batched block-ELL form: {main_launches}")

    # ---- 4b. geoKM repeats itself: one partition per seed ----------------
    t0 = time.perf_counter()
    part2, _ = partition(g, topo, "geoKM", use_pallas=True)
    same = int((part2 == part).sum())
    emit(check="geokm_repeat", seconds=time.perf_counter() - t0,
         vertices_equal=same, n=g.n, edge_cut=edge_cut(g, part),
         ok=same == g.n)
    check(same == g.n, f"geoKM from one seed differs in {g.n - same} "
                       "vertices between two runs")
    del part2

    # ---- 5. kernels at main-path shapes, times, bounds -------------------
    xs = torch.randn(plan.k, plan.B, generator=gen, device=dev)
    xs = xs * plan.row_mask
    want = spmv_block_ell_ref(blocks, bcols, xs)
    got = spmv_block_ell(blocks, bcols, xs, index=index)
    ok, err_bell = close(got, spmv_sell_ref(index, blocks, bcols, xs), 1e-4,
                         1e-4)
    ok_dense, err_dense = close(got, want, 1e-4, 1e-4)
    emit(check="spmv_sell_stacked", shape=list(blocks.shape),
         max_abs_err=err_bell, max_abs_err_dense_plain=err_dense, tol=1e-4,
         ok=ok and ok_dense)
    check(ok and ok_dense, f"stacked spmv_sell disagrees with its plain "
                           f"version: {err_bell} / {err_dense}")
    xinf = xs.clone()
    xinf[0, 1000] = float("inf")                 # a real row of PU block 0
    want = spmv_block_ell_ref(blocks, bcols, xinf)
    got = spmv_block_ell(blocks, bcols, xinf, index=index)
    same = (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.isinf(got), torch.isinf(want)))
    spread = int((~torch.isfinite(want)).sum())
    emit(check="spmv_sell_stacked_non_finite", shape=list(blocks.shape),
         non_finite=spread, same_pattern=same, ok=same and spread > 0)
    check(same and spread > 0, "stacked spmv_sell: an Inf in x spreads "
                               "unlike the dense product")
    del want, got, xinf
    coords = torch.from_numpy(g.coords).to(dev)
    centers = coords[torch.randperm(g.n, generator=gen, device=dev)[:8]]
    n_pts, d = coords.shape
    rows = []
    pd_bytes = (coords.numel() + centers.numel() + n_pts * 8) * 4
    pd_bound, pd_by = bound_ms(pd_bytes, (6 * d + 2) * n_pts * 8)
    fill = torch.empty(n_pts, 8, device=dev)
    rows.append(dict(
        name="pdist", route="cuda",
        source="src/repro_torch/kernels/csrc/pdist.cu",
        replaces="src/repro/kernels/pdist.py:31",
        launches=main_launches["pdist"], max_abs_err=errs["pdist"],
        ms=event_ms(lambda: pairwise_sqdist(coords, centers), inner=20),
        plain_ms=event_ms(lambda: pairwise_sqdist_ref(coords, centers)),
        bound_ms=pd_bound, bound_by=pd_by, library_ms=None,
        cdist_ms=event_ms(lambda: torch.cdist(coords, centers), inner=20),
        # a yardstick for the output stream alone: fill the (n, 8) result
        fill_ms=event_ms(lambda: fill.fill_(1.0), inner=20),
        shape=[n_pts, 8, d]))
    del fill

    # the same function as one library call: the interior matrix of every
    # PU block as one block-diagonal CSR tensor.  With the (k, B) layout's
    # padding rows (two thirds of its rows, empty) cuSPARSE's csrmv took
    # 100x longer than on the same entries without them, whether the tensor
    # was built on the card from COO or from host CSR arrays; the yardstick
    # is the call without them, the others are kept beside it
    boff = torch.arange(plan.k, device=dev)[:, None] * plan.B
    live = plan.vals_int != 0
    r = (boff + plan.rows_int.long())[live]
    cidx = (boff + plan.cols_int.long())[live]
    vals = plan.vals_int[live].cpu().numpy()
    a_coo = torch.sparse_coo_tensor(
        torch.stack([r, cidx]), plan.vals_int[live],
        (plan.k * plan.B, plan.k * plan.B)).coalesce().to_sparse_csr()
    r, cidx = r.cpu().numpy(), cidx.cpu().numpy()
    a_int = host_csr_tensor(sp.csr_matrix(
        (vals, (r, cidx)), shape=(plan.k * plan.B,) * 2), dev)
    real = plan.row_mask.reshape(-1) != 0
    new_id = (torch.cumsum(real.long(), 0) - 1).cpu().numpy()
    a_real = host_csr_tensor(sp.csr_matrix(
        (vals, (new_id[r], new_id[cidx])), shape=(g.n, g.n)), dev)
    x_flat = xs.reshape(-1, 1)
    x_real = x_flat[real]
    library = {"without_padding_rows": lambda: a_real @ x_real,
               "with_padding_rows": lambda: a_int @ x_flat,
               "with_padding_rows_built_on_card_from_coo":
                   lambda: a_coo @ x_flat}
    times = bell_times(blocks, bcols, index, xs, library)
    rows.append(dict(
        name="spmv_bell:sell", route="cuda",
        source="src/repro_torch/kernels/csrc/spmv_bell.cu",
        replaces="src/repro/kernels/spmv_bell.py:169",
        launches=main_launches["spmv_bell:sell"],
        max_abs_err=max(err_bell, errs["spmv_sell"]), **times,
        shape=list(blocks.shape)))
    del a_int, a_coo, a_real, library, x_real, real, vals
    xop = op_h.scatter(b)
    for label, op in (("dist_halo", op_h), ("dist_bell", op_b)):
        mv_ms, it_ms = timed_cg(op, xop)
        emit(timing="cg", backend=label, matvec_ms=mv_ms, iteration_ms=it_ms,
             iters=sols[label][1], iters_timed=40)
    geokm.update(iters=sols["dist_bell"][1], matvec_ms=mv_ms,
                 iteration_ms=it_ms, max_memory_allocated=peak)
    emit(timing="memory", path="sparse", max_memory_allocated=peak)

    # ---- 4f. the exchange audit of the main path's operators ------------
    audit_warmup(emit)
    flat_bytes = [float(comm_volumes(g, part, 8).sum()) * 4]
    audit_phase("dist_halo", op_h, flat_bytes, emit, sell=False)
    audit_bell = audit_phase("dist_bell", op_b, flat_bytes, emit, sell=True)

    # dist_hier_bell builds its own block-ELL stack: free dist_bell's first
    del op_b, op, plan, blocks, bcols, index, xs, x_flat, live, boff
    torch.cuda.empty_cache()
    hier_bell, audit_hier_bell = other_backends(
        g, A, (indptr, indices, data), topo, part, b, op_h,
        sols["dist_halo"][0], emit)
    rows[1]["launches_dist_bell"] = rows[1]["launches"]
    rows[1]["launches_dist_hier_bell"] = hier_bell
    rows[1]["launches_audit_dist_bell"] = audit_bell
    rows[1]["launches_audit_dist_hier_bell"] = audit_hier_bell
    rows[1]["launches"] += hier_bell + audit_bell + audit_hier_bell
    del op_h
    torch.cuda.empty_cache()
    block_jacobi_phase(args, emit)
    torch.cuda.empty_cache()
    multi_row, rows[1]["bell_1024_single"] = service_phase(
        args, g, A, (indptr, indices, data), topo, part, b,
        sols["dist_halo"], errs["spmv_sell"], emit)
    rows.append(multi_row)
    torch.cuda.empty_cache()
    # ---- 4c-4e: the refined partitioners, once phase 4's operators are
    # freed, so that 4c's peak reads one operator -------------------------
    geo = georef_phase(g, A, (indptr, indices, data), topo, b, geokm, emit)
    torch.cuda.empty_cache()
    tree = tree_phase(args, g, A, (indptr, indices, data), topo, part, b,
                      emit)
    torch.cuda.empty_cache()
    table_phase(emit)
    rows[0]["launches_geokm"] = rows[0]["launches"]
    rows[0]["launches_georef"] = geo["pdist"]
    rows[0]["launches"] += geo["pdist"]
    rows[0].update({f"launches_{k}": v["pdist"] for k, v in tree.items()})
    rows[1]["launches_georef_dist_bell"] = geo["spmv_bell:sell"]
    rows[1]["launches"] += geo["spmv_bell:sell"]
    rows[1].update({f"launches_{k}_dist_hier_bell": v["spmv_bell:sell"]
                    for k, v in tree.items()})
    return rows


def emit_verified(label: str, report, emit) -> float:
    """The ``analysis_verify`` line of a build made with ``validate=True``:
    ``report`` is the ``verify_report`` the builder kept (``info
    ["seconds"]`` the verifier's host time).  Fails unless the build was
    verified and passed.  Returns the verifier's seconds."""
    check(report is not None, f"{label}: validate=True ran no verifier")
    seconds = report.info["seconds"]
    emit(phase="analysis_verify", build=label, subject=report.subject,
         seconds=seconds, ok=report.ok)
    check(report.ok, f"{label}: {report.subject} failed verification")
    return seconds


def audit_phase(label: str, op, expect_bytes, emit, sell: bool) -> int:
    """The exchange audit (``repro_torch.analysis.audit_operator``: one
    matvec and one CG chunk on the card) of ``op``, with the launch counts
    reset just before and read just after.  It must report no codes, its
    payload bytes per level must equal ``expect_bytes`` (the partition's
    comm volumes x 4), and a block-ELL operator must launch the sell
    route.  Returns the sell-route launches."""
    import torch
    from repro_torch.analysis import audit_operator
    from repro_torch.kernels import _build

    _build.reset_launches()
    t0 = time.perf_counter()
    rep = audit_operator(op)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _build.launches()
    ex = rep.info["exchange"]
    got = list(ex.payload_bytes_lvl)
    emit(phase="analysis_audit", backend=label, seconds=seconds,
         ok=rep.ok, codes=sorted(rep.codes()), payload_bytes_lvl=got,
         comm_volume_bytes_lvl=list(expect_bytes),
         rounds_lvl=[len(ex.rounds.get(lvl, {})) for lvl in range(len(got))],
         cg=rep.info["cg"], launches=launches)
    check(rep.ok, f"audit of {label} reported: {rep}")
    check(got == list(expect_bytes), f"audit of {label}: payload bytes "
          f"{got} != comm volumes x 4 {list(expect_bytes)}")
    check(rep.info["matvec"]["finite"] and rep.info["cg"]["finite"],
          f"audit of {label}: non-finite matvec or CG chunk")
    check((launches["spmv_bell:sell"] > 0) == sell,
          f"audit of {label} launched {launches}")
    return launches["spmv_bell:sell"]


def audit_warmup(emit) -> None:
    """The first dispatch mode of a process imports torch modules once
    (seconds).  One audit of a small operator on the card takes that cost
    before phase 4f, so each later audit is timed once, at its own cost;
    it must report no codes either."""
    import torch
    from repro_torch.analysis import audit_backend

    t0 = time.perf_counter()
    rep = audit_backend("dist_halo", n=256, fanouts=(4,))
    torch.cuda.synchronize()
    emit(phase="analysis_warmup", subject=rep.subject,
         seconds=time.perf_counter() - t0, ok=rep.ok)
    check(rep.ok, f"audit of the warm-up operator reported: {rep}")


def swap_rounds_consistently(plan, lvl: int, c0: int, c1: int):
    """Rounds c0 and c1 of tree level ``lvl`` exchanged consistently:
    perms, send schedule columns and the halo slot ranges every edge reads
    move together, so the result passes every PLAN0xx check — a valid
    plan, but not the one the operator runs."""
    import dataclasses
    offs = plan.level_offsets()
    S = int(plan.S_lvl[lvl])
    a0, a1 = int(offs[lvl]) + c0 * S, int(offs[lvl]) + c1 * S

    def remap(cols):
        cols = cols.clone()
        in0 = (cols >= a0) & (cols < a0 + S)
        in1 = (cols >= a1) & (cols < a1 + S)
        cols[in0] += a1 - a0
        cols[in1] += a0 - a1
        return cols

    def swapped(t):
        t = t.clone()
        t[:, [c0, c1]] = t[:, [c1, c0]]
        return t

    perms = list(plan.round_perms_lvl[lvl])
    perms[c0], perms[c1] = perms[c1], perms[c0]
    rp, si, sm = (list(x) for x in (plan.round_perms_lvl,
                                     plan.send_idx_lvl, plan.send_mask_lvl))
    rp[lvl] = tuple(perms)
    si[lvl] = swapped(si[lvl])
    sm[lvl] = swapped(sm[lvl])
    return dataclasses.replace(
        plan, round_perms_lvl=tuple(rp), send_idx_lvl=tuple(si),
        send_mask_lvl=tuple(sm), cols=remap(plan.cols),
        cols_bnd_lvl=tuple(remap(c) for c in plan.cols_bnd_lvl))


def drift_check(op, emit) -> None:
    """A consistent swap of two distinct rounds of the tree plan: the
    verifier must pass it and the audit must report exactly TRACE002."""
    from repro_torch.analysis import audit_operator, verify_plan
    plan = op.plan
    for lvl in range(plan.h):
        full = [(c, frozenset(p)) for c, p in
                enumerate(plan.round_perms_lvl[lvl]) if p]
        pair = next(((c0, c1) for i, (c0, s0) in enumerate(full)
                     for c1, s1 in full[i + 1:] if s0 != s1), None)
        if pair is not None:
            break
    check(pair is not None, "the tree plan has no two distinct rounds")
    mut = swap_rounds_consistently(plan, lvl, *pair)
    t0 = time.perf_counter()
    vrep = verify_plan(mut)
    verify_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = audit_operator(op, plan=mut, solver=False)
    audit_s = time.perf_counter() - t0
    emit(check="analysis_drift", level=lvl, rounds=list(pair),
         verify_ok=vrep.ok, verify_s=verify_s, codes=sorted(rep.codes()),
         audit_s=audit_s, ok=vrep.ok and rep.codes() == {"TRACE002"})
    check(vrep.ok, f"the verifier rejects the consistent round swap: {vrep}")
    check(rep.codes() == {"TRACE002"},
          f"the audit of the round swap reported {rep.codes()}: {rep}")


def plan_halo(plan) -> dict:
    """A flat plan's halo schedule: rounds, slots per round, the words
    that carry data and the padded exchange every matvec moves."""
    words = int(plan.send_mask.sum().item())
    return dict(halo_rounds=plan.n_rounds, halo_S=plan.S, halo_words=words,
                halo_bytes=4 * words,
                halo_padded_bytes=4 * plan.k * plan.n_rounds * plan.S)


@contextlib.contextmanager
def stage_clock(stages: list):
    """Record the host seconds of each stage of the geoRef pipeline while
    ``partition`` runs: the k-means start (``api.partition_balanced_kmeans``,
    with its result), and per level the heavy-edge matching, the
    contraction and the FM refinement (``multilevel``'s module functions).
    Each stage appends ``(stage, vertices of its graph, seconds, result)``;
    the clock stops after a ``torch.cuda.synchronize()``.  The wrappers
    are removed on exit."""
    import torch
    import repro_torch.core.api as api
    import repro_torch.core.multilevel as ml
    saved = []

    def clocked(mod, name, stage):
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def wrapper(g, *a, **kw):
            t0 = time.perf_counter()
            out = fn(g, *a, **kw)
            torch.cuda.synchronize()
            stages.append((stage, g.n, time.perf_counter() - t0,
                           out if stage == "geokm" else None))
            return out
        setattr(mod, name, wrapper)

    clocked(api, "partition_balanced_kmeans", "geokm")
    clocked(ml, "heavy_edge_matching", "matching")
    clocked(ml, "contract", "contract")
    clocked(ml, "refine_partition", "refine")
    try:
        yield stages
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def routing_recorder(calls: list):
    """Record the router's top-k expert ids (``mlp.route``) of every MoE
    layer call while the block runs: ``transformer.moe_forward`` is
    wrapped, so each call appends its (B, S, K) ids, in layer order, and
    then runs as before.  The wrapper is removed on exit."""
    from repro_torch.models import transformer
    from repro_torch.models.mlp import route
    fn = transformer.moe_forward

    def wrapper(p, x, *, top_k, **kw):
        calls.append(route(p, x, top_k)[2])
        return fn(p, x, top_k=top_k, **kw)

    transformer.moe_forward = wrapper
    try:
        yield calls
    finally:
        transformer.moe_forward = fn


def moe_stage_phase(dev, gen, emit, S: int) -> None:
    """Phase 7f: one MoE layer of olmoe-1b-7b and of granite-moe-1b-a400m
    at full width in bf16 (random weights and a unit-normal input from
    ``gen``), at the prefill shape (batch 8, S tokens, the config's
    capacity) and the decode shape (batch 8, one token, capacity 2.0):
    the CUDA-event time of each stage of ``moe_forward`` (router, slots,
    dispatch, experts, combine) and of the whole, beside the experts'
    bound and the share of the slots that routed entries fill."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import mlp
    from repro_torch.models.common import ParamInit

    bf16 = torch.bfloat16
    for arch in ("olmoe-1b-7b", "granite-moe-1b-a400m"):
        cfg = get_config(arch)
        E, K, D, Fx = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_expert
        moe = mlp.init_moe(ParamInit(gen, bf16, dev), D, E, Fx,
                           cfg.activation)
        for label, s, cf in (("prefill", S, cfg.moe_capacity),
                             ("decode", 1, 2.0)):
            B = 8
            x = torch.randn((B, s, D), generator=gen, device=dev).to(bf16)
            C = mlp.capacity(s, E, K, cf)
            probs, gates, ids = mlp.route(moe, x, K)
            flat_e, slot, keep = mlp.assign_slots(ids, E, C)
            gflat = (gates / gates.sum(-1, keepdim=True)).reshape(B, -1) \
                * keep
            disp = mlp.dispatch(x, flat_e, slot, keep, E, C)
            eout = mlp.expert_ffn(moe, disp, cfg.activation)
            ms = dict(
                route=event_ms(lambda: mlp.route(moe, x, K)),
                slots=event_ms(lambda: mlp.assign_slots(ids, E, C)),
                dispatch=event_ms(lambda: mlp.dispatch(x, flat_e, slot,
                                                       keep, E, C)),
                experts=event_ms(lambda: mlp.expert_ffn(moe, disp,
                                                        cfg.activation)),
                combine=event_ms(lambda: mlp.combine(eout, flat_e, slot,
                                                     gflat, s)),
                moe_forward=event_ms(lambda: mlp.moe_forward(
                    moe, x, n_experts=E, top_k=K, activation=cfg.activation,
                    capacity_factor=cf)))
            # the experts multiply every slot, filled or not; the routed
            # entries need the kept share of that
            flops = 2 * 3 * E * B * C * D * Fx
            nbytes = 2 * (3 * E * D * Fx + 2 * E * B * C * D)
            bound, by = bound_ms(nbytes, flops, "bfloat16")
            kept = int(keep.sum())
            emit(phase="moe_stages", arch=cfg.name, shape=label, batch=B,
                 tokens=s, capacity=C, capacity_factor=cf, stage_ms=ms,
                 stage_sum_ms=sum(v for k, v in ms.items()
                                  if k != "moe_forward"),
                 layers=cfg.n_layers,
                 moe_forward_ms_all_layers=ms["moe_forward"] * cfg.n_layers,
                 experts_bound_ms=bound, experts_bound_by=by,
                 experts_flops=flops, kept_entries=kept,
                 dropped_entries=B * s * K - kept,
                 slot_fill=kept / (E * B * C))
            del x, probs, gates, ids, flat_e, slot, keep, gflat, disp, eout
        del moe
        torch.cuda.empty_cache()


def moe_f32_phases(args, dev, emit, S: int) -> dict:
    """Phases 8b and 7e on granite-moe-1b-a400m at full width and depth in
    float32 (one model, random weights from the seed).  Returns the flash
    launches of 8b's two prefills."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.expert_placement import (coactivation_graph,
                                                   expert_loads,
                                                   permute_expert_params,
                                                   place_experts)
    from repro_torch.core.topology import PU, Topology
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import (decode_step, init_model,
                                                prefill_forward)

    cfg = get_config("granite-moe-1b-a400m")
    E, K, L = cfg.n_experts, cfg.top_k, cfg.n_layers
    # ---- 8b. prefill against prefill + decode, nothing dropped -----------
    # moe_capacity = E / K gives C >= S in every group, so both paths keep
    # every (token, k) entry (at 1.25 they drop different ones)
    cfg32 = dataclasses.replace(cfg, dtype="float32", moe_capacity=E / K)
    model = init_model(cfg32, seed=args.seed, device=dev)
    n_dec = 128
    toks = torch.from_numpy(np.random.default_rng(args.seed + 2).integers(
        0, cfg.vocab, size=(4, S), dtype=np.int32)).to(dev)
    full_ids, dec_ids = [], []
    _build.reset_launches()
    t0 = time.perf_counter()
    with routing_recorder(full_ids):
        full, _ = prefill_forward(model, cfg32, toks, cache_len=S)
    with routing_recorder(dec_ids):
        logits, cache = prefill_forward(model, cfg32, toks[:, :S - n_dec],
                                        cache_len=S)
        for t in range(S - n_dec, S):
            logits, cache = decode_step(model, cfg32, cache,
                                        toks[:, t:t + 1], t)
    launches = _build.launches()
    seconds = time.perf_counter() - t0
    scale = float(full.abs().max())
    rel = float((full - logits).abs().max()) / scale
    # per layer: tokens whose set of K experts differs between the paths
    # (a router near-tie that the two attention routes resolve apart)
    flips = []
    for layer in range(L):
        steps = dec_ids[layer::L]
        a = full_ids[layer].sort(-1).values
        b = torch.cat(steps, dim=1).sort(-1).values
        flips.append(int((a != b).any(-1).sum()))
    emit(phase="moe_consistency_f32", arch=cfg.name, batch=4, prefill=S,
         prefill_then_decode=[S - n_dec, n_dec], moe_capacity=E / K,
         max_abs_logit=scale, rel_err=rel, tol=1e-3,
         router_flips_per_layer=flips, launches=launches, seconds=seconds)
    del cache, full, logits, full_ids, dec_ids
    check(rel < 1e-3, f"{cfg.name} f32 prefill vs prefill+decode logits "
                      f"differ by {rel} of the largest |logit| (router "
                      f"flips per layer: {flips})")
    check(launches["flash"] == 2 * L and launches["flash_sm90"] == 0,
          f"the {cfg.name} f32 prefills launched {launches}, want flash "
          f"{2 * L} times and flash_sm90 never")

    # ---- 7e. LDHT placement at full width ---------------------------------
    # router statistics of one 2048-token row of the serving prompts, every
    # layer's experts placed on four EP ranks (one at speed 2.0), then the
    # model permuted in place: the same logits at the config's capacity
    cfg_p = dataclasses.replace(cfg, dtype="float32")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(8, S),
                                                dtype=np.int32)
    ids = []
    with routing_recorder(ids):
        prefill_forward(model, cfg_p, torch.from_numpy(prompts[:1]).to(dev))
    ids = [i.reshape(-1, K).cpu().numpy() for i in ids]
    batch = torch.from_numpy(prompts[:4]).to(dev)
    before, _ = prefill_forward(model, cfg_p, batch)
    ep = 4
    topo = Topology(pus=[PU(speed=2.0, memory=1e9)]
                    + [PU(speed=1.0, memory=1e9) for _ in range(ep - 1)])
    contiguous = np.arange(E) // (E // ep)
    rows = []
    t_coact = t_place = 0.0
    for layer, lid in zip(model.layers, ids):
        loads = expert_loads(np.bincount(lid.ravel(), minlength=E))
        t0 = time.perf_counter()
        W = coactivation_graph(lid, E)
        t1 = time.perf_counter()
        res = place_experts(loads, topo, coact=W)
        t_place += time.perf_counter() - t1
        t_coact += t1 - t0
        check(sorted(res.perm.tolist()) == list(range(E))
              and (np.bincount(res.rank_of, minlength=ep) == E // ep).all(),
              "place_experts returned no valid placement")
        rows.append((res.max_load_ratio,
                     float((np.bincount(contiguous, weights=loads)
                            / topo.speeds).max()),
                     res.coact_cut,
                     float(W[contiguous[:, None] != contiguous[None, :]]
                           .sum())))
        permute_expert_params(layer.ffn, res.perm)
    after, _ = prefill_forward(model, cfg_p, batch)
    scale = float(before.abs().max())
    rel = float((after - before).abs().max()) / scale
    r = np.array(rows)
    emit(phase="moe_placement", arch=cfg.name, calibration_tokens=S,
         ep_ranks=ep, speeds=topo.speeds.tolist(), layers=L,
         eq2_max_load_ratio=dict(mean=float(r[:, 0].mean()),
                                 max=float(r[:, 0].max())),
         eq2_contiguous=dict(mean=float(r[:, 1].mean()),
                             max=float(r[:, 1].max())),
         coact_cut=dict(mean=float(r[:, 2].mean()), max=float(r[:, 2].max())),
         coact_cut_contiguous=dict(mean=float(r[:, 3].mean()),
                                   max=float(r[:, 3].max())),
         coactivation_graph_s=t_coact, place_experts_s=t_place,
         logits_batch=4, max_abs_logit=scale, rel_err=rel, tol=1e-5)
    check(rel < 1e-5, f"placed logits differ from the unplaced ones by "
                      f"{rel} of the largest |logit|")
    del model, before, after
    torch.cuda.empty_cache()
    return dict(launches=launches["flash"], launches_path="moe_consistency_f32")


def cap_report(sizes, start_sizes, tw, mems) -> dict:
    """Block sizes against the refinement's caps ``min(ceil(tw (1 +
    0.03)), floor(mem))``.  FM moves a vertex only into a block with room,
    so a block may stand above its cap only where its start already did,
    and then no higher (a start's rounding puts up to a few vertices above
    ``floor(mem)`` on a saturated PU)."""
    import numpy as np
    caps = np.minimum(np.ceil(np.asarray(tw) * 1.03), np.floor(mems))
    over = sizes > caps
    ok = bool(np.all(sizes <= np.maximum(caps, start_sizes)))
    return dict(sizes=sizes.tolist(), caps=caps.tolist(),
                start_sizes=np.asarray(start_sizes).tolist(),
                over_cap=(sizes - caps)[over].astype(int).tolist(),
                over_cap_at_start=(np.asarray(start_sizes) - caps)[
                    np.asarray(start_sizes) > caps].astype(int).tolist(),
                within_caps=ok)


def georef_phase(g, A, csr, topo, b, geokm, emit) -> dict:
    """Phase 4c: ``partition`` with its default method (geoRef: geoKM with
    the pdist kernel, then the multilevel FM on the host) on phase 4's
    system, seed and topology; its stages; its partition beside geoKM's;
    its ``dist_bell`` plan and solve beside phase 4's.  Returns the
    launches of the partition (pdist) and of the solve (the sell
    route)."""
    import numpy as np
    import torch
    from repro_torch.core.api import partition
    from repro_torch.core.metrics import summarize
    from repro_torch.kernels import _build
    from repro_torch.sparse.operator import make_operator

    stages = []
    _build.reset_launches()
    t0 = time.perf_counter()
    with stage_clock(stages):
        part, tw = partition(g, topo, use_pallas=True)
    partition_s = time.perf_counter() - t0
    launches = _build.launches()
    start = [out for stage, _, _, out in stages if stage == "geokm"]
    check(len(start) == 1, f"geoRef ran {len(start)} k-means")
    same_start = int((start[0] == geokm["part"]).sum())
    levels = sorted({n for stage, n, _, _ in stages if stage == "refine"},
                    reverse=True)
    per = {lvl: {st: sum(s for st2, n, s, _ in stages
                         if st2 == st and n == lvl)
                 for st in ("matching", "contract", "refine")}
           for lvl in levels}
    mine = summarize(g, part, topo, tw)
    base = summarize(g, geokm["part"], topo, tw)
    keys = ("cut", "max_comm_volume", "total_comm_volume", "imbalance",
            "mem_violations", "bottleneck_objective")
    caps = cap_report(np.bincount(part, minlength=topo.k),
                      np.bincount(geokm["part"], minlength=topo.k), tw,
                      topo.memories)
    emit(phase="georef", seconds=partition_s,
         geokm_s=sum(s for st, _, s, _ in stages if st == "geokm"),
         geokm_s_phase4=geokm["partition_s"],
         levels=[dict(vertices=lvl, coarsening_s=per[lvl]["matching"]
                      + per[lvl]["contract"],
                      matching_s=per[lvl]["matching"],
                      contract_s=per[lvl]["contract"],
                      refine_s=per[lvl]["refine"]) for lvl in levels],
         start_equal_to_phase4=same_start, n=g.n, launches=launches,
         **{k: mine[k] for k in keys},
         geokm={k: base[k] for k in keys}, **caps)
    check(launches["pdist"] > 0, "geoRef never launched pdist")
    check(same_start == g.n, f"geoRef's k-means start differs from phase "
                             f"4's geoKM in {g.n - same_start} vertices")
    check(caps["within_caps"], f"geoRef broke its caps: {caps}")
    check(mine["cut"] <= base["cut"], f"geoRef's cut {mine['cut']} is "
                                      f"above geoKM's {base['cut']}")

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    bytes0 = torch.cuda.memory_allocated()
    op = make_operator(*csr, "dist_bell", part=part, k=topo.k)
    torch.cuda.synchronize()
    op_s = time.perf_counter() - t0
    op_bytes = torch.cuda.memory_allocated() - bytes0
    t0 = time.perf_counter()
    res = op.solve(b, tol=1e-6, max_iters=2000)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    solve_launches = _build.launches()
    x = op.gather(res.x)
    iters = int(res.iters.cpu())
    rel = float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))
    mv_ms, it_ms = timed_cg(op, op.scatter(b))
    halo = plan_halo(op.plan)
    emit(phase="georef_dist_bell", operator_s=op_s, solve_s=solve_s,
         iters=iters, rel_residual=rel, matvec_ms=mv_ms, iteration_ms=it_ms,
         iters_timed=40, B=op.plan.B, **halo, operator_bytes=op_bytes,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=solve_launches,
         geokm={k: geokm[k] for k in (
             "iters", "matvec_ms", "iteration_ms", "max_memory_allocated",
             "operator_bytes", *halo)})
    check(np.isfinite(x).all() and x.shape == (g.n,),
          "geoRef dist_bell: non-finite or misshapen solution")
    check(rel < 1e-4, f"geoRef dist_bell: relative residual {rel} >= 1e-4")
    check(0 < iters < 2000, f"geoRef dist_bell: {iters} iterations")
    check(solve_launches["spmv_bell:sell"] > 0,
          "the geoRef dist_bell solve never launched the sell route")
    del op, res
    return {"pdist": launches["pdist"],
            "spmv_bell:sell": solve_launches["spmv_bell:sell"]}


def tree_phase(args, g, A, csr, topo, base, b, emit) -> dict:
    """Phase 4d: the tree-aware pipelines with geoRef on phase 4's system
    and topology, each ``HierPartition`` fed to
    ``make_operator("dist_hier_bell", part=...)`` and solved; the tree
    objective and per-level cut beside phase 5b's tables (the canonical
    fanouts (2, 2, 2) table, ``topo.pod_assignment(2)``) over phase 4's
    geoKM partition ``base``.  Returns each pipeline's pdist and
    sell-route launches."""
    import numpy as np
    import torch
    from repro_torch.core.api import partition_hier, partition_tree
    from repro_torch.core.metrics import (tree_comm_volumes, tree_cut_split,
                                          tree_objective)
    from repro_torch.core.topology import canonical_ancestors
    from repro_torch.kernels import _build
    from repro_torch.sparse.operator import make_operator

    cases = (("partition_tree", canonical_ancestors((2, 2, 2)),
              lambda: partition_tree(g, topo, fanouts=(2, 2, 2),
                                     use_pallas=True, validate=True)),
             ("partition_hier", topo.pod_assignment(2)[None, :],
              lambda: partition_hier(g, topo, pods=2, use_pallas=True,
                                     validate=True)))
    out = {}
    for label, base_anc, run in cases:
        _build.reset_launches()
        t0 = time.perf_counter()
        res = run()
        partition_s = time.perf_counter() - t0
        part_launches = _build.launches()
        emit_verified(label, res.verify_report, emit)

        def split(part, anc):
            return dict(
                tree_objective=tree_objective(g, part, anc, res.lams),
                cut_by_level=tree_cut_split(g, part, anc).tolist(),
                comm_volume_by_level=tree_comm_volumes(
                    g, part, topo.k, anc).sum(axis=1).tolist())

        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        op = make_operator(*csr, "dist_hier_bell", part=res)
        torch.cuda.synchronize()
        op_s = time.perf_counter() - t0
        r = op.solve(b, tol=1e-6, max_iters=2000)
        x = op.gather(r.x)
        launches = _build.launches()
        iters = int(r.iters.cpu())
        rel = float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))
        mv_ms, it_ms = timed_cg(op, op.scatter(b))
        emit(phase="tree_aware", pipeline=label, grid=args.side,
             fanouts=list(res.fanouts), lams=list(res.lams),
             partition_s=partition_s, partition_launches=part_launches,
             sizes=np.bincount(res.part, minlength=topo.k).tolist(),
             anc=res.anc.tolist(), **split(res.part, res.anc),
             geokm_canonical=split(base, base_anc), operator_s=op_s,
             S_lvl=list(op.plan.S_lvl),
             n_rounds_lvl=list(op.plan.n_rounds_lvl), iters=iters,
             rel_residual=rel, matvec_ms=mv_ms, iteration_ms=it_ms,
             iters_timed=40, launches=launches,
             max_memory_allocated=torch.cuda.max_memory_allocated())
        check(part_launches["pdist"] > 0, f"{label} never launched pdist")
        check(np.isfinite(x).all() and x.shape == (g.n,),
              f"{label} dist_hier_bell: non-finite or misshapen solution")
        check(rel < 1e-4, f"{label} dist_hier_bell: relative residual {rel}")
        check(0 < iters < 2000, f"{label} dist_hier_bell: {iters} iterations")
        check(launches["spmv_bell:sell"] > 0,
              f"{label} dist_hier_bell never launched the sell route")
        out[label] = {"pdist": part_launches["pdist"],
                      "spmv_bell:sell": launches["spmv_bell:sell"]}
        del op, r
        torch.cuda.empty_cache()
    return out


def table_phase(emit) -> None:
    """Phase 4e: ``evaluate`` (Table IV) over the eight methods on
    grid((TABLE_SIDE, TABLE_SIDE)) under TOPO1 exp 4 scaled to it: one
    line per method, the caps of the refined methods against their
    starts, and which method wins each metric (reported, not
    asserted)."""
    import numpy as np
    from repro_torch.core.api import METHODS, _greedy_growing, evaluate
    from repro_torch.core.balanced_kmeans import (
        partition_hierarchical_kmeans)
    from repro_torch.core.block_sizes import target_block_sizes
    from repro_torch.core.topology import Topology, scale_to_load
    from repro_torch.sparse.generators import grid

    side = TABLE_SIDE
    g = grid((side, side))
    topo = scale_to_load(Topology.topo1(8, 2 / 8, 8.0, 8.5), g.n)
    t0 = time.perf_counter()
    rows = evaluate(g, topo, METHODS, verbose=False)
    total_s = time.perf_counter() - t0
    tw = target_block_sizes(g.n, topo)

    def sizes_of(row):
        return np.rint(np.asarray(row["per_pu_compute"])
                       * topo.speeds).astype(np.int64)

    starts = {"geoRef": sizes_of(rows["geoKM"]),
              "sfcRef": sizes_of(rows["sfc"]),
              "geoHier": np.bincount(partition_hierarchical_kmeans(
                  g, tw, topo.fanouts), minlength=topo.k),
              "greedyRef": np.bincount(_greedy_growing(g, tw),
                                       minlength=topo.k)}
    for m in METHODS:
        caps = (cap_report(sizes_of(rows[m]), starts[m], tw, topo.memories)
                if m in starts else {})
        emit(phase="table_iv", method=m, grid=side, **rows[m], **caps)
        check(rows[m]["mem_violations"] == 0,
              f"{m}: {rows[m]['mem_violations']} memory violations")
        check(caps.get("within_caps", True), f"{m} broke its caps: {caps}")
    check(rows["geoRef"]["cut"] <= rows["geoKM"]["cut"],
          f"geoRef's cut {rows['geoRef']['cut']} is above geoKM's "
          f"{rows['geoKM']['cut']}")
    check(rows["sfcRef"]["cut"] <= rows["sfc"]["cut"],
          f"sfcRef's cut {rows['sfcRef']['cut']} is above sfc's "
          f"{rows['sfc']['cut']}")
    best = {k: min(METHODS, key=lambda m: rows[m][k])
            for k in ("cut", "max_comm_volume", "total_comm_volume",
                      "bottleneck_objective", "time_s")}
    emit(phase="table_iv_winners", grid=side, seconds=total_s, **best)


def bell_checks(args, dev, gen, emit, errs: dict) -> None:
    """Phase 3's block-ELL part: the sell route in every form on the 256^2
    Laplacian against its plain versions and scipy, and non-finite x
    against the dense product.  The largest error of each check goes to
    ``errs``."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import (spmv_block_ell_multi_ref,
                                         spmv_block_ell_ref, spmv_sell_ref)
    from repro_torch.kernels.spmv_bell import (bell_index, csr_to_block_ell,
                                               nonfinite_pass, spmv_block_ell)
    from repro_torch.sparse.generators import grid
    from repro_torch.sparse.graph import laplacian_csr

    g256 = grid((256, 256))
    ip, ix, dat = laplacian_csr(g256, shift=1e-2)
    A256 = sp.csr_matrix((dat, ix, ip), shape=(g256.n, g256.n))
    x256 = np.random.default_rng(args.seed).normal(
        size=g256.n).astype(np.float32)

    def held(name, got, want, A_x=None, **kw):
        """``got`` against the plain version's ``want`` (and scipy's
        ``A_x``) within 1e-4."""
        ok, err = close(got, want, 1e-4, 1e-4)
        err_sp = None
        if A_x is not None:
            ok_sp, err_sp = close(got.cpu(), torch.from_numpy(A_x), 1e-4,
                                  1e-4)
            ok = ok and ok_sp
        emit(check=name, grid=256, **kw, max_abs_err=err,
             max_abs_err_scipy=err_sp, tol=1e-4, ok=ok)
        check(ok, f"{name} {kw} disagrees: {err} (plain) / {err_sp} "
                  f"(scipy)")
        errs[name] = max(errs.get(name, 0.0), err)

    def same_pattern(name, got, want, **kw):
        """An Inf and a NaN in x spread as in the dense product ``want``."""
        fin = torch.isfinite(want)
        same = (torch.equal(torch.isnan(got), torch.isnan(want))
                and torch.equal(torch.isinf(got), torch.isinf(want)))
        ok, err = close(got[fin], want[fin], 1e-4, 1e-4)
        emit(check=name, grid=256, **kw,
             non_finite_rows=int((~fin).reshape(fin.shape[0], -1)
                                 .any(dim=1).sum()),
             same_pattern=same, max_abs_err=err, ok=ok and same)
        check(ok and same, f"{name} {kw}: an Inf/NaN in x spreads unlike "
                           f"the dense product")

    for bm, bk in ((8, 128), (16, 128), (8, 256), (16, 256)):
        blocks, cols, _ = csr_to_block_ell(ip, ix, dat, g256.n, bm=bm,
                                           bk=bk)
        bt = torch.from_numpy(blocks).to(dev)
        ct = torch.from_numpy(cols).to(dev)
        xt = torch.from_numpy(x256).to(dev)
        nnzb = int(cols.shape[1])
        # without an index the wrapper builds one and launches the kernel
        n0 = _build.launches()["spmv_bell:sell"]
        held("spmv_sell", spmv_block_ell(bt, ct, xt),
             spmv_block_ell_ref(bt, ct, xt), A256 @ x256,
             form="single_without_index", bm=bm, bk=bk, nnzb=nnzb)
        check(_build.launches()["spmv_bell:sell"] == n0 + 1,
              "spmv_block_ell without an index did not launch spmv_sell")
        for dt in (torch.float32, torch.float64):
            bd = bt.to(dt)
            index = bell_index(bd, ct, g256.n)
            npdt = np.float32 if dt == torch.float32 else np.float64
            xd = torch.from_numpy(x256).to(dev).to(dt)
            held("spmv_sell", spmv_block_ell(bd, ct, xd, index=index),
                 spmv_sell_ref(index, bd, ct, xd), A256 @ x256.astype(npdt),
                 form="single", bm=bm, bk=bk, dtype=str(dt))
            # the stacked form: three PU blocks, the last one empty
            b3 = torch.stack([bd, -2 * bd, torch.zeros_like(bd)])
            c3 = torch.stack([ct, ct, ct])
            i3 = bell_index(b3, c3, g256.n)
            x3 = torch.randn(3, g256.n, generator=gen, device=dev).to(dt)
            want3 = spmv_block_ell_ref(b3, c3, x3)
            got3 = spmv_block_ell(b3, c3, x3, index=i3)
            held("spmv_sell", got3, spmv_sell_ref(i3, b3, c3, x3),
                 form="stacked", bm=bm, bk=bk, dtype=str(dt))
            held("spmv_sell", got3, want3, form="stacked_vs_dense_plain",
                 bm=bm, bk=bk, dtype=str(dt))
            # the batched form: nb = 33 takes the column-chunk loop
            for nb in (1, 3, 16, 33):
                xm = np.random.default_rng(args.seed + nb).normal(
                    size=(g256.n, nb))
                xd = torch.from_numpy(xm).to(dev).to(dt)
                ax = A256 @ xm.astype(npdt)
                got = spmv_block_ell(bd, ct, xd, index=index)
                held("spmv_sell", got, spmv_sell_ref(index, bd, ct, xd), ax,
                     form="batched", bm=bm, bk=bk, nb=nb, dtype=str(dt))
                held("spmv_sell", got, spmv_block_ell_multi_ref(bd, ct, xd),
                     form="batched_vs_dense_plain", bm=bm, bk=bk, nb=nb,
                     dtype=str(dt))
            # an Inf and a NaN in x spread as in the dense product (nb =
            # 33 takes the flagged branch's column-chunk loop)
            xd[5, 1], xd[700, 4] = float("inf"), float("nan")
            for xb in (xd, xd[:, 1:2].contiguous()):
                want = spmv_block_ell_multi_ref(bd, ct, xb)
                kw = dict(bm=bm, bk=bk, nb=xb.shape[1], dtype=str(dt))
                same_pattern("spmv_sell_non_finite", spmv_block_ell(
                    bd, ct, xb, index=index), want, form="batched", **kw)
            x1 = xd[:, 1].contiguous()
            same_pattern("spmv_sell_non_finite", spmv_block_ell(
                bd, ct, x1, index=index), spmv_block_ell_ref(bd, ct, x1),
                form="single", bm=bm, bk=bk, dtype=str(dt))
            x3[1, 5] = float("inf")
            same_pattern("spmv_sell_non_finite", spmv_block_ell(
                b3, c3, x3, index=i3), spmv_block_ell_ref(b3, c3, x3),
                form="stacked", bm=bm, bk=bk, dtype=str(dt))
    # the first pass alone: x at every offset from a 16-byte boundary, an
    # Inf in its scalar head, its vector body or its scalar tail
    wrong = []
    for dt in (torch.float32, torch.float64):
        for off in range(16 // torch.empty(0, dtype=dt).element_size()):
            buf = torch.zeros(1037 + off, dtype=dt, device=dev)
            x = buf[off:]
            if int(nonfinite_pass(x)) != 0:
                wrong.append((str(dt), off, None))
            for pos in (0, 1, 2, 500, 1035, 1036):
                x[pos] = float("inf")
                if int(nonfinite_pass(x)) != 1:
                    wrong.append((str(dt), off, pos))
                x[pos] = 0
    emit(check="nonfinite_pass", misses=wrong, ok=not wrong)
    check(not wrong, f"the non-finite pass missed {wrong}")
    torch.cuda.synchronize()


def host_csr_tensor(a, dev):
    """A scipy CSR matrix as a torch CSR tensor on ``dev`` (int64 indices,
    its values' dtype), built from the host arrays."""
    import numpy as np
    import torch
    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int64)),
        torch.from_numpy(a.indices.astype(np.int64)),
        torch.from_numpy(a.data), size=a.shape,
        check_invariants=False).to(dev)


def graph_ms(fn, inner: int = 20) -> float:
    """Device time per call of ``fn``: ``inner`` calls captured in one CUDA
    graph, its replay timed by ``event_ms``.  The host's per-call work (the
    wrapper's checks, allocation, the ctypes call) is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    ms = event_ms(graph.replay) / inner
    del graph
    return ms


def bell_times(blocks, cols, index, x, library: dict, old=None) -> dict:
    """The sell route on one operand: its eager time per call, its device
    time (a CUDA graph) and host time per call (50 calls enqueued back to
    back, host clock), its non-finite pass alone, its plain version, each
    ``library`` call (name -> callable; the first is the yardstick); the
    bound on what the product needs (the nonzeros' values and int32
    columns, x once, y once) and the block stream's (the floor of a kernel
    that streams the blocks).  ``old``: another implementation of the same
    product (an older tree's kernel), timed in turns with the sell route
    (old, sell, sell, old)."""
    import torch
    from repro_torch.kernels.ref import spmv_sell_ref
    from repro_torch.kernels.spmv_bell import nonfinite_pass, spmv_block_ell

    def sell():
        return spmv_block_ell(blocks, cols, x, index=index)

    if old is None:
        turns = {"sell": [event_ms(sell)]}
    else:
        t = [event_ms(f) for f in (old, sell, sell, old)]
        turns = {"old": [t[0], t[3]], "sell": t[1:3]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        sell()
    host_ms = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    nb = x.shape[1] if blocks.dim() == 4 and x.dim() == 2 else 1
    elt = blocks.element_size()
    nz_bytes = index.nnz * (elt + 4) + 2 * x.numel() * elt
    bound, by = bound_ms(nz_bytes, 2 * index.nnz * nb)
    block_bytes = (blocks.numel() * elt + cols.numel() * 4
                   + 2 * x.numel() * elt)
    lib = {name: event_ms(call) for name, call in library.items()}
    extra = {} if old is None else dict(
        old_ms=statistics.median(turns["old"]), turns_ms=turns)
    return dict(
        ms=statistics.median(turns["sell"]), **extra,
        graph_ms=graph_ms(sell), host_enqueue_ms=host_ms,
        nonfinite_pass_ms=graph_ms(lambda: nonfinite_pass(x)),
        plain_ms=event_ms(lambda: spmv_sell_ref(index, blocks, cols, x),
                          reps=5),
        bound_ms=bound, bound_by=by, bound_bytes=nz_bytes,
        block_stream_bound_ms=bound_ms(block_bytes,
                                       2 * blocks.numel() * nb)[0],
        library_ms=next(iter(lib.values())), library_all_ms=lib,
        nnz=index.nnz, index_entries=len(index.cols), nb=nb)


def timed_cg(op, xop, n_it: int = 40) -> tuple[float, float]:
    """Matvec ms and CG ms per iteration of ``op`` on ``xop``: CUDA
    events, the iteration time the median of 5 solves of ``n_it``
    iterations at tol 0 (which never converges)."""
    fused = op.fused_solver(tol=0.0, max_iters=n_it)
    return (event_ms(lambda: op.matvec(xop)),
            event_ms(lambda: fused(xop), reps=5) / n_it)


def other_backends(g, A, csr, topo, part, b, op_h, x_halo,
                   emit) -> tuple[int, int]:
    """Phase 5b: the exchange schedules the main path does not take, on
    its system; the (2, 2, 2) tree plan built with ``validate=True``, then
    audited clean and against a consistent round swap (phase 4f), and
    dist_hier_bell audited.  Returns dist_hier_bell's spmv_bell:sell
    launches in its solve and in its audit."""
    import numpy as np
    import torch
    from repro_torch.core.metrics import tree_comm_volumes
    from repro_torch.core.topology import canonical_ancestors
    from repro_torch.kernels import _build
    from repro_torch.sparse.operator import make_operator

    pods = topo.pod_assignment(2)
    ancs = {"dist_hier_pods2": pods[None, :],
            "dist_hier_tree222": canonical_ancestors((2, 2, 2)),
            "dist_hier_bell_pods2": pods[None, :]}
    cases = (("dist_halo_seq", "dist_halo_seq", {}),
             ("dist_allgather", "dist_allgather", {}),
             ("dist_hier_pods2", "dist_hier", {"pods": pods}),
             ("dist_hier_tree222", "dist_hier", {"fanouts": (2, 2, 2)}),
             ("dist_hier_bell_pods2", "dist_hier_bell", {"pods": pods}))
    xop = op_h.scatter(b)
    hier_bell = audit_hier_bell = 0
    for label, backend, kw in cases:
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        validate = label == "dist_hier_tree222"
        t0 = time.perf_counter()
        op = make_operator(*csr, backend, part=part, k=8,
                           validate=validate, **kw)
        torch.cuda.synchronize()
        verify_s = (emit_verified(label, op.plan.verify_report, emit)
                    if validate else 0.0)
        plan_s = time.perf_counter() - t0 - verify_s
        t0 = time.perf_counter()
        res = op.solve(b, tol=1e-6, max_iters=2000)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        launches = _build.launches()
        x = op.gather(res.x)
        iters = int(res.iters.cpu())
        rel = float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))
        agree = float(np.abs(x - x_halo).max() / np.abs(x_halo).max())
        mv_ms, it_ms = timed_cg(op, xop)
        plan = op.plan
        levels = ({"fanouts": list(plan.fanouts),
                   "S_lvl": list(plan.S_lvl),
                   "n_rounds_lvl": list(plan.n_rounds_lvl)}
                  if backend.startswith("dist_hier") else
                  {"S": plan.S, "n_rounds": plan.n_rounds})
        emit(phase="backend", backend=label, plan_build_s=plan_s,
             verify_s=verify_s, solve_s=solve_s, B=plan.B, **levels,
             iters=iters,
             rel_residual=rel, agreement_with_dist_halo=agree,
             matvec_ms=mv_ms, iteration_ms=it_ms, iters_timed=40,
             launches=launches,
             max_memory_allocated=torch.cuda.max_memory_allocated())
        check(np.isfinite(x).all() and x.shape == (g.n,),
              f"{label}: non-finite or misshapen solution")
        check(rel < 1e-4, f"{label}: relative residual {rel} >= 1e-4")
        check(agree < 1e-5, f"{label} and dist_halo disagree: {agree}")
        check(0 < iters < 2000, f"{label}: {iters} iterations")
        bell = backend.endswith("_bell")
        check((launches["spmv_bell:sell"] > 0) == bell
              and launches["spmv_bell_multi:sell"] == 0,
              f"{label} launched {launches}")
        if bell:
            hier_bell = launches["spmv_bell:sell"]
        if label in ("dist_hier_tree222", "dist_hier_bell_pods2"):
            expect = [float(v.sum()) * 4 for v in tree_comm_volumes(
                g, part, 8, ancs[label])]
            sell = audit_phase(label, op, expect, emit, sell=bell)
            if bell:
                audit_hier_bell = sell
            else:
                drift_check(op, emit)
        del op, plan, res
        torch.cuda.empty_cache()
    return hier_bell, audit_hier_bell


def block_jacobi_phase(args, emit) -> None:
    """Phase 5c: block-Jacobi PCG where its dense inverses fit."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from repro_torch.core.api import partition
    from repro_torch.core.topology import Topology, scale_to_load
    from repro_torch.sparse.generators import grid
    from repro_torch.sparse.graph import laplacian_csr
    from repro_torch.sparse.operator import cg_solve_global, make_operator

    side = 96
    g = grid((side, side))
    csr = laplacian_csr(g, shift=1e-2)
    A = sp.csr_matrix((csr[2], csr[1], csr[0]), shape=(g.n, g.n))
    topo = scale_to_load(Topology.topo1(8, 2 / 8, 8.0, 8.5), g.n)
    part, _ = partition(g, topo, "geoKM", use_pallas=True)
    b = np.random.default_rng(args.seed + 1).normal(
        size=g.n).astype(np.float32)
    tol = 1e-7
    op = make_operator(*csr, "dist_halo", part=part, k=8)
    res = op.solve(b, tol=tol, max_iters=2000)
    x_plain = op.gather(res.x)
    plain_iters = int(res.iters.cpu())
    hier = make_operator(*csr, "dist_hier", part=part, k=8,
                         pods=topo.pod_assignment(2))
    for label, o, composable in (("dist_halo", op, False),
                                 ("dist_hier_pods2", hier, False),
                                 ("dist_hier_pods2", hier, True)):
        t0 = time.perf_counter()
        o.plan.block_jacobi_inv()
        torch.cuda.synchronize()
        inv_s = time.perf_counter() - t0
        if composable:
            x, iters, _ = cg_solve_global(o, b, tol=tol, max_iters=2000,
                                          precondition="block_jacobi")
        else:
            r = o.solve(b, tol=tol, max_iters=2000,
                        precondition="block_jacobi")
            x, iters = o.gather(r.x), int(r.iters.cpu())
        rel = float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))
        agree = float(np.abs(x - x_plain).max() / np.abs(x_plain).max())
        emit(phase="block_jacobi", grid=side, backend=label,
             path="cg_solve_global" if composable else "fused", B=o.plan.B,
             inverse_bytes=o.plan.k * o.plan.B ** 2 * 4,
             host_inversion_s=inv_s, iters=iters, plain_cg_iters=plain_iters,
             rel_residual=rel, agreement_with_plain=agree, tol=tol)
        check(np.isfinite(x).all(), f"block-Jacobi {label}: non-finite")
        check(rel < 1e-4, f"block-Jacobi {label}: residual {rel} >= 1e-4")
        check(agree < 1e-5, f"block-Jacobi {label} and plain dist_halo "
                            f"disagree: {agree}")
        check(0 < iters < 2000, f"block-Jacobi {label}: {iters} iterations")


def service_phase(args, g, A, csr, topo, part, b, halo_sol, sell_err,
                  emit) -> tuple[dict, dict]:
    """Phase 5d: solver serving on phase 4's system.  Returns the
    spmv_bell_multi:sell row of the kernels line and spmv_bell:sell's
    numbers on the 1024^2 blocks."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from repro_torch.core.replan_policy import DriftPolicy
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import (spmv_block_ell_multi_ref,
                                         spmv_block_ell_ref, spmv_sell_ref)
    from repro_torch.kernels.spmv_bell import spmv_block_ell
    from repro_torch.launch.serve import SolverService
    from repro_torch.sparse.cg import CHUNK
    from repro_torch.sparse.graph import laplacian_csr
    from repro_torch.sparse.operator import cg_solve_global, make_operator
    from repro_torch.sparse.replan import EdgeDelta, apply_delta_csr

    n, tol, buckets = g.n, 1e-6, (1, 2, 4, 8, 16)
    kw = dict(buckets=buckets, tol=tol, max_iters=2000)

    class Recorded(SolverService):
        """Keeps each batched CG's own result (the padding columns'
        iterations included) and its CUDA-event time in ``last``."""

        def _run(self, op, bcols):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = super()._run(op, bcols)
            end.record()
            end.synchronize()
            self.last = dict(cg_ms=start.elapsed_time(end),
                             iters=res.iters.cpu().numpy())
            return res

    def serve(svc, label, mat, bb, A_mat):
        """One request with the counts reset just before and read just
        after; its JSON line; the real columns' residuals against A."""
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        resp = svc.solve(*mat, bb)
        request_s = time.perf_counter() - t0
        launches = _build.launches()
        nb, last = bb.shape[1], svc.last
        x = resp.x
        rel = (np.linalg.norm(A_mat @ x - bb, axis=0)
               / np.linalg.norm(bb, axis=0))
        it = np.asarray(resp.iters)
        emit(phase="solver_service", backend=label, width=nb,
             bucket=resp.bucket, cache_hit=resp.cache_hit,
             iters_max=int(it.max()), iters_min=int(it.min()),
             padding_iters=last["iters"][nb:].tolist(),
             cg_ms=last["cg_ms"], request_s=request_s,
             ms_per_batched_iteration=last["cg_ms"] / max(
                 int(last["iters"].max()), 1),
             rel_residual_max=float(rel.max()), launches=launches,
             max_memory_allocated=torch.cuda.max_memory_allocated())
        check(np.isfinite(x).all() and x.shape == (n, nb),
              f"{label} service: non-finite or misshapen solution")
        check(rel.max() < 1e-4, f"{label} service: residual {rel.max()}")
        check((last["iters"][nb:] == 0).all(),
              f"{label} service: padding columns iterated "
              f"{last['iters'][nb:]}")
        return resp, launches

    # ---- dist_halo service: two matrices, batched traffic ----------------
    A2 = laplacian_csr(g, shift=2e-2)
    pool = [(csr, A), (A2, sp.csr_matrix((A2[2], A2[1], A2[0]),
                                         shape=A.shape))]
    svc = Recorded(backend="dist_halo", capacity=4, part=part, k=8, **kw)
    rng = np.random.default_rng(args.seed)
    padded = 0
    for r in range(SOLVER_REQUESTS):
        mat, A_mat = pool[r % 2]
        nb = int(rng.integers(1, 17))
        bb = rng.normal(size=(n, nb)).astype(np.float32)
        if r == 0:
            bb[:, 0] = b
        resp, launches = serve(svc, "dist_halo", mat, bb, A_mat)
        padded += resp.bucket - nb
        check(not any(launches[k] for k in BELL_COUNTS),
              f"the dist_halo service launched {launches}")
        if r == 0:
            x0, it0 = halo_sol
            agree = float(np.abs(resp.x[:, 0] - x0).max()
                          / np.abs(x0).max())
            emit(check="service_vs_phase4", agreement=agree,
                 iters=int(resp.iters[0]), iters_phase4=it0)
            check(agree < 1e-5, f"served column 0 and phase 4's dist_halo "
                                f"solution differ by {agree}")
            check(abs(int(resp.iters[0]) - it0) <= 2,
                  f"served column 0 took {int(resp.iters[0])} iterations, "
                  f"phase 4 {it0}")
    s = svc.stats
    emit(phase="solver_service_stats", backend="dist_halo",
         **dataclasses.asdict(s), padding_waste=s.padding_waste)
    check(s.operator_misses == 2 and s.operator_hits == 6
          and s.padded_cols == padded, f"dist_halo service counters {s}")
    del svc, pool, A2
    torch.cuda.empty_cache()

    # ---- bell service: the multi-column kernel ---------------------------
    svc = Recorded(backend="bell", capacity=2, **kw)
    multi_launches, served = 0, []
    for nb in (16, 3):
        bb = rng.normal(size=(n, nb)).astype(np.float32)
        resp, launches = serve(svc, "bell", csr, bb, A)
        chunks = -(-int(svc.last["iters"].max()) // CHUNK)
        check(launches["spmv_bell_multi:sell"] == 1 + CHUNK * chunks
              and sum(launches[k] for k in BELL_COUNTS)
              == launches["spmv_bell_multi:sell"],
              f"the bell service launched {launches}, want "
              f"spmv_bell_multi:sell once per matvec "
              f"({1 + CHUNK * chunks}) and no other block-ELL kernel")
        multi_launches += launches["spmv_bell_multi:sell"]
        served.append((bb, resp))
    check(svc.stats.operator_misses == 1 and svc.stats.operator_hits == 1,
          f"bell service counters {svc.stats}")
    _, op, _ = svc.operator_for(*csr)
    for bb, resp in served:
        nb = bb.shape[1]
        _build.reset_launches()
        worst, worst_it = 0.0, 0
        for j in range(nb):
            xs, its, _ = cg_solve_global(op, bb[:, j], tol=tol,
                                         max_iters=2000)
            worst = max(worst, float(np.abs(resp.x[:, j] - xs).max()
                                     / np.abs(xs).max()))
            worst_it = max(worst_it, abs(int(resp.iters[j]) - its))
        single = _build.launches()
        emit(check="bell_service_vs_single_columns", width=nb,
             agreement=worst, iters_diff=worst_it, launches=single)
        check(worst < 1e-5, f"bell batched and single-column solves "
                            f"differ by {worst}")
        check(worst_it <= 2, f"bell batched and single-column iteration "
                             f"counts differ by {worst_it}")
        check(single["spmv_bell:sell"] > 0
              and sum(single[k] for k in BELL_COUNTS)
              == single["spmv_bell:sell"],
              f"the single-column solves launched {single}")

    # the sell route at the service's widths on the 1024^2 blocks
    blocks, bcols, index = op.blocks, op.cols, op.index
    a_csr = host_csr_tensor(A, blocks.device)
    x1 = torch.randn(n, device=blocks.device)
    got = spmv_block_ell(blocks, bcols, x1, index=index)
    err1 = max(float((got - spmv_sell_ref(index, blocks, bcols, x1)).abs()
                     .max()),
               float((got - spmv_block_ell_ref(blocks, bcols, x1)).abs()
                     .max()))
    check(err1 < 1e-4, f"spmv_sell (n,) at 1024^2 disagrees with its plain "
                       f"versions: {err1}")
    single = dict(max_abs_err=err1, shape=list(blocks.shape), **bell_times(
        blocks, bcols, index, x1, {"csr": lambda: a_csr @ x1[:, None]}))
    by_nb = []
    for nb in (1, 4, 16):
        xm = torch.randn(n, nb, device=blocks.device)
        got = spmv_block_ell(blocks, bcols, xm, index=index)
        want = spmv_block_ell_multi_ref(blocks, bcols, xm)
        err = max(float((got - spmv_sell_ref(index, blocks, bcols, xm))
                        .abs().max()), float((got - want).abs().max()))
        check(err < 1e-4, f"spmv_sell nb={nb} at 1024^2 disagrees with its "
                          f"plain versions: {err}")
        by_nb.append(dict(
            max_abs_err=err, **bell_times(blocks, bcols, index, xm,
                         {"csr": lambda: a_csr @ xm}),
            single_column_ms_times_nb=nb * event_ms(
                lambda: spmv_block_ell(blocks, bcols, x1, index=index))))
        del want, got
    top = by_nb[-1]
    row = dict(name="spmv_bell_multi:sell", route="cuda",
               source="src/repro_torch/kernels/csrc/spmv_bell.cu",
               replaces="src/repro/kernels/spmv_bell.py:169",
               launches=multi_launches,
               max_abs_err=max(sell_err, *(r["max_abs_err"]
                                           for r in by_nb)),
               **{k: top[k] for k in (
                   "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                   "block_stream_bound_ms", "graph_ms",
                   "nonfinite_pass_ms")},
               nb=16, shape=list(blocks.shape), by_nb=by_nb)
    del svc, op, served, blocks, bcols, index, a_csr, xm, x1
    torch.cuda.empty_cache()

    # ---- dist_hier service: a patch, then a drift trip -------------------
    svc = SolverService(backend="dist_hier", capacity=4, part=part, k=8,
                        pods=topo.pod_assignment(2),
                        drift=DriftPolicy(max_objective_ratio=1.2),
                        repartition=lambda gs: part, **kw)
    r0 = svc.solve(*csr, b)
    dv = EdgeDelta(n, set_rows=[0, 1], set_cols=[1, 0],
                   set_vals=[-0.5, -0.5])
    t0 = time.perf_counter()
    r1 = svc.update_matrix(r0.fingerprint, dv)
    patch_s = time.perf_counter() - t0
    check(r1.patched and not r1.repartitioned and r1.drift is not None
          and not r1.drift.repartition, f"value delta: {r1}")
    ip2, ix2, d2 = apply_delta_csr(*csr, dv)
    hit = svc.solve(ip2, ix2, d2, b)
    fresh = make_operator(ip2, ix2, d2, "dist_hier", part=part, k=8,
                          pods=topo.pod_assignment(2))
    xf = fresh.gather(fresh.solve(b, tol=tol, max_iters=2000).x)
    agree = float(np.abs(hit.x - xf).max() / np.abs(xf).max())
    check(hit.cache_hit, "the patched matrix missed the operator cache")
    check(agree < 1e-5, f"patched and fresh dist_hier solves differ by "
                        f"{agree}")
    del fresh
    # the reference's 30 top-to-bottom insertions, each weighted so that
    # together they add the whole baseline objective at this size (at
    # weight 1 they would move a 1024^2 cut by under 1%)
    base = r1.drift.objective / r1.drift.objective_ratio
    u = np.arange(0, 30, dtype=np.int64)
    v = n - 1 - u
    ds = EdgeDelta(n, set_rows=np.concatenate([u, v]),
                   set_cols=np.concatenate([v, u]),
                   set_vals=np.full(60, -base / 30))
    xs = svc.operator_for(ip2, ix2, d2, r1.fingerprint)[1].scatter(b)
    t0 = time.perf_counter()
    r2 = svc.update_matrix(r1.fingerprint, ds, state=(xs,))
    rebuild_s = time.perf_counter() - t0
    ip3, ix3, d3 = apply_delta_csr(ip2, ix2, d2, ds)
    migrated = svc.operator_for(ip3, ix3, d3, r2.fingerprint)[1].gather(
        r2.state[0])
    s = svc.stats
    emit(phase="solver_service_update", backend="dist_hier_pods2",
         patch_s=patch_s, rebuild_s=rebuild_s, patched_agreement=agree,
         drift_reason=r2.drift.reason,
         objective_ratio=r2.drift.objective_ratio,
         state_exact=bool(np.array_equal(migrated, b)),
         counters=[s.plan_patches, s.plan_rebuilds, s.drift_trips])
    check(r2.drift.repartition and "objective" in r2.drift.reason
          and r2.repartitioned and not r2.patched, f"insertion: {r2}")
    check(np.array_equal(migrated, b), "the migrated state moved")
    check((s.plan_patches, s.plan_rebuilds, s.drift_trips) == (1, 1, 1),
          f"dist_hier service counters {s}")
    del svc, r0, r1, r2, hit
    torch.cuda.empty_cache()
    return row, single


def lm_path(args, dev, gen, emit) -> list[dict]:
    """Phases 6-9: both flash kernels against their plain version, LM
    serving at the full width of qwen1.5-0.5b, stablelm-3b, olmoe-1b-7b
    and granite-moe-1b-a400m, float32 prefill/decode consistency (dense
    and MoE), LDHT expert placement, the flash kernels' numbers.  Returns
    their two rows."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash as flash_mod
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.launch.serve import serve_tokens
    from repro_torch.models.attention import gqa_attend
    from repro_torch.models.mlp import capacity
    from repro_torch.models.transformer import (decode_step, init_model,
                                                prefill_forward)

    cfg = get_config("qwen1.5-0.5b")
    B, S = 8, args.prompt_len
    H, D = cfg.n_heads, cfg.head_dim
    kernels = ("flash", "flash_sm90")

    def routed(dt, d):
        return ("flash_sm90" if dt == torch.bfloat16
                and d in flash_mod.SM90_HEAD_DIMS else "flash")

    def launched():
        n = _build.launches()
        return {name: n[name] for name in kernels}

    # ---- 6. flash against its plain version ------------------------------
    # f32: the reference test's 2e-3 (tests/test_kernels.py); bf16: 8e-3
    # absolute and relative, two bf16 ulps of an output below 1.  Both
    # kernels round P to bf16 before the PV product in bf16 (at most 0.49 of
    # this limit in tests/test_torch_flash.py's emulation); flash in f32
    # computes in 3xTF32 (within 1e-5 of the plain version in that file).
    tols = {torch.float32: 2e-3, torch.bfloat16: 8e-3}
    f32, bf16 = torch.float32, torch.bfloat16
    cfg_sl = get_config("stablelm-3b")
    H_sl, D_sl = cfg_sl.n_heads, cfg_sl.head_dim
    cfg_ol = get_config("olmoe-1b-7b")
    H_ol, D_ol = cfg_ol.n_heads, cfg_ol.head_dim
    cfg_gr = get_config("granite-moe-1b-a400m")
    H_gr, Hkv_gr, D_gr = cfg_gr.n_heads, cfg_gr.n_kv_heads, cfg_gr.head_dim
    cases = [  # (b, h, hkv, sq, sk, d, causal, dtype)
        (2, 4, 4, 256, 256, 64, True, f32),
        (1, 2, 2, 128, 128, 64, True, f32),
        (1, 2, 2, 128, 128, 64, False, f32),
        (1, 2, 2, 384, 384, 64, True, f32),
        (1, 2, 2, 384, 384, 64, False, f32),
        (2, 8, 2, 256, 256, 64, True, f32),
        (1, 4, 4, 256, 256, 16, True, f32),
        (1, 4, 4, 256, 256, 16, False, f32),
        (1, 4, 2, 256, 256, 80, True, f32),
        (1, 4, 2, 256, 256, 80, False, f32),
        (1, 4, 1, 256, 256, 128, False, f32),
        (1, 4, 1, 256, 256, 128, True, f32),
        (1, 4, 2, 128, 384, 80, False, f32),
        (1, 4, 4, 64, 64, 64, True, f32),
        (1, 2, 2, 40, 40, 16, True, f32),
        (1, 4, 4, 256, 256, 16, True, bf16),
        (1, 4, 4, 256, 256, 16, False, bf16),
        (1, 4, 2, 256, 256, 80, True, bf16),
        (1, 4, 2, 256, 256, 80, False, bf16),
        (1, 4, 4, 128, 384, 80, False, bf16),
        (1, 4, 4, 64, 64, 80, True, bf16),
        (1, 2, 2, 96, 96, 80, True, bf16),
        (2, 8, 2, 256, 256, 64, True, bf16),
        (2, 8, 2, 1024, 1024, 128, True, bf16),
        (1, 4, 4, 128, 384, 64, False, bf16),
        (1, 4, 4, 128, 384, 128, False, bf16),
        (1, 4, 4, 64, 64, 64, True, bf16),
        (1, 4, 4, 64, 64, 128, True, bf16),
        (B, H, H, S, S, D, True, bf16),
        # the MoE prefills: olmoe (head dim 128), granite (GQA 16 / 8)
        (B, H_ol, H_ol, S, S, D_ol, True, bf16),
        (B, H_gr, Hkv_gr, S, S, D_gr, True, bf16),
        # stablelm-3b's prefill, flash's bf16 path
        (B, H_sl, H_sl, S, S, D_sl, True, bf16),
        # phase 8's float32 prefills, flash's f32 path
        (4, H, H, S - 128, S - 128, D, True, f32),
        (4, H, H, S, S, D, True, f32)]
    errs = {}
    for case in cases:
        b, h, hkv, sq, sk, d, causal, dt = case
        # (B, S, H, D) buffers seen as (B, H, S, D): the layout gqa_attend
        # hands the kernel
        q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dt)
        k, v = (torch.randn(b, sk, hkv, d, generator=gen, device=dev)
                .to(dt).transpose(1, 2) for _ in range(2))
        q = q.transpose(1, 2)
        tol = tols[dt]
        n0 = launched()
        got = flash_attention(q, k, v, causal=causal)
        n = {name: launched()[name] - n0[name] for name in kernels}
        want = flash_attention_ref(q, k, v, causal=causal)
        ok, err = close(got, want, tol, tol)
        want_kernel = routed(dt, d)
        emit(check="flash", shape=[b, h, sq, d], sk=sk, kv_heads=hkv,
             causal=causal, dtype=str(dt), kernel=want_kernel, launches=n,
             max_abs_err=err, tol=tol,
             limit_share=limit_share(got, want, tol, tol), ok=ok)
        check(n == {name: int(name == want_kernel) for name in kernels},
              f"flash {(b, h, hkv, sq, sk, d, causal, dt)} launched {n}, "
              f"want one {want_kernel}")
        check(ok, f"flash {(b, h, hkv, sq, sk, d, causal, dt)} disagrees "
                  f"with its plain version: {err}")
        errs[case] = err
        del q, k, v, got, want
    torch.cuda.empty_cache()

    # the LM's causal attention at a length that is no tile multiple: one
    # flash launch (on zero-padded tensors), never the plain chunked loop
    for s, dt in ((200, torch.float32), (1000, torch.bfloat16)):
        q, k, v = (torch.randn(2, s, H, D, generator=gen, device=dev).to(dt)
                   for _ in range(3))
        n0 = launched()
        got = gqa_attend(q, k, v)
        n = {name: launched()[name] - n0[name] for name in kernels}
        want = flash_attention_ref(*(t.transpose(1, 2) for t in (q, k, v)))
        ok, err = close(got, want.transpose(1, 2), tols[dt], tols[dt])
        emit(check="flash_ragged", shape=[2, s, H, D], dtype=str(dt),
             launches=n, max_abs_err=err, tol=tols[dt], ok=ok)
        check(sum(n.values()) == 1 and n[routed(dt, D)] == 1,
              f"gqa_attend at S={s} launched {n}")
        check(ok, f"gqa_attend at S={s} {dt} disagrees with the plain "
                  f"attention: {err}")
    torch.cuda.synchronize()

    # ---- 7, 7b. LM serving at full width (the main path) ------------------
    def serve_phase(cfg, kernel):
        """Serve ``cfg`` (batch B, prompt S, 32 generated tokens) after a
        gen=1 warm-up, with the counts reset just before and read just
        after.  The prefill must launch ``kernel`` once per layer and the
        other flash kernel never, the decode loop neither."""
        other = kernels[1 - kernels.index(kernel)]
        # warm-up: cuBLAS handles, and the allocator's cache, which the
        # timed run then reuses (emptying it in between made the prefill
        # time take in cudaMalloc calls)
        serve_tokens(cfg, batch=B, prompt_len=S, gen=1, seed=args.seed,
                     device=dev)
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        r = serve_tokens(cfg, batch=B, prompt_len=S, gen=32,
                         temperature=0.8, seed=args.seed, device=dev)
        serve_s = time.perf_counter() - t0
        path_launches = _build.launches()
        peak = torch.cuda.max_memory_allocated()
        ids = r["tokens"][:, S:]
        finite = bool(torch.isfinite(r["logits"].float()).all())
        moe = {}
        if cfg.family == "moe":
            # the grouped dispatch multiplies every expert each decode
            # step, so a step reads every weight but the embedding rows
            # it does not gather (bf16, ModelConfig.param_count): its
            # floor at the HBM rate
            emb = 0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model
            step_bytes = (cfg.param_count - emb) * 2
            expert_bytes = (cfg.n_layers * cfg.n_experts * 3 * cfg.d_model
                            * cfg.d_expert * 2)
            moe = dict(moe=dict(
                experts=cfg.n_experts, top_k=cfg.top_k,
                capacity_prefill=capacity(S, cfg.n_experts, cfg.top_k,
                                          cfg.moe_capacity),
                capacity_decode=capacity(1, cfg.n_experts, cfg.top_k, 2.0),
                expert_bytes_per_decode_step=expert_bytes,
                weight_bytes_per_decode_step=step_bytes,
                decode_floor_ms=step_bytes / HBM_BYTES_PER_S * 1e3))
        emit(phase="lm_serving", arch=cfg.name, batch=B, prompt_len=S,
             gen=32, prefill_ms=r["prefill_ms"],
             decode_ms_per_token=r["decode_ms_per_token"],
             tok_per_s=r["tok_per_s"], seconds=serve_s,
             launches=path_launches, launches_prefill=r["launches_prefill"],
             launches_decode=r["launches_decode"], finite_logits=finite,
             ids_in_range=bool(((ids >= 0) & (ids < cfg.vocab)).all()),
             max_memory_allocated=peak, sample_ids=ids[0, :8].tolist(),
             **moe)
        check(finite, f"serving {cfg.name}: non-finite logits")
        check(((ids >= 0) & (ids < cfg.vocab)).all(),
              f"serving {cfg.name}: sampled ids outside [0, vocab)")
        pre, dec = r["launches_prefill"], r["launches_decode"]
        check(pre[kernel] == cfg.n_layers and pre[other] == 0,
              f"serving {cfg.name}: the prefill launched {kernel} "
              f"{pre[kernel]} and {other} {pre[other]} times, want "
              f"{cfg.n_layers} and 0")
        check(dec[kernel] == 0 and dec[other] == 0,
              f"serving {cfg.name}: the decode loop launched a flash kernel")
        check(path_launches[kernel] == cfg.n_layers,
              f"the {cfg.name} path launched {kernel} "
              f"{path_launches[kernel]} times")
        out = dict(launches=path_launches[kernel],
                   launches_per_prefill=pre[kernel],
                   launches_per_decode_step=dec[kernel] / r["gen"],
                   max_memory_allocated_serving=peak)
        del r
        torch.cuda.empty_cache()
        return out

    qwen_serving = serve_phase(cfg, "flash_sm90")
    stablelm_serving = serve_phase(cfg_sl, "flash")
    # ---- 7c, 7d. MoE serving at full width and depth ---------------------
    olmoe_serving = serve_phase(cfg_ol, "flash_sm90")
    granite_serving = serve_phase(cfg_gr, "flash_sm90")
    moe_stage_phase(dev, gen, emit, S)

    # ---- 8. float32 consistency: flash prefill vs plain decode ----------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = init_model(cfg32, seed=args.seed, device=dev)
    n_dec = 128
    toks = torch.from_numpy(np.random.default_rng(args.seed + 2).integers(
        0, cfg.vocab, size=(4, S), dtype=np.int32)).to(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    full, _ = prefill_forward(m32, cfg32, toks, cache_len=S)
    logits, cache = prefill_forward(m32, cfg32, toks[:, :S - n_dec],
                                    cache_len=S)
    for t in range(S - n_dec, S):
        logits, cache = decode_step(m32, cfg32, cache, toks[:, t:t + 1], t)
    f32_launches = _build.launches()
    scale = float(full.abs().max())
    rel = float((full - logits).abs().max()) / scale
    emit(phase="lm_consistency_f32", batch=4, prefill=S,
         prefill_then_decode=[S - n_dec, n_dec], max_abs_logit=scale,
         rel_err=rel, tol=1e-3, launches=f32_launches,
         seconds=time.perf_counter() - t0)
    check(rel < 1e-3, f"f32 prefill vs prefill+decode logits differ by "
                      f"{rel} of the largest |logit|")
    check(f32_launches["flash"] == 2 * cfg.n_layers
          and f32_launches["flash_sm90"] == 0,
          f"the f32 prefills launched {f32_launches}, want flash "
          f"{2 * cfg.n_layers} times and flash_sm90 never")
    del m32, cache, full, logits
    torch.cuda.empty_cache()

    # ---- 8b, 7e. granite in float32: consistency, LDHT placement ---------
    moe_f32 = moe_f32_phases(args, dev, emit, S)

    # ---- 9. flash kernels at their paths' shapes: times, bounds ---------
    def flash_times(shape, dt, inner):
        """Times of the kernel that ``flash_attention`` routes ``shape``
        causal in ``dt`` to, its plain version and SDPA, and its bound at
        the peak for ``dt``."""
        b, h, s, d = shape
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev)
                   .to(dt).transpose(1, 2) for _ in range(3))
        nbytes = 4 * q.numel() * q.element_size()     # q, k, v in; o out
        flops = 4 * b * h * d * s * (s + 1) / 2       # QK^T and PV, causal
        bound, by = bound_ms(nbytes, flops, str(dt).split(".")[1])
        return dict(
            max_abs_err=errs[(b, h, h, s, s, d, True, dt)],
            ms=event_ms(lambda: flash_attention(q, k, v), inner=inner),
            plain_ms=event_ms(lambda: flash_attention_ref(q, k, v), reps=5),
            bound_ms=bound, bound_by=by,
            library_ms=event_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), inner=inner),
            shape=list(shape), dtype=str(dt).split(".")[1], causal=True,
            flops=flops, bytes=nbytes)

    def make_row(name, shape, serving):
        return dict(name=name, route="cuda",
                    source="src/repro_torch/kernels/csrc/"
                    + _build.SOURCES[name],
                    replaces="src/repro/kernels/flash.py:74",
                    **flash_times(shape, torch.bfloat16, inner=10), **serving)

    sm90_row = make_row("flash_sm90", (B, H, S, D), qwen_serving)
    # the MoE prefills' shapes, each read on its own path: olmoe's head dim
    # 128 timed; granite's is qwen's shape with 8 KV heads
    sm90_row["olmoe_path"] = dict(
        flash_times((B, H_ol, S, D_ol), torch.bfloat16, inner=10),
        launches_path="lm_serving olmoe-1b-7b", **olmoe_serving)
    sm90_row["granite_path"] = dict(
        shape=[B, H_gr, S, D_gr], kv_heads=Hkv_gr,
        max_abs_err=errs[(B, H_gr, Hkv_gr, S, S, D_gr, True,
                          torch.bfloat16)],
        launches_path="lm_serving granite-moe-1b-a400m", **granite_serving)
    flash_row = make_row("flash", (B, H_sl, S, D_sl), stablelm_serving)
    # flash's float32 path: 3xTF32, three TF32 products per product, so its
    # bound is 3x the flops at the TF32 peak; the CUDA-core bound (the flops
    # at the f32 FMA peak) is kept beside it
    f32_path = flash_times((4, H, S, D), torch.float32, inner=5)
    f32_path.update(
        bound_ms=3 * f32_path["flops"] / PEAK_FLOPS["tf32"] * 1e3,
        bound_by="ops_3xtf32",
        cuda_core_bound_ms=f32_path["flops"] / PEAK_FLOPS["float32"] * 1e3,
        launches=f32_launches["flash"], launches_path="lm_consistency_f32")
    flash_row["f32_path"] = f32_path
    flash_row["moe_f32_path"] = moe_f32
    return [sm90_row, flash_row]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=1024,
                    help="grid side of the main-path mesh (n = side^2)")
    ap.add_argument("--prompt-len", type=int, default=2048,
                    help="LM serving prompt length (more than 128)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    # plain versions must not quietly use TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t_start = time.perf_counter()

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

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = sparse_path(args, dev, gen, emit)
    torch.cuda.empty_cache()
    rows += lm_path(args, dev, gen, emit)

    emit(phase="total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": rows}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
