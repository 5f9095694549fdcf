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
     (olmoe, granite), stablelm-3b's prefill shape, internvl2's (GQA 8:1
     at head dim 128), whisper's encoder and cross attention (non-causal,
     1500 x 1500 and 224 x 1500: no tile multiple) and causal self
     attention (224 padded to 256) in bf16 and at phase 8e's float32
     shapes, a ragged non-causal call at head dim 80, the float32 shapes
     of phases 8 and 8d, and, on every route, non-causal calls whose last
     key tile lies mostly past Sk (each shows that scoring those keys
     would move the output by more than ten times the tolerance); and show
     that the LM's causal attention reaches flash at a length that is not
     a tile multiple (whisper's 224 and 96 among them), and its
     non-causal attention at Sq > 1 with no padding;
  7. LM serving at the full width of qwen1.5-0.5b (random weights from a
     seed): batch 8, prompt 2048, 32 generated tokens through
     ``repro_torch.launch.serve.serve_tokens``; the counts are reset just
     before and read just after, and the prefill must launch flash_sm90
     once per layer and flash never, the decode loop neither; each
     serving line (7 to 7k) carries the bytes a decode step reads
     (weights and caches, ``decode_bytes``) and their floor;
  7b. the same at the full width and depth of stablelm-3b (head dim 80,
     layernorm), the path of flash in bf16: the prefill must launch flash
     once per layer and flash_sm90 never, the decode loop neither;
  7c. MoE serving at the full width and depth of olmoe-1b-7b (64 experts
     top-8, head dim 128), as phase 7: 16 flash_sm90 launches per prefill,
     flash never, the decode loop neither; the dispatch capacities and the
     expert bytes every decode step reads (the grouped dispatch multiplies
     every expert);
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
  7g. serving at the full width and depth of mamba2-130m (24 SSM layers),
     as phase 7: prefill ms, decode ms per token, tok/s, peak memory;
     finite logits, ids in [0, vocab); the model is attention-free, so
     the prefill and the decode loop launch no flash kernel;
  7h. the same for recurrentgemma-2b (18 RG-LRU layers and 8 local-
     attention layers: 10 heads over 1 KV head at head dim 256, window
     2048; the plain windowed path, as the reference's): no flash launch,
     and the decode must run at positions at or past the ring's 2048
     slots (``ring_recorder`` wraps ``transformer.attn_decode``), so the
     ring wraps;
  7i. one SSM layer (mamba2-130m), one RG-LRU layer and one local-
     attention mixer (recurrentgemma-2b) at full width in bf16: the time
     of each stage (projections, conv, SSD or gates and scan, gate and
     norm, out projection; the rec layer's MLP beside them) at the
     prefill and the decode shape;
  8c. both in float32 at full width and depth, batch 4: last-token logits
     of an (S + 512)-token prefill against an (S + 384)-token prefill plus
     128 teacher-forced decode steps, within 1e-3 of the largest |logit|
     (past the window: a true sliding mask and a wrapping ring; the SSM's
     prefills cut different chunks); no flash launch;
  7j. serving internvl2-76b at full width (d 8192, 64 heads over 8 KV at
     128, d_ff 28672, vocab 128,256, untied) and ``VLM_LAYERS`` = 32 of
     its 80 layers (80 take 141 GB in bf16; the line names the cut in
     ``reduced``), as phase 7 with the prompt's first 256 positions
     taken by random image embeddings: 32 flash_sm90 launches per
     prefill, flash never, the decode loop neither;
  7k. the same for whisper-tiny at full size (4 + 4 layers, d 384, 6
     heads at 64, 1,500 random frames, tied), prompt ``WHISPER_PROMPT`` =
     224 (half of whisper's 448-token context): 12 flash_sm90 launches per
     prefill (4 encoder and 4 cross attention, non-causal; 4 causal self
     attention, padded to 256), flash never, the decode loop neither;
  8d, 8e. float32 consistency, batch 4, within 1e-3 of the largest
     |logit|: internvl2 at full width and 2 layers, a 2048-token prefill
     against 1920 + 128 decode steps, the image prefix in both; whisper-
     tiny, 224 against 96 + 128 (the decode's plain cross attention
     against the prefill's flash one); every prefill launches flash once
     per attention call, flash_sm90 never;
  9. each flash kernel at the shapes its paths give it (flash_sm90: qwen's
     prefill in bf16, nested: olmoe's prefill at head dim 128, granite's
     launches, internvl2's prefill with 8 KV heads, whisper's encoder and
     cross attention, non-causal; flash: stablelm-3b's prefill in bf16 and
     phase 8's float32 prefill, nested: 8b's, 8d's and 8e's launches)
     beside its plain version, SDPA with the same mask and heads and its
     bound; peak device memory;
 10a. training at the full width of qwen1.5-0.5b (bf16, batch 8, seq
     2048, ``remat="full"``, the default AdamW, ``SyntheticLM``) through
     ``repro_torch.train.trainer.Trainer`` for ``TRAIN_STEPS`` steps: step
     ms (CUDA events, the median after the first), tokens/s, peak memory,
     loss and grad norm per step, the final checkpoint's seconds and
     bytes; every parameter's gradient finite and nonzero at the first
     step, the last loss below the first;
 10d. (run right after 10a, on its model) ``flash_attention`` refuses under
     grad on both routes (bf16 D 64 -> flash_sm90, f32 -> flash) and runs
     under ``no_grad``; then a prefill of the trained model, whose
     parameters still require grad, through ``make_prefill`` (the serving
     path, under ``no_grad``): 24 flash_sm90 launches, flash never,
     finite logits;
 10b. mamba2-130m at full size (batch 4, seq 256) through a fault and a
     resume: checkpoints every 2 steps under ``build/``, a fault at step
     5, a new Trainer that resumes from step 4 with a state bit-equal to
     the one saved, then finite losses to step 6; save and restore
     seconds and bytes;
 10c. every smoke config in float32: loss (1e-5 relative) and every
     gradient (1e-4 of its leaf's largest |g|) on the card against the CPU
     from the same parameters and batch; no flash launch;
 then the ``{"kernels": [...]}`` line (flash_sm90's row carries 10d's
 launches as ``train_path``);
 11. last line: ``{"ok": true, "device": {...}}``.

Numbers are JSON lines tagged with the card's name and power limit.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import collections
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
VLM_LAYERS = 32                  # 7j: internvl2-76b at 32 of its 80 layers
VLM_F32_LAYERS = 2               # 8d: internvl2-76b in float32
WHISPER_PROMPT = 224             # 7k, 8e: half of whisper's 448 context
KEY_TILE = {                     # keys per tile of each flash route
    ("flash_sm90", "torch.bfloat16"): 128,    # BK, csrc/flash_attn_sm90.cu
    ("flash", "torch.bfloat16"): 64,          # KT, csrc/flash_attn.cu
    ("flash", "torch.float32"): 32,
}


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


@contextlib.contextmanager
def ring_recorder(calls: list):
    """Record ``(pos, ring slots)`` of every windowed decode attention
    call (the hybrid's local attention) while the block runs:
    ``transformer.attn_decode`` is wrapped and runs as before.  A call at
    ``pos >= slots`` writes over the ring's oldest slot.  The wrapper is
    removed on exit."""
    from repro_torch.models import transformer
    fn = transformer.attn_decode

    def wrapper(p, x, cache, pos, **kw):
        if kw.get("window") is not None:
            calls.append((pos, cache[0].shape[1]))
        return fn(p, x, cache, pos, **kw)

    transformer.attn_decode = wrapper
    try:
        yield calls
    finally:
        transformer.attn_decode = fn


def ring_report(calls: list) -> dict:
    """The decode positions and ring sizes seen by :func:`ring_recorder`,
    and whether the ring wrapped (a position at or past its size)."""
    if not calls:
        return dict(calls=0, wrapped=False)
    pos = [c[0] for c in calls]
    slots = sorted({c[1] for c in calls})
    return dict(calls=len(calls), min_pos=min(pos), max_pos=max(pos),
                ring_slots=slots,
                wrapped=any(p >= n for p, n in calls))


def recurrent_stage_phase(dev, gen, emit, S: int) -> None:
    """Phase 7i: one SSM layer of mamba2-130m, one RG-LRU layer and one
    local-attention mixer of recurrentgemma-2b, at full width in bf16
    (random weights and a unit-normal input from ``gen``), at the prefill
    shape (batch 8, S tokens) and the decode shape (batch 8, one token,
    a prefilled cache): the CUDA-event time of each stage and of the
    whole mixer.  SSM stages: projections, conv, SSD (the recurrent step
    in decode), gate and norm, out projection; RG-LRU: projections (with
    the GeLU gate), conv, gates, scan (the one-step update in decode), out
    projection, and the rec layer's MLP beside them."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_config
    from repro_torch.models import attention, mlp, rglru, ssm
    from repro_torch.models.common import ParamInit, causal_conv, conv_step

    bf16 = torch.bfloat16
    B = 8

    def stages(fns: dict) -> dict:
        return {k: event_ms(f) for k, f in fns.items()}

    # ---- SSM (Mamba2 / SSD) ----------------------------------------------
    cfg = get_config("mamba2-130m")
    D, N, hd = cfg.d_model, cfg.ssm_state, cfg.ssm_headdim
    d_in = cfg.ssm_expand * D
    kw = dict(ssm_state=N, headdim=hd, expand=cfg.ssm_expand)
    p = ssm.init_ssm(ParamInit(gen, bf16, dev), D, N, hd, cfg.ssm_expand,
                     cfg.conv_kernel)
    x = torch.randn((B, S, D), generator=gen, device=dev).to(bf16)
    z, xs, Bm, Cm, dt = ssm.split_proj(p, x)
    raw = torch.cat([xs, Bm, Cm], dim=-1)
    xs2, B2, C2 = torch.split(F.silu(causal_conv(raw, p.conv_w, p.conv_b)),
                              [d_in, N, N], dim=-1)
    y, _ = ssm.ssd(p, xs2, B2, C2, dt, headdim=hd)
    g = ssm.gate_norm(p, y, z)
    ms = stages(dict(
        proj=lambda: ssm.split_proj(p, x),
        conv=lambda: F.silu(causal_conv(torch.cat([xs, Bm, Cm], dim=-1),
                                        p.conv_w, p.conv_b)),
        ssd=lambda: ssm.ssd(p, xs2, B2, C2, dt, headdim=hd),
        gate_norm=lambda: ssm.gate_norm(p, y, z),
        out=lambda: g @ p.out_proj,
        ssm_forward=lambda: ssm.ssm_forward(p, x, **kw)))
    c = ssm._chunk(S, 256)
    decay_bytes = B * (d_in // hd) * S * c * 4
    emit(phase="recurrent_stages", arch=cfg.name, mixer="ssm",
         shape="prefill", batch=B, tokens=S, chunk=c, stage_ms=ms,
         stage_sum_ms=sum(v for k, v in ms.items() if k != "ssm_forward"),
         layers=cfg.n_layers, mixer_ms_all_layers=ms["ssm_forward"]
         * cfg.n_layers, decay_matrix_bytes=decay_bytes)
    del z, xs, Bm, Cm, dt, raw, xs2, B2, C2, y, g
    _, cache = ssm.ssm_forward(p, x, return_state=True, **kw)
    x1 = x[:, -1:].contiguous()
    z, xs, Bm, Cm, dt = ssm.split_proj(p, x1[:, 0])
    xbc = torch.cat([xs, Bm, Cm], dim=-1)
    co, _ = conv_step(cache["conv"], xbc, p.conv_w, p.conv_b)
    xs2, B2, C2 = torch.split(F.silu(co), [d_in, N, N], dim=-1)
    y, _ = ssm.ssd_step(p, cache["h"], xs2, B2, C2, dt, headdim=hd)
    g = ssm.gate_norm(p, y, z)
    ms = stages(dict(
        proj=lambda: ssm.split_proj(p, x1[:, 0]),
        conv=lambda: F.silu(conv_step(cache["conv"],
                                      torch.cat([xs, Bm, Cm], dim=-1),
                                      p.conv_w, p.conv_b)[0]),
        state=lambda: ssm.ssd_step(p, cache["h"], xs2, B2, C2, dt,
                                   headdim=hd),
        gate_norm=lambda: ssm.gate_norm(p, y, z),
        out=lambda: g @ p.out_proj,
        ssm_decode=lambda: ssm.ssm_decode(p, x1, cache, **kw)))
    emit(phase="recurrent_stages", arch=cfg.name, mixer="ssm",
         shape="decode", batch=B, tokens=1, stage_ms=ms,
         stage_sum_ms=sum(v for k, v in ms.items() if k != "ssm_decode"),
         layers=cfg.n_layers,
         mixer_ms_all_layers=ms["ssm_decode"] * cfg.n_layers)
    del p, x, x1, cache, z, xs, Bm, Cm, dt, xbc, co, xs2, B2, C2, y, g
    torch.cuda.empty_cache()

    # ---- RG-LRU and the rec layer's MLP ----------------------------------
    cfg = get_config("recurrentgemma-2b")
    D = cfg.d_model
    init = ParamInit(gen, bf16, dev)
    p = rglru.init_rglru(init, D, cfg.conv_kernel)
    ffn = mlp.init_mlp(init, D, cfg.d_ff, cfg.activation)
    x = torch.randn((B, S, D), generator=gen, device=dev).to(bf16)
    gate, xin = rglru.project(p, x)
    u = causal_conv(xin, p.conv_w, p.conv_b)
    la, gx = rglru.gates(p, u)
    h = rglru.linear_scan(la, gx)
    n_rec = sum(k == "rec" for k in cfg.unit) * cfg.n_groups \
        + len(cfg.remainder)
    ms = stages(dict(
        proj=lambda: rglru.project(p, x),
        conv=lambda: causal_conv(xin, p.conv_w, p.conv_b),
        gates=lambda: rglru.gates(p, u),
        scan=lambda: rglru.linear_scan(la, gx),
        out=lambda: rglru.gated_out(p, h, gate),
        rglru_forward=lambda: rglru.rglru_forward(p, x),
        ffn=lambda: mlp.mlp_forward(ffn, x, cfg.activation)))
    emit(phase="recurrent_stages", arch=cfg.name, mixer="rglru",
         shape="prefill", batch=B, tokens=S, stage_ms=ms,
         stage_sum_ms=sum(v for k, v in ms.items()
                          if k not in ("rglru_forward", "ffn")),
         scan_rounds=(S - 1).bit_length(), layers=n_rec,
         mixer_ms_all_layers=ms["rglru_forward"] * n_rec)
    del gate, xin, u, la, gx, h
    _, cache = rglru.rglru_forward(p, x, return_state=True)
    x1 = x[:, -1:].contiguous()
    gate, xin = rglru.project(p, x1[:, 0])
    u, _ = conv_step(cache["conv"], xin, p.conv_w, p.conv_b)
    la, gx = rglru.gates(p, u)
    h = torch.exp(la) * cache["h"] + gx
    ms = stages(dict(
        proj=lambda: rglru.project(p, x1[:, 0]),
        conv=lambda: conv_step(cache["conv"], xin, p.conv_w, p.conv_b),
        gates=lambda: rglru.gates(p, u),
        state=lambda: torch.exp(la) * cache["h"] + gx,
        out=lambda: rglru.gated_out(p, h, gate),
        rglru_decode=lambda: rglru.rglru_decode(p, x1, cache),
        ffn=lambda: mlp.mlp_forward(ffn, x1, cfg.activation)))
    emit(phase="recurrent_stages", arch=cfg.name, mixer="rglru",
         shape="decode", batch=B, tokens=1, stage_ms=ms,
         stage_sum_ms=sum(v for k, v in ms.items()
                          if k not in ("rglru_decode", "ffn")),
         layers=n_rec, mixer_ms_all_layers=ms["rglru_decode"] * n_rec)
    del p, ffn, cache, gate, xin, u, la, gx, h

    # ---- the local attention (window, plain chunked path) ----------------
    akw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
               head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
               window=cfg.window)
    pa = attention.init_attention(init, D, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim, cfg.qkv_bias)
    clen = min(cfg.window, S)
    _, kv = attention.attn_prefill(pa, x, clen, **akw)
    n_attn = cfg.n_groups * cfg.unit.count("attn")
    ms = dict(prefill=event_ms(lambda: attention.attn_prefill(
                  pa, x, clen, **akw), reps=5),
              decode=event_ms(lambda: attention.attn_decode(
                  pa, x1, kv, S, **akw)))
    emit(phase="recurrent_stages", arch=cfg.name, mixer="local_attention",
         batch=B, tokens=S, window=cfg.window, ring_slots=clen,
         head_dim=cfg.head_dim, stage_ms=ms, layers=n_attn,
         prefill_ms_all_layers=ms["prefill"] * n_attn,
         decode_ms_all_layers=ms["decode"] * n_attn)
    del pa, kv, x, x1
    torch.cuda.empty_cache()


def recurrent_f32_phase(args, dev, emit, S: int) -> dict:
    """Phase 8c: mamba2-130m and recurrentgemma-2b in float32 at full
    width and depth, batch 4: the last-token logits of an (S + 512)-token
    prefill against an (S + 384)-token prefill plus 128 teacher-forced
    decode steps, within 1e-3 of the largest |logit|.  Past the window of
    2048 the hybrid's prefill runs a true sliding mask and its decode
    wraps the ring; the SSM's two prefills cut different chunks (256 and
    152 at S = 2048).  Neither path may launch a flash kernel.  Returns
    the errors by arch."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.ssm import _chunk
    from repro_torch.models.transformer import (decode_step, init_model,
                                                prefill_forward)

    n, n_dec = S + 512, 128
    out = {}
    for arch in ("mamba2-130m", "recurrentgemma-2b"):
        cfg = get_config(arch)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model = init_model(cfg32, seed=args.seed, device=dev)
        toks = torch.from_numpy(np.random.default_rng(args.seed + 2)
                                .integers(0, cfg.vocab, size=(4, n),
                                          dtype=np.int32)).to(dev)
        ring = []
        _build.reset_launches()
        t0 = time.perf_counter()
        full, _ = prefill_forward(model, cfg32, toks, cache_len=n)
        with ring_recorder(ring):
            logits, cache = prefill_forward(model, cfg32,
                                            toks[:, :n - n_dec], cache_len=n)
            for t in range(n - n_dec, n):
                logits, cache = decode_step(model, cfg32, cache,
                                            toks[:, t:t + 1], t)
        torch.cuda.synchronize()
        launches = _build.launches()
        seconds = time.perf_counter() - t0
        scale = float(full.abs().max())
        rel = float((full - logits).abs().max()) / scale
        rep = ring_report(ring)
        extra = (dict(ring=rep) if cfg.family == "hybrid" else
                 dict(chunks=[_chunk(n, 256), _chunk(n - n_dec, 256)]))
        emit(phase="recurrent_consistency_f32", arch=cfg.name, batch=4,
             prefill=n, prefill_then_decode=[n - n_dec, n_dec],
             max_abs_logit=scale, rel_err=rel, tol=1e-3,
             launches={k: launches[k] for k in ("flash", "flash_sm90")},
             seconds=seconds, **extra)
        del model, cache, full, logits
        torch.cuda.empty_cache()
        check(rel < 1e-3, f"{cfg.name} f32 prefill vs prefill+decode "
                          f"logits differ by {rel} of the largest |logit|")
        check(launches["flash"] == 0 and launches["flash_sm90"] == 0,
              f"the {cfg.name} f32 paths launched {launches}, want no "
              f"flash kernel")
        if cfg.family == "hybrid":
            check(rep["wrapped"], f"{cfg.name}: the f32 decode never "
                                  f"wrapped the ring: {rep}")
        out[cfg.name] = rel
    return out


def vlm_audio_f32_phase(args, dev, emit, S: int) -> dict:
    """Phases 8d and 8e in float32, batch 4, the last-token logits of a
    whole prefill against a shorter prefill plus 128 teacher-forced decode
    steps, within 1e-3 of the largest |logit|: internvl2-76b at full width
    and ``VLM_F32_LAYERS`` layers, prompt S whose first 256 positions are
    the image embeddings in both prefills; whisper-tiny at full size,
    prompt ``WHISPER_PROMPT`` (the decode's plain cross attention against
    the prefill's flash one).  Every prefill launches ``flash`` (the f32
    route) once per attention call, ``flash_sm90`` never, the decode
    none.  Returns each check's error and launches."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.models.steps import (make_decode_step, make_prefill,
                                          model_module)

    n_dec, out = 128, {}
    rng = np.random.default_rng(args.seed + 3)
    for phase, cfg, n in (
            ("vlm_consistency_f32", dataclasses.replace(
                get_config("internvl2-76b"), n_layers=VLM_F32_LAYERS,
                dtype="float32"), S),
            ("audio_consistency_f32", dataclasses.replace(
                get_config("whisper-tiny"), dtype="float32"),
             WHISPER_PROMPT)):
        model = model_module(cfg).init_model(cfg, seed=args.seed, device=dev)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab, size=(4, n), dtype=np.int32)).to(dev)
        stub = stub_inputs(cfg, rng, 4, dev)      # image prefix or frames
        prefill = make_prefill(cfg, cache_len=n)
        decode = make_decode_step(cfg)
        calls = flash_calls(cfg)
        _build.reset_launches()
        t0 = time.perf_counter()
        full, _ = prefill(model, {"tokens": toks, **stub})
        logits, cache = prefill(model, {"tokens": toks[:, :n - n_dec],
                                        **stub})
        for t in range(n - n_dec, n):
            logits, cache = decode(model, cache, toks[:, t:t + 1], t)
        torch.cuda.synchronize()
        launches = {k: _build.launches()[k] for k in ("flash", "flash_sm90")}
        seconds = time.perf_counter() - t0
        scale = float(full.abs().max())
        rel = float((full - logits).abs().max()) / scale
        emit(phase=phase, arch=cfg.name, layers=[cfg.enc_layers,
                                                 cfg.n_layers],
             batch=4, prefill=n, prefill_then_decode=[n - n_dec, n_dec],
             max_abs_logit=scale, rel_err=rel, tol=1e-3, launches=launches,
             seconds=seconds)
        del model, cache, full, logits, stub
        torch.cuda.empty_cache()
        check(rel < 1e-3, f"{cfg.name} f32 prefill vs prefill+decode "
                          f"logits differ by {rel} of the largest |logit|")
        check(launches == {"flash": 2 * calls, "flash_sm90": 0},
              f"the {cfg.name} f32 paths launched {launches}, want flash "
              f"{2 * calls} times and flash_sm90 never")
        out[cfg.name] = dict(rel_err=rel, launches=launches["flash"],
                             launches_path=phase)
    return out


def flash_calls(cfg) -> int:
    """Flash launches of one bf16 or f32 prefill: one per attention layer;
    the audio family's encoder layers, and its decoder's self and cross
    attention, each one."""
    if cfg.family == "audio":
        return cfg.enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def decode_bytes(cfg, batch: int, cache_len: int) -> dict:
    """What one bf16 decode step must read, and its floor at the HBM rate:
    every weight it multiplies, counted on a model built on the meta
    device (the MoE's grouped dispatch multiplies every expert; the head
    is the tied embedding or the untied ``lm_head``, and an untied
    embedding's rows but the few gathered are not read; nor are the audio
    encoder and the decoder's position table), and its caches, counted on
    a cache built there too: attention k and v over ``cache_len`` slots
    (the hybrid's ring over its window), the recurrent states, the audio
    decoder's cross k and v over ``n_frames``."""
    import torch
    from repro_torch.models.common import ParamInit
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.transformer import LM, init_cache

    meta = torch.device("meta")
    init = ParamInit(None, torch.bfloat16, meta)
    if cfg.family == "audio":
        model = EncDec(cfg, init)
        weights = sum(p.numel() for p in model.dec.parameters()) \
            + sum(p.numel() for p in model.norm_dec.parameters()) \
            + model.embed.numel()                     # the tied head
        cache_bytes = 2 * 2 * cfg.n_layers * batch \
            * (cache_len + cfg.n_frames) * cfg.n_kv_heads * cfg.head_dim
    else:
        model = LM(cfg, init)
        weights = sum(p.numel() for p in model.parameters()) \
            - (0 if cfg.tie_embeddings else model.embed.numel())

        def leaves(c):
            if isinstance(c, torch.Tensor):
                return [c]
            return [t for x in (c.values() if isinstance(c, dict) else c)
                    for t in leaves(x)]
        cache_bytes = sum(t.numel() * t.element_size()
                          for t in leaves(init_cache(cfg, batch, cache_len,
                                                     device=meta)))
    weight_bytes = 2 * weights
    return dict(weight_bytes_per_step=weight_bytes,
                cache_bytes_per_step=cache_bytes,
                floor_ms=(weight_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3)


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
    serving at the full width of qwen1.5-0.5b, stablelm-3b, olmoe-1b-7b,
    granite-moe-1b-a400m, mamba2-130m, recurrentgemma-2b, internvl2-76b
    (32 layers) and whisper-tiny, float32 prefill/decode consistency,
    LDHT expert placement, the flash kernels' numbers.  Returns their two
    rows."""
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
                                                layer_kinds, prefill_forward)

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
    cfg_iv = dataclasses.replace(get_config("internvl2-76b"),
                                 n_layers=VLM_LAYERS)
    H_iv, Hkv_iv, D_iv = cfg_iv.n_heads, cfg_iv.n_kv_heads, cfg_iv.head_dim
    cfg_wh = get_config("whisper-tiny")
    H_wh, D_wh, T_wh = cfg_wh.n_heads, cfg_wh.head_dim, cfg_wh.n_frames
    S_wh = WHISPER_PROMPT
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
        # internvl2's prefill (GQA 8:1 at head dim 128); whisper's encoder
        # and cross attention, non-causal at lengths off the tile, and its
        # causal self attention (224, padded to 256); a ragged non-causal
        # call through flash's bf16 path
        (B, H_iv, Hkv_iv, S, S, D_iv, True, bf16),
        (B, H_wh, H_wh, T_wh, T_wh, D_wh, False, bf16),
        (B, H_wh, H_wh, S_wh, T_wh, D_wh, False, bf16),
        (B, H_wh, H_wh, 256, 256, D_wh, True, bf16),
        (2, 4, 2, 300, 1000, 80, False, bf16),
        # phase 8d's float32 prefills (GQA 8:1 at head dim 128)
        (4, H_iv, Hkv_iv, S, S, D_iv, True, f32),
        (4, H_iv, Hkv_iv, S - 128, S - 128, D_iv, True, f32),
        # phase 8e's float32 encoder, cross attention and causal self
        # attention (224 padded to 256; 96)
        (4, H_wh, H_wh, T_wh, T_wh, D_wh, False, f32),
        (4, H_wh, H_wh, S_wh, T_wh, D_wh, False, f32),
        (4, H_wh, H_wh, 256, 256, D_wh, True, f32),
        (4, H_wh, H_wh, S_wh - 128, S_wh - 128, D_wh, True, f32),
        # phase 8's float32 prefills, flash's f32 path
        (4, H, H, S - 128, S - 128, D, True, f32),
        (4, H, H, S, S, D, True, f32)]
    # non-causal calls whose last key tile lies mostly past Sk (Sk one or
    # twelve keys into a tile of every route, Sq off the tile): a kernel
    # that scored the zero-filled keys past Sk would move every output by
    # tens of percent (``unmasked_err`` below), far past the tolerance
    tail_cases = [
        (2, 4, 2, 100, 129, 64, False, bf16),
        (2, 4, 2, 100, 140, 128, False, bf16),
        (2, 4, 2, 100, 129, 80, False, bf16),
        (2, 4, 2, 100, 129, 64, False, f32)]
    errs = {}
    for case in cases + tail_cases:
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
        extra = {}
        if case in tail_cases:
            # the plain version with the keys past Sk zero-filled to the
            # route's key tile and left unmasked
            pad = -sk % KEY_TILE[want_kernel, str(dt)]
            unmasked = flash_attention_ref(
                q, *(F.pad(t, (0, 0, 0, pad)) for t in (k, v)),
                causal=False)
            extra = dict(key_tile=KEY_TILE[want_kernel, str(dt)],
                         unmasked_err=float((unmasked.float()
                                             - want.float()).abs().max()))
            check(extra["unmasked_err"] > 10 * tol,
                  f"flash {case}: an unmasked key tail would move the "
                  f"output by only {extra['unmasked_err']}")
        emit(check="flash", shape=[b, h, sq, d], sk=sk, kv_heads=hkv,
             causal=causal, dtype=str(dt), kernel=want_kernel, launches=n,
             max_abs_err=err, tol=tol,
             limit_share=limit_share(got, want, tol, tol), ok=ok, **extra)
        check(n == {name: int(name == want_kernel) for name in kernels},
              f"flash {(b, h, hkv, sq, sk, d, causal, dt)} launched {n}, "
              f"want one {want_kernel}")
        check(ok, f"flash {(b, h, hkv, sq, sk, d, causal, dt)} disagrees "
                  f"with its plain version: {err}")
        errs[case] = err
        del q, k, v, got, want
    torch.cuda.empty_cache()

    # the LM's causal attention at a length that is no tile multiple: one
    # flash launch (on zero-padded tensors), never the plain chunked loop;
    # with whisper's causal self attention as its paths make it (7k at
    # 224 in bf16, 8e at 224 and 96 in f32)
    for b, s, h, d, dt in ((2, 200, H, D, f32), (2, 1000, H, D, bf16),
                           (B, S_wh, H_wh, D_wh, bf16),
                           (4, S_wh, H_wh, D_wh, f32),
                           (4, S_wh - 128, H_wh, D_wh, f32)):
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev).to(dt)
                   for _ in range(3))
        n0 = launched()
        got = gqa_attend(q, k, v)
        n = {name: launched()[name] - n0[name] for name in kernels}
        want = flash_attention_ref(*(t.transpose(1, 2) for t in (q, k, v)))
        ok, err = close(got, want.transpose(1, 2), tols[dt], tols[dt])
        emit(check="flash_ragged", shape=[b, s, h, d], dtype=str(dt),
             launches=n, max_abs_err=err, tol=tols[dt], ok=ok)
        check(sum(n.values()) == 1 and n[routed(dt, d)] == 1,
              f"gqa_attend at S={s} launched {n}")
        check(ok, f"gqa_attend at S={s} {dt} disagrees with the plain "
                  f"attention: {err}")
    # its non-causal attention at Sq > 1 (whisper's cross attention, as
    # the decoder hands it over): one flash launch, no padding
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn(2, S_wh, H_wh, D_wh, generator=gen, device=dev).to(dt)
        k, v = (torch.randn(2, T_wh, H_wh, D_wh, generator=gen, device=dev)
                .to(dt) for _ in range(2))
        n0 = launched()
        got = gqa_attend(q, k, v, causal=False)
        n = {name: launched()[name] - n0[name] for name in kernels}
        want = flash_attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                                   causal=False)
        ok, err = close(got, want.transpose(1, 2), tols[dt], tols[dt])
        emit(check="flash_non_causal", shape=[2, S_wh, H_wh, D_wh], sk=T_wh,
             dtype=str(dt), launches=n, max_abs_err=err, tol=tols[dt],
             ok=ok)
        check(sum(n.values()) == 1 and n[routed(dt, D_wh)] == 1,
              f"non-causal gqa_attend at {S_wh} x {T_wh} launched {n}")
        check(ok, f"non-causal gqa_attend at {S_wh} x {T_wh} {dt} "
                  f"disagrees with the plain attention: {err}")
    torch.cuda.synchronize()

    # ---- 7, 7b. LM serving at full width (the main path) ------------------
    def serve_phase(cfg, kernel, prompt_len=S, reduced=None):
        """Serve ``cfg`` (batch B, ``prompt_len``, 32 generated tokens)
        after a gen=1 warm-up, with the counts reset just before and read
        just after.  The prefill must launch ``kernel`` once per attention
        call (``flash_calls``) and the other flash kernel never, the
        decode loop neither; with ``kernel`` None (the SSM and hybrid
        families) no flash kernel may launch, and the hybrid's decode must
        wrap its local attention's ring.  ``reduced`` names the cuts of a
        config that does not fit the card whole."""
        S = prompt_len
        other = kernels[1 - kernels.index(kernel)] if kernel else None
        # warm-up: cuBLAS handles, and the allocator's cache, which the
        # timed run then reuses (emptying it in between made the prefill
        # time take in cudaMalloc calls)
        serve_tokens(cfg, batch=B, prompt_len=S, gen=1, seed=args.seed,
                     device=dev)
        torch.cuda.reset_peak_memory_stats()
        ring = []
        recorder = (ring_recorder(ring) if cfg.family == "hybrid"
                    else contextlib.nullcontext())
        _build.reset_launches()
        t0 = time.perf_counter()
        with recorder:
            r = serve_tokens(cfg, batch=B, prompt_len=S, gen=32,
                             temperature=0.8, seed=args.seed, device=dev)
        serve_s = time.perf_counter() - t0
        path_launches = _build.launches()
        peak = torch.cuda.max_memory_allocated()
        ids = r["tokens"][:, S:]
        finite = bool(torch.isfinite(r["logits"].float()).all())
        # the weights and caches a decode step reads, and their floor
        extra = dict(family=cfg.family, decode=decode_bytes(cfg, B, S + 32))
        if cfg.family == "moe":
            extra["moe"] = dict(
                experts=cfg.n_experts, top_k=cfg.top_k,
                capacity_prefill=capacity(S, cfg.n_experts, cfg.top_k,
                                          cfg.moe_capacity),
                capacity_decode=capacity(1, cfg.n_experts, cfg.top_k, 2.0),
                expert_bytes_per_decode_step=cfg.n_layers * cfg.n_experts
                * 3 * cfg.d_model * cfg.d_expert * 2)
        if kernel is None:
            extra["recurrent"] = dict(
                layer_kinds=dict(collections.Counter(layer_kinds(cfg))),
                ring=ring_report(ring))
        if reduced:
            extra["reduced"] = reduced
        emit(phase="lm_serving", arch=cfg.name, batch=B, prompt_len=S,
             gen=32, prefill_ms=r["prefill_ms"],
             decode_ms_per_token=r["decode_ms_per_token"],
             tok_per_s=r["tok_per_s"], seconds=serve_s,
             launches=path_launches, launches_prefill=r["launches_prefill"],
             launches_decode=r["launches_decode"], finite_logits=finite,
             ids_in_range=bool(((ids >= 0) & (ids < cfg.vocab)).all()),
             max_memory_allocated=peak, sample_ids=ids[0, :8].tolist(),
             **extra)
        check(finite, f"serving {cfg.name}: non-finite logits")
        check(((ids >= 0) & (ids < cfg.vocab)).all(),
              f"serving {cfg.name}: sampled ids outside [0, vocab)")
        pre, dec = r["launches_prefill"], r["launches_decode"]
        if kernel is None:
            check(not any(path_launches[k] for k in kernels),
                  f"serving {cfg.name} launched {path_launches}, want no "
                  f"flash kernel")
            check(cfg.family != "hybrid" or extra["recurrent"]["ring"][
                "wrapped"], f"serving {cfg.name}: the decode never "
                f"wrapped the ring: {extra['recurrent']['ring']}")
            del r
            torch.cuda.empty_cache()
            return dict(max_memory_allocated_serving=peak)
        calls = flash_calls(cfg)
        check(pre[kernel] == calls and pre[other] == 0,
              f"serving {cfg.name}: the prefill launched {kernel} "
              f"{pre[kernel]} and {other} {pre[other]} times, want "
              f"{calls} and 0")
        check(dec[kernel] == 0 and dec[other] == 0,
              f"serving {cfg.name}: the decode loop launched a flash kernel")
        check(path_launches[kernel] == calls,
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

    # ---- 7g, 7h, 7i, 8c. the recurrent families: no flash kernel ---------
    t0 = time.perf_counter()
    serve_phase(get_config("mamba2-130m"), None)
    serve_phase(get_config("recurrentgemma-2b"), None)
    recurrent_stage_phase(dev, gen, emit, S)
    recurrent_f32_phase(args, dev, emit, S)
    emit(phase="recurrent_phases", seconds=time.perf_counter() - t0)

    # ---- 7j, 7k, 8d, 8e. the VLM and audio families: flash_sm90 ----------
    t0 = time.perf_counter()
    internvl_serving = serve_phase(
        cfg_iv, "flash_sm90", reduced={"n_layers": [VLM_LAYERS, 80]})
    whisper_serving = serve_phase(cfg_wh, "flash_sm90", prompt_len=S_wh)
    vlm_audio_f32 = vlm_audio_f32_phase(args, dev, emit, S)
    emit(phase="vlm_audio_phases", seconds=time.perf_counter() - t0)

    # ---- 9. flash kernels at their paths' shapes: times, bounds ---------
    def flash_times(shape, dt, inner, causal=True, kv_heads=None,
                    sk=None):
        """Times of the kernel that ``flash_attention`` routes ``shape``
        (b, h, sq, d) in ``dt`` to (``kv_heads`` and ``sk`` default to h
        and sq), its plain version and SDPA with the same mask and heads,
        and its bound at the peak for ``dt``."""
        b, h, s, d = shape
        hkv, sk = kv_heads or h, sk or s
        q = torch.randn(b, s, h, d, generator=gen, device=dev).to(dt)
        k, v = (torch.randn(b, sk, hkv, d, generator=gen, device=dev)
                .to(dt).transpose(1, 2) for _ in range(2))
        q = q.transpose(1, 2)
        # q, k, v in; o out
        nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
        # QK^T and PV over the keys each query sees
        flops = 4 * b * h * d * (s * (s + 1) / 2 if causal else s * sk)
        bound, by = bound_ms(nbytes, flops, str(dt).split(".")[1])
        return dict(
            max_abs_err=errs[(b, h, hkv, s, sk, d, causal, dt)],
            ms=event_ms(lambda: flash_attention(q, k, v, causal=causal),
                        inner=inner),
            plain_ms=event_ms(lambda: flash_attention_ref(
                q, k, v, causal=causal), reps=5),
            bound_ms=bound, bound_by=by,
            library_ms=event_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=hkv != h),
                inner=inner),
            shape=list(shape), kv_heads=hkv, sk=sk,
            dtype=str(dt).split(".")[1], causal=causal, flops=flops,
            bytes=nbytes)

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
    # internvl2's prefill (GQA 8:1, head dim 128) and whisper's two
    # non-causal calls, each read on its own path (whisper's 12 launches a
    # prefill: 4 encoder, 4 causal self attention at 256 after padding,
    # 4 cross attention)
    sm90_row["internvl_path"] = dict(
        flash_times((B, H_iv, S, D_iv), torch.bfloat16, inner=10,
                    kv_heads=Hkv_iv),
        launches_path=f"lm_serving {cfg_iv.name}", **internvl_serving)
    sm90_row["whisper_path"] = dict(
        encoder=flash_times((B, H_wh, T_wh, D_wh), torch.bfloat16,
                            inner=10, causal=False),
        cross=flash_times((B, H_wh, S_wh, D_wh), torch.bfloat16, inner=10,
                          causal=False, sk=T_wh),
        launches_path=f"lm_serving {cfg_wh.name}", **whisper_serving)
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
    flash_row["vlm_audio_f32_paths"] = vlm_audio_f32
    return [sm90_row, flash_row]


# ---- 10. training ----------------------------------------------------------

TRAIN_STEPS = 8                  # 10a: qwen1.5-0.5b train steps
TRAIN_BATCH, TRAIN_SEQ = 8, 2048  # 10a: 16,384 tokens a step
RESUME_STEPS, RESUME_FAULT = 6, 5  # 10b: mamba2-130m, checkpoints every 2


@contextlib.contextmanager
def grad_recorder(seen: list):
    """Wrap ``models.steps.adamw_update`` for the call: the first train
    step's gradients reach it, and it records, per parameter, whether the
    gradient is finite and whether it has a nonzero entry (one host read;
    later steps pass through untouched)."""
    import torch
    from repro_torch.models import steps
    real = steps.adamw_update

    def wrapped(cfg, params, grads, state):
        if not seen:
            flags = torch.stack([torch.stack([torch.isfinite(g).all(),
                                              (g != 0).any()])
                                 for g in grads.values()]).cpu()
            seen.append({n: (bool(f[0]), bool(f[1]))
                         for n, f in zip(grads, flags)})
        return real(cfg, params, grads, state)

    steps.adamw_update = wrapped
    try:
        yield seen
    finally:
        steps.adamw_update = real


@contextlib.contextmanager
def save_clock(saves: list):
    """Wrap the trainer's ``save_checkpoint`` for the call: the seconds and
    bytes of each save."""
    from repro_torch.train import trainer
    real = trainer.save_checkpoint

    def wrapped(*a, **k):
        t0 = time.perf_counter()
        path = real(*a, **k)
        saves.append(dict(step=a[2], seconds=time.perf_counter() - t0,
                          bytes=(path / "state.npz").stat().st_size))
        return path

    trainer.save_checkpoint = wrapped
    try:
        yield saves
    finally:
        trainer.save_checkpoint = real


def train_path(args, dev, emit) -> dict:
    """Phase 10: training on the card through ``train.trainer.Trainer``.
    10a qwen1.5-0.5b at full width (bf16, ``TRAIN_BATCH`` x ``TRAIN_SEQ``,
    ``TRAIN_STEPS`` steps, ``remat="full"``, the default AdamW on
    ``SyntheticLM``); 10d right after it, on its trained model: flash
    refuses under grad on both routes, then a prefill under the serving
    path launches ``flash_sm90`` once per layer and ``flash`` never; 10b
    mamba2-130m (batch 4, seq 256) through a fault and a resume from its
    checkpoints; 10c each smoke config's loss and gradients in float32 on
    the card against the CPU from the same parameters.  Returns 10d's
    launches for the kernels line."""
    import copy
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS, get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.models.steps import (loss_and_grads, make_prefill,
                                          model_module)
    from repro_torch.train.checkpoint import flatten_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    kernels = ("flash", "flash_sm90")
    ckpt_root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckpt_root, ignore_errors=True)

    # ---- 10a. qwen1.5-0.5b at full width --------------------------------
    t_phase = time.perf_counter()
    cfg = get_config("qwen1.5-0.5b")
    tcfg = TrainerConfig(steps=TRAIN_STEPS, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, ckpt_every=TRAIN_STEPS,
                         ckpt_dir=str(ckpt_root / "qwen"),
                         log_every=TRAIN_STEPS + 1, seed=args.seed)
    tr = Trainer(cfg, tcfg, device=dev)
    step_ms, metrics = [], []

    def timed(step_fn):
        def run(state, batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step_fn(state, batch)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            return out
        return run

    tr.train_step = timed(tr.train_step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seen, saves = [], []
    t0 = time.perf_counter()
    with grad_recorder(seen), save_clock(saves):
        losses = tr.run(on_metrics=lambda step, m: metrics.append(
            dict(step=step, loss=float(m["loss"]),
                 grad_norm=float(m["grad_norm"]), lr=float(m["lr"]))))
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(step_ms[1:])
    first = seen[0]
    bad = sorted(n for n, (fin, nz) in first.items() if not (fin and nz))
    n_params = sum(p.numel() for p in tr.state["params"].parameters())
    emit(phase="train", arch=cfg.name, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         tokens_per_step=TRAIN_BATCH * TRAIN_SEQ, steps=TRAIN_STEPS,
         remat=cfg.remat, dtype=cfg.dtype, params=n_params,
         step_ms=steady, first_step_ms=step_ms[0], step_ms_all=step_ms,
         host_step_s=tr.step_times,
         tok_per_s=TRAIN_BATCH * TRAIN_SEQ / (steady / 1e3),
         max_memory_allocated=peak, per_step=metrics,
         params_with_grad=len(first), params_bad_grad=bad,
         checkpoint=saves[-1], run_seconds=run_s,
         shares=tr.shares.tolist())
    check(not bad and len(first) == len(list(
        tr.state["params"].parameters())),
        f"train {cfg.name}: parameters without a finite nonzero gradient "
        f"after the first step: {bad[:8]}")
    check(all(np.isfinite(losses)), f"train {cfg.name}: loss {losses}")
    check(losses[-1] < losses[0], f"train {cfg.name}: the loss did not "
                                  f"fall: {losses}")
    shutil.rmtree(ckpt_root / "qwen", ignore_errors=True)

    # ---- 10d. flash refuses under grad; serving the trained model --------
    refusals = {}
    for dt, route in ((torch.bfloat16, "flash_sm90"),
                      (torch.float32, "flash")):
        q, k, v = (torch.randn(2, 4, 256, 64, device=dev, dtype=dt)
                   for _ in range(3))
        q.requires_grad_(True)
        _build.reset_launches()
        try:
            flash_attention(q, k, v)
            refused = False
        except RuntimeError as e:
            refused = "no backward" in str(e)
        n = {name: _build.launches()[name] for name in kernels}
        with torch.no_grad():
            out = flash_attention(q, k, v)
        ran = {name: _build.launches()[name] - n[name] for name in kernels}
        refusals[route] = dict(refused=refused, launches_refused=n,
                               launches_no_grad=ran,
                               finite=bool(torch.isfinite(out.float()).all()))
        check(refused and not any(n.values()),
              f"flash_attention under grad ({dt}) did not refuse: {n}")
        check(ran == {name: int(name == route) for name in kernels},
              f"flash_attention under no_grad ({dt}) launched {ran}, "
              f"want one {route}")
    model = tr.state["params"]
    del tr
    toks = torch.from_numpy(np.random.default_rng(args.seed + 5).integers(
        0, cfg.vocab, size=(TRAIN_BATCH, TRAIN_SEQ), dtype=np.int32)).to(dev)
    prefill = make_prefill(cfg, cache_len=TRAIN_SEQ)
    prefill(model, {"tokens": toks})                 # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    logits, cache = prefill(model, {"tokens": toks})
    end.record()
    end.synchronize()
    serve_launches = {name: _build.launches()[name] for name in kernels}
    finite = bool(torch.isfinite(logits.float()).all())
    trainable = all(p.requires_grad for p in model.parameters())
    emit(phase="train_then_serve", arch=cfg.name, refusals=refusals,
         prefill_batch=TRAIN_BATCH, prompt_len=TRAIN_SEQ,
         prefill_ms=start.elapsed_time(end), launches=serve_launches,
         finite_logits=finite, params_require_grad=trainable,
         logits_require_grad=logits.requires_grad)
    check(serve_launches == {"flash": 0, "flash_sm90": cfg.n_layers},
          f"the trained {cfg.name}'s prefill launched {serve_launches}, want "
          f"flash_sm90 {cfg.n_layers} times and flash never")
    check(finite and trainable and not logits.requires_grad,
          f"the trained {cfg.name}'s prefill: finite {finite}, "
          f"parameters trainable {trainable}")
    del model, logits, cache
    torch.cuda.empty_cache()

    # ---- 10b. mamba2-130m: a fault, then a resume ------------------------
    cfg_m = get_config("mamba2-130m")
    kw = dict(steps=RESUME_STEPS, seq_len=256, global_batch=4, ckpt_every=2,
              ckpt_dir=str(ckpt_root / "mamba2"), log_every=RESUME_STEPS + 1,
              seed=args.seed)
    tr = Trainer(cfg_m, TrainerConfig(**kw, fail_at_step=RESUME_FAULT),
                 device=dev)
    snap, saves = {}, []

    def snapshot(step, m):
        if step == RESUME_FAULT - 1:   # the state the last save writes
            snap.update({k: t.detach().clone() for k, t in
                         flatten_state(tr.state).items()})

    t0 = time.perf_counter()
    fault = None
    with save_clock(saves):
        try:
            first_losses = tr.run(on_metrics=snapshot)
        except RuntimeError as e:
            fault = str(e)
    first_s = time.perf_counter() - t0
    del tr
    tr = Trainer(cfg_m, TrainerConfig(**kw), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed = tr.maybe_resume()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = flatten_state(tr.state)
    diff = sorted(k for k, t in snap.items()
                  if k not in got or got[k].dtype != t.dtype
                  or not torch.equal(got[k], t))
    resumed_at = tr.step
    with save_clock(saves):
        losses = tr.run()
    emit(phase="train_resume", arch=cfg_m.name, batch=4, seq=256,
         steps=RESUME_STEPS, fault=fault, resumed=resumed,
         resumed_at=resumed_at, restored_keys=len(got),
         restored_not_equal=diff, saves=saves, restore_seconds=restore_s,
         first_run_seconds=first_s, resumed_losses=losses,
         bytes=saves[-1]["bytes"])
    check(fault is not None and "injected fault" in fault,
          f"train_resume: the first run did not fault ({fault})")
    check(resumed and resumed_at == RESUME_FAULT - 1,
          f"train_resume: resumed {resumed} at step {resumed_at}")
    check(len(snap) == len(got) and not diff,
          f"train_resume: restored state differs from the saved one: "
          f"{diff[:8]}")
    check(len(losses) == RESUME_STEPS - resumed_at
          and all(np.isfinite(losses)),
          f"train_resume: resumed losses {losses}")
    del tr, snap, got
    shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 10c. float32 gradients, card against CPU -------------------------
    rng = np.random.default_rng(args.seed + 6)
    worst = {}
    for arch in ARCHS:
        cfg_s = get_config(arch, smoke=True)
        cpu = model_module(cfg_s).init_model(cfg_s, seed=args.seed,
                                             device="cpu")
        cpu.requires_grad_(True)
        card = copy.deepcopy(cpu).to(dev)
        B, S = 2, 32
        batch = {"tokens": rng.integers(0, cfg_s.vocab, (B, S)).astype(
                     np.int32),
                 "labels": rng.integers(0, cfg_s.vocab, (B, S)).astype(
                     np.int32)}
        if cfg_s.family == "vlm":
            batch["img_embeds"] = rng.normal(scale=0.02, size=(
                B, cfg_s.n_img_tokens, cfg_s.d_model)).astype(np.float32)
        if cfg_s.family == "audio":
            batch["frames"] = rng.normal(scale=0.02, size=(
                B, cfg_s.n_frames, cfg_s.d_model)).astype(np.float32)
        _build.reset_launches()
        l_cpu, g_cpu = loss_and_grads(cpu, cfg_s, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        l_card, g_card = loss_and_grads(card, cfg_s, {
            k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        launches = {name: _build.launches()[name] for name in kernels}
        rel_loss = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
        errs = {}
        for n, g in g_cpu.items():
            scale = float(g.abs().max())
            err = float((g_card[n].cpu() - g).abs().max())
            errs[n] = err / scale if scale else err
        name = max(errs, key=errs.get)
        finite = all(bool(torch.isfinite(g).all())
                     for g in g_card.values())
        worst[cfg_s.name] = errs[name]
        emit(phase="grad_consistency_f32", arch=cfg_s.name, batch=B, seq=S,
             params=len(errs), loss_cpu=float(l_cpu),
             loss_card=float(l_card), rel_loss=rel_loss, loss_tol=1e-5,
             worst_param=name, worst_grad_err=errs[name], grad_tol=1e-4,
             finite=finite, launches=launches)
        check(rel_loss <= 1e-5, f"{cfg_s.name}: card loss {float(l_card)} "
              f"against CPU {float(l_cpu)}")
        check(errs[name] <= 1e-4, f"{cfg_s.name}: gradient of {name} "
              f"differs by {errs[name]} of its largest |g|")
        check(finite, f"{cfg_s.name}: non-finite gradient on the card")
        check(not any(launches.values()), f"{cfg_s.name}: a gradient "
              f"path launched {launches}")
        del cpu, card, g_cpu, g_card
    emit(phase="train_phases", seconds=time.perf_counter() - t_phase)
    torch.cuda.empty_cache()
    return dict(launches=serve_launches["flash_sm90"],
                launches_path=f"train_then_serve {cfg.name}",
                shape=[TRAIN_BATCH, cfg.n_heads, TRAIN_SEQ, cfg.head_dim])


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
    torch.cuda.empty_cache()
    rows[-2]["train_path"] = train_path(args, dev, emit)   # flash_sm90's row

    emit(phase="total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": rows}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
