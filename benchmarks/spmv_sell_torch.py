"""The port's block-ELL kernel on one GPU, apart from the rest of the path.

    python3 benchmarks/spmv_sell_torch.py [--side 1024] [--stacked]
        [--parent OLD/src] [--diagnose] [--seed 0]

Builds ``csrc/spmv_bell.cu``, prints ptxas's registers and spills for its
kernels, runs ``chip_smoke.py``'s phase-3 block-ELL checks (every form
against the plain versions and scipy, non-finite x against the dense
product), asks whether ``nonzero`` takes a mask of more than 2^31 elements
on the card, then times the sell route on the ``bell`` operator of
``grid((side, side))`` for an (n,) x and at nb = 1, 4 and 16; with
``--stacked``, also at the stacked shape of ``dist_bell`` on phase 4's
topology and geoKM partition.  One JSON line per check and per shape,
tagged with the card's name and power limit; the numbers are those of
``chip_smoke.bell_times``.

``--parent`` names the ``src`` of another tree (an older commit unpacked
with ``git archive`` into ``build/``): its ``repro_torch`` is loaded beside
this one, its own kernels built into that tree's ``build/torch_ext/``, and
its ``spmv_block_ell`` without an index (in a tree from before the sell
route, the kernels that stream every block) is timed in turns with this
tree's sell route on the same tensors (old, sell, sell, old).  Exits 2
without a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmarks"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--stacked", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", default=None,
                    help="src of another tree whose spmv_block_ell (without "
                         "an index) is timed in turns with the sell route")
    ap.add_argument("--diagnose", action="store_true",
                    help="also split the sell wrapper's host time into its "
                         "parts and profile the library calls")
    args = ap.parse_args(argv)

    import numpy as np
    import scipy.sparse as sp
    import torch

    if not torch.cuda.is_available():
        print("spmv_sell_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import ptxas_torch_kernels
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import (spmv_block_ell_multi_ref,
                                         spmv_block_ell_ref, spmv_sell_ref)
    from repro_torch.kernels.spmv_bell import bell_index, spmv_block_ell
    from repro_torch.sparse.generators import grid
    from repro_torch.sparse.graph import laplacian_csr
    from repro_torch.sparse.operator import make_operator

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tag = {"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.smi()}

    def emit(**kw):
        print(json.dumps({**kw, **tag}), flush=True)

    t0 = time.perf_counter()
    emit(phase="build", per_source_s=_build.build_all(["spmv_bell"]),
         seconds=time.perf_counter() - t0)
    if ptxas_torch_kernels.main(["spmv_bell"]) != 0:
        return 1
    old_mod = None
    if args.parent:
        old_mod = load_tree(args.parent, "parent_repro_torch")
        emit(phase="build_parent", src=args.parent,
             per_source_s=old_mod._build.build_all(["spmv_bell"]))

    def old_call(blocks, cols, x):
        """The parent tree's product on these tensors, or None."""
        if old_mod is None:
            return None
        return lambda: old_mod.spmv_block_ell(blocks, cols, x)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    errs: dict = {}
    cs.bell_checks(args, dev, gen, emit, errs)
    emit(phase="checks", max_abs_err=errs)
    nonzero_probe(emit)

    g = grid((args.side, args.side))
    csr = laplacian_csr(g, shift=1e-2)
    A = sp.csr_matrix((csr[2], csr[1], csr[0]), shape=(g.n, g.n))
    t0 = time.perf_counter()
    op = make_operator(*csr, "bell", device=dev)
    torch.cuda.synchronize()
    op_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bell_index(op.blocks, op.cols, g.n)
    torch.cuda.synchronize()
    emit(phase="bell_operator", seconds=op_s,
         bell_index_s=time.perf_counter() - t0, shape=list(op.blocks.shape),
         nnz=op.index.nnz, index_entries=len(op.index.cols))
    a_csr = cs.host_csr_tensor(A, dev)
    for shape in ((g.n,), (g.n, 1), (g.n, 4), (g.n, 16)):
        x = torch.randn(*shape, generator=gen, device=dev)
        got = spmv_block_ell(op.blocks, op.cols, x, index=op.index)
        ok, err = cs.close(got, spmv_sell_ref(op.index, op.blocks, op.cols,
                                              x), 1e-4, 1e-4)
        cs.check(ok, f"spmv_sell {shape} disagrees with its plain version: "
                     f"{err}")
        old = old_call(op.blocks, op.cols, x)
        if old is not None:
            want = (spmv_block_ell_multi_ref if x.dim() == 2
                    else spmv_block_ell_ref)(op.blocks, op.cols, x)
            ok, err_old = cs.close(old(), want, 1e-4, 1e-4)
            cs.check(ok, f"the parent's product {shape} disagrees with the "
                         f"plain version: {err_old}")
        emit(timing="bell", x_shape=list(shape), max_abs_err=err,
             **cs.bell_times(op.blocks, op.cols, op.index, x, {
                 "csr": lambda: a_csr @ (x if x.dim() == 2 else x[:, None])},
                 old=old))
    if args.diagnose:
        diagnose(op, a_csr, g.n, emit)
    del op, a_csr
    torch.cuda.empty_cache()

    if args.stacked:
        from repro_torch.core.api import partition
        from repro_torch.core.topology import Topology, scale_to_load
        topo = scale_to_load(Topology.topo1(8, 2 / 8, 8.0, 8.5), g.n)
        part, _ = partition(g, topo, "geoKM", use_pallas=True)
        op = make_operator(*csr, "dist_bell", part=part, k=8)
        plan = op.plan
        blocks, bcols = plan.bell_local()
        index = plan.bell_index()
        xs = torch.randn(plan.k, plan.B, generator=gen, device=dev)
        xs = xs * plan.row_mask
        got = spmv_block_ell(blocks, bcols, xs, index=index)
        ok, err = cs.close(got, spmv_block_ell_ref(blocks, bcols, xs), 1e-4,
                           1e-4)
        cs.check(ok, f"stacked spmv_sell disagrees with the dense plain "
                     f"version: {err}")
        real = plan.row_mask.reshape(-1) != 0
        live = plan.vals_int != 0
        boff = torch.arange(plan.k, device=dev)[:, None] * plan.B
        new_id = torch.cumsum(real.long(), 0) - 1
        r = new_id[(boff + plan.rows_int.long())[live]].cpu().numpy()
        c = new_id[(boff + plan.cols_int.long())[live]].cpu().numpy()
        a_real = cs.host_csr_tensor(sp.csr_matrix(
            (plan.vals_int[live].cpu().numpy(), (r, c)),
            shape=(g.n, g.n)), dev)
        x_real = xs.reshape(-1, 1)[real]
        old = old_call(blocks, bcols, xs)
        if old is not None:
            ok, err_old = cs.close(old(), got, 1e-4, 1e-4)
            cs.check(ok, f"the parent's stacked product disagrees with the "
                         f"sell route: {err_old}")
        emit(timing="stacked", shape=list(blocks.shape), max_abs_err=err,
             **cs.bell_times(blocks, bcols, index, xs,
                             {"csr": lambda: a_real @ x_real}, old=old))
        if args.diagnose:
            cg_profile(op, np.random.default_rng(args.seed + 1).normal(
                size=g.n).astype(np.float32), emit)
        if args.diagnose:
            # the same entries in the (k, B) layout, padding rows and all
            r = (boff + plan.rows_int.long())[live].cpu().numpy()
            c = (boff + plan.cols_int.long())[live].cpu().numpy()
            a_pad = cs.host_csr_tensor(sp.csr_matrix(
                (plan.vals_int[live].cpu().numpy(), (r, c)),
                shape=(plan.k * plan.B,) * 2), dev)
            for label, call in (
                    ("without the padding rows", lambda: a_real @ x_real),
                    ("with the padding rows",
                     lambda: a_pad @ xs.reshape(-1, 1))):
                emit(profile=f"stacked library call {label}",
                     table=profile(call))
    print(json.dumps({"ok": True, "device": tag["device"]}))
    return 0


def load_tree(src: str, name: str):
    """``src``'s ``repro_torch`` as package ``name`` (its imports are
    relative, so it loads beside this tree's); returns its
    ``kernels.spmv_bell``."""
    import importlib
    import importlib.util
    init = Path(src).resolve() / "repro_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(name + ".kernels.spmv_bell")


def nonzero_probe(emit) -> None:
    """Whether ``nonzero`` takes a boolean mask of 2^31 + 64 elements on
    the card (``bell_index`` keeps each of its masks at or below 2^30)."""
    import torch
    mask = torch.zeros((1 << 31) + 64, dtype=torch.bool, device="cuda")
    mask[-1] = True
    try:
        found = mask.nonzero().reshape(-1).tolist()
        emit(probe="nonzero_above_int32", elements=mask.numel(),
             refused=False, found=found, ok=found == [mask.numel() - 1])
    except RuntimeError as exc:
        emit(probe="nonzero_above_int32", elements=mask.numel(),
             refused=True, error=str(exc).splitlines()[0][:300])
    del mask
    torch.cuda.empty_cache()


def profile(fn, reps: int = 5) -> str:
    """torch.profiler's table of ``reps`` calls of ``fn``, by device
    time."""
    import torch
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages().table(sort_by="cuda_time_total",
                                     row_limit=12)


def diagnose(op, a_csr, n, emit) -> None:
    """Host microseconds per call of the sell wrapper and of each of its
    parts (calls enqueued back to back), and the profiler's table of the
    1024^2 library call."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import spmv_bell as sb

    dev = op.blocks.device
    x = torch.randn(n, device=dev)
    buf = torch.empty(n + 1, device=dev)
    idx = op.index
    fn = _build.launcher("spmv_bell", "spmv_sell_f32")
    stream = torch.cuda.current_stream().cuda_stream
    S, NNZB, BM, BK = op.blocks.shape
    ptrs = (idx.ptr.data_ptr(), idx.cols.data_ptr(), idx.vals.data_ptr(),
            op.blocks.data_ptr(), op.cols.data_ptr(), x.data_ptr(),
            buf.data_ptr(), buf.data_ptr() + 4 * n)

    def host_us(f, reps=200):
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        return us

    emit(diagnose="sell wrapper host us per call",
         wrapper=host_us(lambda: sb.spmv_block_ell(op.blocks, op.cols, x,
                                                   index=idx)),
         checks=host_us(lambda: sb._check_sell(op.blocks, op.cols, x, idx,
                                               False)),
         ctypes_launch=host_us(lambda: fn(*ptrs, n, n, 1, S, NNZB, BM, BK,
                                          stream)),
         two_empty=host_us(lambda: (torch.empty(n, device=dev),
                                    torch.empty(1, dtype=torch.int32,
                                                device=dev))),
         current_device=host_us(torch.cuda.current_device),
         raw_stream=host_us(
             lambda: torch._C._cuda_getCurrentRawStream(dev.index)),
         data_ptrs=host_us(lambda: (idx.ptr.data_ptr(), idx.cols.data_ptr(),
                                    idx.vals.data_ptr(),
                                    op.blocks.data_ptr(),
                                    op.cols.data_ptr(), x.data_ptr())),
         library=host_us(lambda: a_csr @ x[:, None]))
    emit(profile="1024^2 library call", table=profile(
        lambda: a_csr @ x[:, None]))


def cg_profile(op, b, emit, n_it: int = 40) -> None:
    """Where a CG iteration of ``op`` goes: ``n_it`` iterations of its
    fused solver at tol 0 under torch.profiler, the device's busy time
    (the sum of its kernels' times) against the wall time of that run
    and of the same iterations without the profiler, in this process
    (CUDA events, median of 3), and the kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity

    fused = op.fused_solver(tol=0.0, max_iters=n_it)
    xop = op.scatter(b)
    fused(xop)
    torch.cuda.synchronize()
    plain_ms = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fused(xop)
        end.record()
        end.synchronize()
        plain_ms.append(start.elapsed_time(end))
    wall_plain = sorted(plain_ms)[1]
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fused(xop)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(getattr(e, "self_device_time_total", None)
                  or e.self_cuda_time_total for e in kernels) / 1e3
    emit(profile="cg iterations", iterations=n_it, wall_ms=wall_ms,
         ms_per_iteration=wall_ms / n_it, device_busy_ms=busy_ms,
         device_idle_share=1 - busy_ms / wall_ms,
         wall_ms_unprofiled=wall_plain,
         ms_per_iteration_unprofiled=wall_plain / n_it,
         device_idle_share_unprofiled=1 - busy_ms / wall_plain,
         launches_per_iteration=sum(e.count for e in kernels) / n_it,
         table=prof.key_averages().table(sort_by="cuda_time_total",
                                         row_limit=15))


if __name__ == "__main__":
    sys.exit(main())
