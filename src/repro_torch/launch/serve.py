"""Serving launcher, ported from ``src/repro/launch/serve.py``:
solver-as-a-service for sparse systems, and token serving (batched
prefill, then KV-cache decode with sampling).

    PYTHONPATH=src python -m repro_torch.launch.serve --solver --requests 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --batch 8 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
        --batch 8 --prompt-len 224
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Solver serving (the paper's CG at traffic scale: many right-hand sides
against a pool of matrices that change over time) is
:class:`SolverService`:

  * **operator cache** — LRU keyed by :func:`matrix_fingerprint` (shape +
    nnz + a blake2b hash of the CSR bytes, bit-equal to the reference's),
    so repeat traffic skips the plan build and format conversion;
  * **bucketed admission** — each request's RHS batch is padded with zero
    columns up to a size class from ``buckets``; a zero column costs no
    iteration under the masked batched CG (``||b||^2 = 0`` keeps it
    inactive from iteration 0).  The reference compiles one program per
    (matrix, class); eager PyTorch compiles nothing, but the counters
    (``bucket_hits`` / ``bucket_misses``) count the classes as it does;
  * **streaming updates** — :meth:`SolverService.update_matrix` applies an
    :class:`repro_torch.sparse.replan.EdgeDelta`: an O(delta) plan patch
    when the plan carries a replan cache, else a rebuild; with a
    :class:`repro_torch.core.replan_policy.DriftPolicy` a drifted
    partition is rebuilt on a fresh one and the solver state migrated.

Weights are random, drawn from a seeded ``torch.Generator``; prompts come
from ``np.random.default_rng(0)`` as in the reference.  The sampled tokens
stay on the device and are copied to the host once, at the end.  Sampling
is Gumbel-max over the padded vocabulary at ``--temperature``, then clamped
to ``vocab - 1``, as the reference's ``jax.random.categorical`` step is;
the two generators draw different tokens.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import time
from collections import OrderedDict

import numpy as np
import torch

from ..configs.registry import ARCHS, get_config
from ..core.replan_policy import DriftDecision, DriftMonitor, DriftPolicy
from ..device import resolve_device
from ..kernels import _build
from ..models import encdec
from ..models.config import ModelConfig
from ..models.steps import make_decode_step, make_prefill, model_module
from ..sparse.cg import CGResult, cg_solve
from ..sparse.graph import structure_graph
from ..sparse.operator import make_operator
from ..sparse.replan import (EdgeDelta, apply_delta_csr, apply_edge_delta,
                             migrate_state)


# --------------------------------------------------------------------------
# Solver serving
# --------------------------------------------------------------------------

def matrix_fingerprint(indptr, indices, data) -> str:
    """Cache key for a CSR matrix: ``<n>:<nnz>:<blake2b>`` over the dtype,
    shape and bytes of all three arrays.  Content-hashed — two structurally
    identical matrices with different values never collide."""
    h = hashlib.blake2b(digest_size=16)
    for a in (indptr, indices, data):
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(np.int64(a.size).tobytes())
        h.update(a.tobytes())
    return f"{len(indptr) - 1}:{len(indices)}:{h.hexdigest()}"


@dataclasses.dataclass
class ServeStats:
    """Admission/cache counters.  ``padding_waste`` is the fraction of
    solved columns that were admission padding."""

    operator_hits: int = 0
    operator_misses: int = 0
    operator_evictions: int = 0
    bucket_hits: int = 0            # (matrix, size-class) seen before
    bucket_misses: int = 0          # first solve of the class
    real_cols: int = 0
    padded_cols: int = 0
    solves: int = 0
    plan_patches: int = 0           # update_matrix served by O(delta) patch
    plan_rebuilds: int = 0          # update_matrix paid a full plan build
    drift_trips: int = 0            # rebuilds forced by the drift monitor

    @property
    def padding_waste(self) -> float:
        total = self.real_cols + self.padded_cols
        return self.padded_cols / total if total else 0.0


@dataclasses.dataclass
class UpdateResponse:
    """One served :meth:`SolverService.update_matrix`: the matrix moved to
    a new fingerprint, either by an O(delta) plan patch or by a full
    rebuild (drift trip / no replan cache)."""

    fingerprint: str                # fingerprint of the mutated matrix
    old_fingerprint: str
    patched: bool                   # True: O(delta) patch; False: rebuild
    repartitioned: bool             # rebuild used a fresh partition
    drift: DriftDecision | None     # None when no drift policy is set
    state: tuple | None             # migrated solver state (if passed in)


@dataclasses.dataclass
class SolveResponse:
    """One served solve: gathered solution plus per-column convergence
    info (padding columns already stripped)."""

    x: np.ndarray                   # (n,) or (n, nb)
    iters: np.ndarray               # () or (nb,) int
    residual: np.ndarray            # () or (nb,)
    fingerprint: str = ""
    bucket: int = 0
    cache_hit: bool = False         # operator came from the cache
    warm: bool = False              # (matrix, bucket) class seen before


class SolverService:
    """Multi-RHS CG serving over a pool of matrices (see module docstring).

    ``backend`` / ``op_kw`` go to :func:`repro_torch.sparse.operator.
    make_operator` verbatim (e.g. ``backend='dist_hier', part=..., k=8,
    pods=2``), on ``device`` (default the card; raises without one).
    The solver parameters are fixed per service.  ``capacity`` bounds the
    operator cache (least-recently-used eviction drops the operator and
    every per-matrix table)."""

    def __init__(self, backend: str = "coo",
                 buckets: tuple[int, ...] = (1, 2, 4, 8, 16),
                 capacity: int = 8, tol: float = 1e-6,
                 max_iters: int = 500, precondition: str | None = None,
                 drift: DriftPolicy | None = None, repartition=None,
                 device=None, **op_kw):
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(f"buckets must be sorted unique size classes; "
                             f"got {buckets!r}")
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.device = resolve_device(device)
        self.backend = backend
        self.buckets = tuple(int(b) for b in buckets)
        self.capacity = capacity
        self.tol = tol
        self.max_iters = max_iters
        self.precondition = precondition
        self.op_kw = op_kw
        self.stats = ServeStats()
        self._ops: OrderedDict[str, object] = OrderedDict()
        self._warm: set[tuple[str, int]] = set()
        # streaming updates (update_matrix): host CSR per cached matrix,
        # drift monitor per matrix, per-matrix partition overrides from
        # drift-tripped repartitions
        self.drift = drift
        self.repartition = repartition
        self._csr: dict[str, tuple] = {}
        self._monitors: dict[str, DriftMonitor] = {}
        self._parts: dict[str, np.ndarray] = {}

    def _make(self, indptr, indices, data, **kw):
        return make_operator(indptr, indices, data, self.backend,
                             device=self.device, **kw)

    def bucket_for(self, nb: int) -> int:
        """Smallest admission class holding ``nb`` columns; oversize
        requests become their own exact-width class."""
        for b in self.buckets:
            if nb <= b:
                return b
        return nb

    def operator_for(self, indptr, indices, data,
                     fingerprint: str | None = None):
        """``(fingerprint, operator, hit)`` with LRU admission: a cached
        matrix skips plan construction / format conversion entirely."""
        fp = fingerprint or matrix_fingerprint(indptr, indices, data)
        op = self._ops.get(fp)
        if op is not None:
            self._ops.move_to_end(fp)
            self.stats.operator_hits += 1
            return fp, op, True
        self.stats.operator_misses += 1
        op = self._make(indptr, indices, data, **self.op_kw)
        self._install(fp, op, (np.asarray(indptr), np.asarray(indices),
                               np.asarray(data)))
        return fp, op, False

    def _install(self, fp: str, op, csr: tuple) -> None:
        """Admit (fp, op) into the LRU, keeping the host CSR for
        :meth:`update_matrix`; evicts down to capacity."""
        self._ops[fp] = op
        self._csr[fp] = csr
        while len(self._ops) > self.capacity:
            old_fp, _ = self._ops.popitem(last=False)
            self._retire(old_fp)
            self.stats.operator_evictions += 1

    def _retire(self, fp: str) -> None:
        """Drop every per-matrix table keyed by ``fp`` — seen size
        classes, host CSR, drift state, partition override."""
        self._warm = {w for w in self._warm if w[0] != fp}
        self._csr.pop(fp, None)
        self._monitors.pop(fp, None)
        self._parts.pop(fp, None)

    def update_matrix(self, fingerprint: str, delta: EdgeDelta,
                      state=None) -> UpdateResponse:
        """Apply an :class:`EdgeDelta` to a cached matrix in place of a
        full re-admission: the operator moves to the mutated matrix's
        fingerprint via an O(delta) plan patch
        (:func:`repro_torch.sparse.replan.apply_edge_delta`) when its plan
        carries a replan cache, and via a full rebuild otherwise.

        With a :class:`DriftPolicy` (``drift=`` at construction) every
        update is priced against the last full plan's baseline; a
        threshold trip forces a rebuild on a fresh partition from the
        ``repartition`` callable (``repartition(g) -> (n,) part``) and
        migrates ``state`` (a sequence of operator-space solver vectors)
        onto the new layout, as tensors on the service's device.  Trips
        without a ``repartition`` callable are recorded but still served
        by patching.

        The old fingerprint is fully retired: a later solve against the
        *unmutated* matrix is an operator miss, never a stale hit.
        """
        csr = self._csr.get(fingerprint)
        if csr is None:
            raise KeyError(f"unknown or evicted fingerprint "
                           f"{fingerprint!r}")
        op = self._ops[fingerprint]
        indptr, indices, data = csr
        ip2, ix2, d2 = apply_delta_csr(indptr, indices, data, delta)
        new_fp = matrix_fingerprint(ip2, ix2, d2)
        plan = getattr(op, "plan", None)
        cache = getattr(plan, "_replan", None)

        decision = None
        monitor = self._monitors.pop(fingerprint, None)
        if self.drift is not None:
            if cache is not None:
                part, anc = cache.part, getattr(plan, "anc", None)
            else:
                part = self._parts.get(fingerprint,
                                       self.op_kw.get("part"))
                anc = None
            if part is not None:
                if monitor is None:
                    monitor = DriftMonitor(self.drift)
                    monitor.reset(structure_graph(indptr, indices, data),
                                  part, anc)
                g2 = structure_graph(ip2, ix2, d2)
                decision = monitor.observe(g2, part, anc)
                if decision.repartition:
                    self.stats.drift_trips += 1

        repartitioned = (decision is not None and decision.repartition
                         and self.repartition is not None)
        out_state = tuple(state) if state is not None else None
        if cache is not None and not repartitioned:
            new_plan = apply_edge_delta(plan, delta)
            new_op = dataclasses.replace(op, plan=new_plan)
            self.stats.plan_patches += 1
            patched = True
        else:
            kw = dict(self.op_kw)
            if fingerprint in self._parts:
                kw["part"] = self._parts[fingerprint]
            if repartitioned:
                kw["part"] = np.asarray(
                    self.repartition(structure_graph(ip2, ix2, d2)))
                self._parts[new_fp] = kw["part"]
            new_op = self._make(ip2, ix2, d2, **kw)
            self.stats.plan_rebuilds += 1
            patched = False
            new_plan = getattr(new_op, "plan", None)
            if out_state is not None and plan is not None \
                    and new_plan is not None:
                moved = migrate_state(plan, new_plan, *out_state)
                out_state = moved if isinstance(moved, tuple) else (moved,)
            if monitor is not None:
                new_cache = getattr(new_plan, "_replan", None)
                monitor.reset(
                    structure_graph(ip2, ix2, d2),
                    new_cache.part if new_cache is not None
                    else kw.get("part"),
                    getattr(new_plan, "anc", None))

        self._ops.pop(fingerprint, None)
        self._retire(fingerprint)
        self._install(new_fp, new_op, (ip2, ix2, d2))
        if monitor is not None:
            self._monitors[new_fp] = monitor
        return UpdateResponse(fingerprint=new_fp,
                              old_fingerprint=fingerprint,
                              patched=patched, repartitioned=repartitioned,
                              drift=decision, state=out_state)

    def static_cost(self, indptr, indices, data, nb: int = 1,
                    fingerprint: str | None = None) -> dict:
        """The reference prices a request by counting the solver's
        FLOPs and bytes with its jaxpr auditor (``analysis/trace.py``)
        and running the static roofline of ``launch/roofline.py`` over
        the count.  The port's exchange audit (``repro_torch.analysis``)
        records what an operator exchanges, but neither the count nor the
        roofline is ported, so this raises."""
        raise NotImplementedError(
            "SolverService.static_cost: the exchange audit of "
            "ROADMAP.md queue 1 item 10 is ported (repro_torch.analysis); "
            "the static FLOP/byte count and roofline of queue 1 item 19 "
            "(launch/roofline.py) are still missing")

    def solve(self, indptr, indices, data, b,
              fingerprint: str | None = None) -> SolveResponse:
        """Serve one request: admit ``b`` ((n,) or (n, nb)) into its size
        class, resolve the operator through the cache, run the batched
        masked CG, strip the padding columns."""
        b = np.asarray(b)
        single = b.ndim == 1
        bcols = b[:, None] if single else b
        nb = bcols.shape[1]
        bucket = self.bucket_for(nb)
        fp, op, hit = self.operator_for(indptr, indices, data, fingerprint)
        warm = (fp, bucket) in self._warm
        if warm:
            self.stats.bucket_hits += 1
        else:
            self.stats.bucket_misses += 1
            self._warm.add((fp, bucket))
        self.stats.real_cols += nb
        self.stats.padded_cols += bucket - nb
        self.stats.solves += 1
        if bucket > nb:
            pad = np.zeros((bcols.shape[0], bucket - nb), bcols.dtype)
            bcols = np.concatenate([bcols, pad], axis=1)
        res = self._run(op, bcols)
        x = op.gather(res.x)[:, :nb]
        iters = res.iters.cpu().numpy()[:nb]
        residual = res.residual.cpu().numpy()[:nb]
        if single:
            x, iters, residual = x[:, 0], iters[0], residual[0]
        return SolveResponse(x=x, iters=iters, residual=residual,
                             fingerprint=fp, bucket=bucket, cache_hit=hit,
                             warm=warm)

    def _run(self, op, bcols) -> CGResult:
        if hasattr(op, "solve"):        # the distributed whole-CG solver
            return op.solve(bcols, tol=self.tol, max_iters=self.max_iters,
                            precondition=self.precondition)
        return cg_solve(op, op.scatter(bcols), tol=self.tol,
                        max_iters=self.max_iters,
                        precondition=self.precondition, batched=True)


def _solver_traffic(args) -> None:
    """Synthetic traffic mix against a SolverService: a small pool of
    Laplacian systems, Zipf-ish repeat pattern, random batch widths.
    Prints solves/sec, latency percentiles and the cache counters."""
    from ..sparse.generators import grid
    from ..sparse.graph import laplacian_csr

    rng = np.random.default_rng(0)
    pool = []
    for i, side in enumerate((12, 16, 20, 24)[:args.pool]):
        g = grid((side, side))
        pool.append(laplacian_csr(g, shift=0.05 * (i + 1)))
    svc = SolverService(backend="coo", capacity=args.capacity,
                        tol=1e-6, max_iters=500, device=args.device)
    lat = []
    t_all = time.perf_counter()
    for r in range(args.requests):
        indptr, indices, data = pool[int(rng.zipf(1.5)) % len(pool)]
        nb = int(rng.integers(1, 9))
        b = rng.normal(size=(len(indptr) - 1, nb)).astype(np.float32)
        t0 = time.perf_counter()
        svc.solve(indptr, indices, data, b)     # x comes back on the host
        lat.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_all
    lat_ms = np.sort(np.array(lat)) * 1e3
    s = svc.stats
    print(f"requests={args.requests} solves/sec={args.requests / wall:.1f} "
          f"device={svc.device}")
    print(f"latency ms: p50={np.percentile(lat_ms, 50):.2f} "
          f"p95={np.percentile(lat_ms, 95):.2f} "
          f"max={lat_ms[-1]:.2f}")
    print(f"operator cache: hits={s.operator_hits} "
          f"misses={s.operator_misses} evictions={s.operator_evictions}")
    print(f"buckets: hits={s.bucket_hits} misses={s.bucket_misses} "
          f"padding_waste={s.padding_waste:.1%}")


# --------------------------------------------------------------------------
# Token serving
# --------------------------------------------------------------------------


class _Timer:
    """Milliseconds of the work between enter and exit: CUDA events on
    the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.ms = 0.0

    def __enter__(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            self.ms = self.start.elapsed_time(self.end)
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3
        return False


def sample(logits: torch.Tensor, temperature: float,
           gen: torch.Generator) -> torch.Tensor:
    """Categorical draw per row of (B, V) logits (Gumbel-max, float32)."""
    u = torch.rand(logits.shape, generator=gen, dtype=torch.float32,
                   device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() / temperature + gumbel, dim=-1)


def stub_inputs(cfg: ModelConfig, rng: np.random.Generator, batch: int,
                device) -> dict:
    """What a VLM's or the audio family's stub frontend would hand the
    model: ``img_embeds`` (batch, n_img_tokens, d_model) or ``frames``
    (batch, n_frames, d_model), float32 normal of scale 0.02 drawn from
    ``rng`` as the reference's launcher draws them; nothing for the other
    families."""
    name, rows = {"vlm": ("img_embeds", cfg.n_img_tokens),
                  "audio": ("frames", cfg.n_frames)}.get(cfg.family,
                                                         (None, 0))
    if name is None:
        return {}
    return {name: torch.from_numpy(rng.normal(
        scale=0.02, size=(batch, rows, cfg.d_model)).astype(
        np.float32)).to(device)}


def serve_tokens(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 32,
                 gen: int = 32, temperature: float = 0.8, seed: int = 0,
                 device=None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode ``gen`` tokens each.  A VLM's prefill also takes random image
    embeddings (batch, n_img_tokens, d_model), the audio family's random
    frames (batch, n_frames, d_model), drawn from the prompts' generator
    after them, as the reference does; the prefill's time includes the
    encoder.  ``device=None`` is the card (raises without one).  The
    prefill and decode steps come from ``models.steps``'s factories, which
    run under ``torch.no_grad()``: the prefill takes the flash kernels
    whatever the parameters' ``requires_grad``.

    Returns the numbers: ``prefill_ms``, ``decode_ms_per_token`` and
    ``tok_per_s`` (None for ``gen == 0``), ``tokens`` (host int array of
    prompts and generated ids), ``logits`` (the last step's, on the
    device) and the kernel launches of the prefill and of the decode loop
    (``launches_prefill``, ``launches_decode``).
    """
    if cfg.family == "audio":
        encdec.check_positions(cfg, prompt_len + gen)
    dev = resolve_device(device)
    model = model_module(cfg).init_model(cfg, seed=seed, device=dev)
    cache_len = prompt_len + max(gen, 1)
    prefill = make_prefill(cfg, cache_len=cache_len)
    decode = make_decode_step(cfg)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, size=(batch, prompt_len),
                           dtype=np.int32)
    inputs = {"tokens": torch.from_numpy(prompts).to(dev),
              **stub_inputs(cfg, rng, batch, dev)}
    if dev.type == "cuda":
        _build.build_all(["flash", "flash_sm90"])  # set-up, not prefill

    before = _build.launches()
    with _Timer(dev) as t_prefill:
        logits, cache = prefill(model, inputs)
    mid = _build.launches()

    sampler = torch.Generator(device=dev).manual_seed(seed + 1)
    out = torch.empty((batch, gen), dtype=torch.int64, device=dev)
    with _Timer(dev) as t_decode:
        for t in range(gen):
            tok = sample(logits[:, -1], temperature, sampler)
            tok = torch.clamp_max(tok, cfg.vocab - 1)[:, None]
            out[:, t:t + 1] = tok
            logits, cache = decode(model, cache, tok, prompt_len + t)
    after = _build.launches()
    decode_ms = t_decode.ms / gen if gen else None
    return dict(
        arch=cfg.name, device=str(dev), batch=batch, prompt_len=prompt_len,
        gen=gen, prefill_ms=t_prefill.ms, decode_ms_per_token=decode_ms,
        tok_per_s=batch * gen / (t_decode.ms / 1e3) if gen else None,
        tokens=np.concatenate([prompts, out.cpu().numpy()], axis=1),
        logits=logits,
        launches_prefill={k: mid[k] - before[k] for k in mid},
        launches_decode={k: after[k] - mid[k] for k in after})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--solver", action="store_true",
                    help="serve CG solves (synthetic traffic) instead of "
                         "tokens")
    ap.add_argument("--requests", type=int, default=32,
                    help="solver mode: synthetic requests to serve")
    ap.add_argument("--pool", type=int, default=3,
                    help="solver mode: distinct matrices in the pool")
    ap.add_argument("--capacity", type=int, default=8,
                    help="solver mode: operator-cache capacity")
    ap.add_argument("--arch", choices=ARCHS, default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.solver:
        _solver_traffic(args)
        return
    cfg = get_config(args.arch, smoke=args.smoke)
    r = serve_tokens(cfg, batch=args.batch, prompt_len=args.prompt_len,
                     gen=args.gen, temperature=args.temperature,
                     device=args.device)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} device={r['device']}")
    if args.gen:        # --gen 0 is prefill-only: no per-token rate exists
        print(f"prefill {r['prefill_ms']:.1f} ms; decode "
              f"{r['decode_ms_per_token']:.2f} ms/token "
              f"({r['tok_per_s']:.1f} tok/s)")
    else:
        print(f"prefill {r['prefill_ms']:.1f} ms; decode skipped (--gen 0)")
    print("sample token ids:",
          r["tokens"][0, :args.prompt_len + min(args.gen, 8)].tolist())


if __name__ == "__main__":
    main()
