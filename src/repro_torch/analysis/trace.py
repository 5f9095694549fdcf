"""Exchange audit for the port's solver programs — the torch counterpart of
``src/repro/analysis/trace.py``.

The reference traces each solver program abstractly and walks its jaxpr
for the staged collectives and dtype transitions.  An eager PyTorch
program has no jaxpr, so :func:`audit_operator` runs the operator instead,
on its own device, and records two things:

* **What the exchange moves.**  ``sparse.distributed._make_exchange``
  keeps its slot layout on its closure (``exchange.layout``).  The audit
  runs that exchange once on a probe
  vector whose every row holds its padded global id plus one (float64,
  exact up to 2^53 ids), so each received halo slot names the block it
  came from.  Per level and round it decodes the delivered (src, dst)
  block pairs and the words (slots that carry data), and holds them
  against the plan it is given — by default the operator's own, or any
  other plan passed as ``plan=``, as the reference's ``audit_jaxpr(...,
  plan=mut)``.
* **Dtypes.**  A ``TorchDispatchMode`` records every aten op of one matvec
  and of one CG chunk (``cg.CHUNK`` iterations at ``tol=0``) on an operand
  of the operator's dtype.

  ========  ===========================================================
  rule      what
  ========  ===========================================================
  TRACE001  a level's count of rounds that move words differs from the
            plan's rounds that schedule live words (a dropped or extra
            round, or rounds on the wrong level)
  TRACE002  a round delivers other (src, dst) block pairs, or another
            number of words, than the plan's round
  TRACE003  an exchange the plan cannot account for: an operator that
            exchanges held against no plan, an all-gather held against
            a round schedule or rounds against ``comm='allgather'``, or
            a delivery across the subtrees of its level
  TRACE004  float-width conversion on the solver dataflow (an f32
            upcast or a bf16 downcast)
  TRACE005  a float wider than the program dtype (an f64 tensor in an
            f32 program)
  ========  ===========================================================

``info['exchange']`` carries the record: per level the rounds with their
pairs and words, and ``payload_bytes_lvl`` — the words delivered per
level x the operator's itemsize, counted over every column of an
``nb``-wide operand.  Each delivered word is one (receiver, vertex) pair,
so per level it equals ``metrics.comm_volumes`` /
``tree_comm_volumes`` x itemsize x nb exactly.  An all-gather has no
rounds: its payload is the distinct remote words its matvec's columns
read (``matvec.gathered``), the same volume.

The block-ELL kernel is launched through ``ctypes``, so no dispatch mode
sees inside it: the mode records the tensors its wrapper allocates and
passes, and the dtypes the kernel accepts are the wrapper's to check
(``kernels/spmv_bell.py`` raises on any other).  The reference's
``TraceCost`` (FLOP and HBM counts) and its static roofline wait for
ROADMAP.md queue 1 item 19.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .diagnostics import Report

TRACE_RULES: dict[str, str] = {
    "TRACE001": "recorded exchange round count differs from the plan",
    "TRACE002": "a recorded round's pairs or words differ from the plan "
                "round",
    "TRACE003": "exchange not derivable from the plan",
    "TRACE004": "float-width conversion on the solver dataflow",
    "TRACE005": "float wider than the program dtype (f64 leak)",
}

_SAME_PLAN = object()           # audit_operator's default: the op's plan
# the aten ops a dtype conversion reaches in eager mode (``.to``,
# ``.type``, ``.double()`` ... decompose to ``_to_copy``): (source
# position, destination position or None for the op's result)
_CONVERSIONS = {"_to_copy": (0, None), "copy_": (1, 0)}


# --------------------------------------------------------------------------
# what the exchange moves
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ExchangeRecord:
    """The exchange of one operator as recorded on a probe.  ``rounds``:
    per level, ``{round: (sorted (src, dst) block pairs, words)}`` for the
    rounds that moved words; ``payload_bytes_lvl``: words x itemsize per
    level (``nb`` columns counted)."""

    comm: str
    rounds: dict[int, dict[int, tuple]]
    payload_bytes_lvl: tuple
    itemsize: int
    nb: int

    def to_dict(self) -> dict[str, Any]:
        return {"comm": self.comm, "itemsize": self.itemsize, "nb": self.nb,
                "payload_bytes_lvl": list(self.payload_bytes_lvl),
                "rounds": {lvl: {c: {"pairs": [list(p) for p in pairs],
                                     "words": words}
                                 for c, (pairs, words) in rnds.items()}
                           for lvl, rnds in self.rounds.items()}}


def _probe(k: int, B: int, nb: int | None, device) -> torch.Tensor:
    """(k, B[, nb]) float64: every row holds its padded global id + 1."""
    x = (torch.arange(k * B, dtype=torch.float64, device=device)
         + 1).reshape(k, B)
    if nb is not None:
        x = x[:, :, None].expand(k, B, nb).contiguous()
    return x


def _record_rounds(exchange, k: int, B: int, nb: int | None,
                   device) -> dict[int, dict[int, tuple]]:
    """Run ``exchange`` on the probe and decode, per level and round, the
    delivered (src block, dst block) pairs and the words."""
    x_ext = exchange(_probe(k, B, nb, device)).to("cpu").numpy()
    if x_ext.ndim == 2:
        x_ext = x_ext[:, :, None]
    out: dict[int, dict[int, tuple]] = {}
    for lvl, off, R, S in exchange.layout:
        seg = x_ext[:, off:off + R * S].reshape(k, R, S, -1)
        rounds = {}
        for c in range(R):
            dst, _, _ = np.nonzero(seg[:, c] > 0)
            if not len(dst):
                continue
            src = (seg[:, c][seg[:, c] > 0].astype(np.int64) - 1) // B
            pairs = tuple(sorted({(int(a), int(b))
                                  for a, b in zip(src, dst)}))
            rounds[c] = (pairs, int(len(dst)))
        out[lvl] = rounds
    return out


def _plan_levels(plan):
    """Per level: (round_perms, send_mask as host array, subtree size)."""
    from .verify import _arr
    if getattr(plan, "fanouts", ()):
        h = len(plan.fanouts)
        sizes = [int(np.prod(plan.fanouts[h - 1 - l:])) for l in range(h)]
        return [(plan.round_perms_lvl[l], _arr(plan.send_mask_lvl[l]),
                 sizes[l]) for l in range(h)]
    return [(plan.round_perms, _arr(plan.send_mask), int(plan.k))]


def _expected_rounds(plan, nb: int | None) -> list[dict[int, tuple]]:
    """Per level, ``{round: (sorted device pairs, words)}`` for the plan's
    rounds that schedule live words: a suffix pair (a, b) fires in every
    subtree of its level, and moves the sender's live slots."""
    width = nb or 1
    k = int(plan.k)
    out = []
    for perms, mask, size in _plan_levels(plan):
        live = mask.sum(axis=2)                         # (k, R)
        rounds = {}
        for c, pairs in enumerate(perms):
            got, words = set(), 0
            for a, b in pairs:
                for p in range(k // size):
                    s, d = p * size + int(a), p * size + int(b)
                    if 0 <= s < k and c < live.shape[1] and live[s, c] > 0:
                        got.add((s, d))
                        words += int(live[s, c]) * width
            if got:
                rounds[c] = (tuple(sorted(got)), words)
        out.append(rounds)
    return out


def _check_rounds(rec: dict[int, dict[int, tuple]], plan, nb,
                  rep: Report) -> None:
    expected = _expected_rounds(plan, nb)
    levels = set(range(len(expected))) | set(rec)
    for lvl in sorted(levels):
        want = expected[lvl] if lvl < len(expected) else {}
        got = rec.get(lvl, {})
        where = f"level {lvl}"
        if len(got) != len(want):
            rep.add("TRACE001",
                    f"level {lvl}: the exchange moves words in {len(got)} "
                    f"round(s), the plan schedules live words in "
                    f"{len(want)} — dropped or extra rounds (or rounds on "
                    "the wrong level)", where=where,
                    recorded=len(got), planned=len(want))
            continue
        for c in sorted(set(got) | set(want)):
            g_pairs, g_words = got.get(c, ((), 0))
            w_pairs, w_words = want.get(c, ((), 0))
            if g_pairs != w_pairs or g_words != w_words:
                rep.add("TRACE002",
                        f"level {lvl} round {c}: the exchange delivers "
                        f"{g_words} word(s) over pairs that differ from the "
                        f"plan's round ({w_words} word(s)) — halo words "
                        "would land on the wrong blocks",
                        where=f"level {lvl} round {c}",
                        recorded=list(g_pairs), planned=list(w_pairs),
                        recorded_words=g_words, planned_words=w_words)


def _check_subtrees(rec: dict[int, dict[int, tuple]], plan,
                    rep: Report) -> None:
    sizes = [size for _, _, size in _plan_levels(plan)]
    for lvl, rounds in sorted(rec.items()):
        size = sizes[lvl] if lvl < len(sizes) else int(plan.k)
        for c, (pairs, _) in sorted(rounds.items()):
            bad = [(s, d) for s, d in pairs if s // size != d // size]
            if bad:
                rep.add("TRACE003",
                        f"level {lvl} round {c}: deliveries {bad} cross the "
                        f"level's subtrees of {size} blocks — no schedule "
                        "of this level derives them",
                        where=f"level {lvl} round {c}", pairs=bad)


def _gathered_payload(coo, plan, nb: int | None) -> float:
    """Distinct remote (receiver block, padded global id) reads of an
    all-gather matvec's flat COO, times ``nb``: its useful payload."""
    k, B = int(plan.k), int(plan.B)
    rows, cols = (t.to("cpu").numpy().reshape(k, -1) for t in coo[:2])
    live = (np.arange(rows.shape[1])[None, :]
            < np.asarray(plan.nnz_blk)[:, None])
    recv, col = rows[live] // B, cols[live]
    remote = recv != col // B
    keys = np.unique(recv[remote] * (col.max(initial=0) + 1) + col[remote])
    return float(len(keys)) * (nb or 1)


def _record_exchange(op, plan, comm, nb, itemsize: int,
                     rep: Report) -> ExchangeRecord | None:
    spmv = getattr(op, "_spmv", None)
    own_comm = getattr(spmv, "comm", None)
    exchange = getattr(spmv, "exchange", None)
    gathered = getattr(spmv, "gathered", None)
    if own_comm is None:                 # a single-device operator
        if plan is not None and any(_expected_rounds(plan, nb)):
            rep.add("TRACE001", "the plan schedules exchange rounds but "
                                "the operator exchanges nothing",
                    where="level 0")
        return None
    if plan is None:
        rep.add("TRACE003", f"the {own_comm!r} exchange is held against no "
                            "plan: nothing derives it", where="exchange",
                kind=own_comm)
        return None
    k, B = int(op.plan.k), int(op.plan.B)
    if own_comm == "allgather":
        if comm != "allgather":
            rep.add("TRACE003", f"an all-gather exchange held against the "
                                f"comm={comm!r} round schedule",
                    where="exchange", kind="allgather")
        words = _gathered_payload(gathered, op.plan, nb)
        return ExchangeRecord(comm=own_comm, rounds={},
                              payload_bytes_lvl=(words * itemsize,),
                              itemsize=itemsize, nb=nb or 1)
    rec = _record_rounds(exchange, k, B, nb, op.plan.device)
    if comm == "allgather":
        rep.add("TRACE003", f"{sum(map(len, rec.values()))} exchange "
                            "round(s) held against comm='allgather', which "
                            "schedules none", where="exchange",
                kind=own_comm)
    else:
        _check_subtrees(rec, plan, rep)
        _check_rounds(rec, plan, nb, rep)
    n_lvl = max([len(_plan_levels(plan))] + [lvl + 1 for lvl in rec])
    payload = tuple(float(sum(w for _, w in rec.get(lvl, {}).values()))
                    * itemsize for lvl in range(n_lvl))
    return ExchangeRecord(comm=own_comm, rounds=rec,
                          payload_bytes_lvl=payload, itemsize=itemsize,
                          nb=nb or 1)


# --------------------------------------------------------------------------
# dtype flow (TRACE004/005)
# --------------------------------------------------------------------------

class _DtypeRecorder(TorchDispatchMode):
    """Records float conversions and float dtypes wider than ``base`` of
    every aten op run under it."""

    def __init__(self, base: torch.dtype):
        super().__init__()
        self.base = base
        self.conversions: set[tuple[torch.dtype, torch.dtype]] = set()
        self.wide: set[torch.dtype] = set()

    def _note(self, t) -> None:
        if isinstance(t, torch.Tensor) and t.is_floating_point() \
                and t.dtype.itemsize > self.base.itemsize:
            self.wide.add(t.dtype)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        conv = _CONVERSIONS.get(name)
        if conv is not None:
            src_i, dst_i = conv
            src = args[src_i] if len(args) > src_i else None
            dst = out if dst_i is None else args[dst_i]
            tensors = isinstance(src, torch.Tensor) \
                and isinstance(dst, torch.Tensor)
            if tensors and src.is_floating_point() \
                    and dst.is_floating_point() and src.dtype != dst.dtype:
                self.conversions.add((src.dtype, dst.dtype))
        for a in (*args, *kwargs.values()):
            self._note(a)
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            self._note(o)
        return out


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _report_dtypes(rec: _DtypeRecorder, rep: Report) -> None:
    for src, dst in sorted(rec.conversions, key=str):
        verb = "promotion" if dst.itemsize >= src.itemsize else "demotion"
        rep.add("TRACE004",
                f"silent float {verb} {_dtype_name(src)} -> "
                f"{_dtype_name(dst)} on the solver dataflow",
                where="dtype-flow", src=_dtype_name(src),
                dst=_dtype_name(dst))
    for dt in sorted(rec.wide, key=str):
        rep.add("TRACE005",
                f"a tensor of dtype {_dtype_name(dt)} is wider than the "
                f"{_dtype_name(rec.base)} program dtype — an f64 leak that "
                "silently promotes the dataflow", where="dtype-flow",
                dtype=_dtype_name(dt), base=_dtype_name(rec.base))


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def _op_dtype(op) -> torch.dtype:
    plan = getattr(op, "plan", None)
    if plan is not None:
        return plan.vals.dtype
    for name in ("vals", "blocks"):
        t = getattr(op, name, None)
        if isinstance(t, torch.Tensor):
            return t.dtype
    return torch.float32


def _operand(op, nb: int | None, dtype: torch.dtype) -> torch.Tensor:
    """An operator-space operand on the operator's device: ones on every
    real row (``row_mask`` in the stacked layout), ``nb`` columns wide."""
    plan = getattr(op, "plan", None)
    if plan is not None:
        x = plan.row_mask.to(dtype)
    else:
        x = torch.ones(op.n, dtype=dtype, device=op.device)
    if nb is not None:
        x = x[..., None].expand(*x.shape, nb).contiguous()
    return x


def _merge(rep: Report, sub: Report, tag: str) -> None:
    for d in sub.diagnostics:
        where = f"{tag}: {d.where}" if d.where else tag
        rep.diagnostics.append(dataclasses.replace(d, where=where))


def audit_operator(op, nb: int | None = None, solver: bool = True, *,
                   plan=_SAME_PLAN, comm: str | None = None,
                   precondition: str | None = None,
                   subject: str | None = None) -> Report:
    """Run one matvec and (with ``solver``) one CG chunk of ``op`` on its
    device; audit the exchange against ``plan`` (default the operator's
    own; ``None`` for none) under ``comm`` (default the operator's) and
    the dtype flow against the operator's dtype.  ``nb`` audits the
    batched (multi-RHS) programs.  ``info['exchange']`` carries the
    :class:`ExchangeRecord`; ``info['matvec']`` / ``info['cg']`` the
    finite flags of the runs."""
    from ..sparse.cg import CHUNK, cg_solve

    if plan is _SAME_PLAN:
        plan = getattr(op, "plan", None)
    if comm is None:
        comm = getattr(op, "comm", None)
    dtype = _op_dtype(op)
    itemsize = dtype.itemsize
    rep = Report(subject=subject or type(op).__name__)

    ex = Report(subject="exchange")
    rep.info["exchange"] = _record_exchange(op, plan, comm, nb, itemsize,
                                            ex)
    _merge(rep, ex, "exchange")

    x = _operand(op, nb, dtype)
    rec = _DtypeRecorder(dtype)
    with rec:
        y = op.matvec(x)
    sub = Report(subject="matvec")
    _report_dtypes(rec, sub)
    _merge(rep, sub, "matvec")
    rep.info["matvec"] = {"finite": bool(torch.isfinite(y).all())}
    if solver:
        rec = _DtypeRecorder(dtype)
        with rec:
            if hasattr(op, "fused_solver"):
                xs, _, it = op.fused_solver(0.0, CHUNK, precondition)(x)
            else:
                res = cg_solve(op, x, tol=0.0, max_iters=CHUNK,
                               precondition=precondition,
                               batched=nb is not None)
                xs, it = res.x, res.iters
        sub = Report(subject="cg")
        _report_dtypes(rec, sub)
        _merge(rep, sub, "cg")
        rep.info["cg"] = {"finite": bool(torch.isfinite(xs).all()),
                          "iters": it.to("cpu").tolist()}
    return rep


def audit_backend(backend: str, *, n: int = 144,
                  fanouts: tuple[int, ...] = (2, 2),
                  generator: str = "grid_2d", seed: int = 0,
                  nb: int | None = None, part=None,
                  precondition: str | None = None, device=None) -> Report:
    """Build a small fixture system and operator on ``device`` (default
    the card) and audit it — the CLI's ``trace`` entry point.  The default
    partition is the locality-preserving stripes, as in the reference."""
    from ..sparse.generators import GENERATORS
    from ..sparse.graph import laplacian_csr
    from ..sparse.operator import _HIER_BACKENDS, make_operator

    g = GENERATORS[generator](n, seed=seed)
    nv = g.n
    indptr, indices, data = laplacian_csr(g, shift=0.1)
    k = int(np.prod(fanouts))
    if part is None:
        part = (np.arange(nv) * k) // nv
    subject = (f"{backend} {generator} n={nv} fanouts="
               + "x".join(map(str, fanouts))
               + (f" nb={nb}" if nb else "")
               + (f" prec={precondition}" if precondition else ""))
    if backend in ("coo", "bell"):
        op = make_operator(indptr, indices, data, backend, device=device)
    else:
        kw: dict[str, Any] = {}
        if backend in _HIER_BACKENDS:
            if len(fanouts) < 2:
                raise ValueError(f"{backend} needs >= 2 tree levels; got "
                                 f"fanouts={fanouts}")
            kw["fanouts"] = tuple(fanouts)
        op = make_operator(indptr, indices, data, backend, part=part, k=k,
                           device=device, **kw)
    return audit_operator(op, nb=nb, precondition=precondition,
                          subject=subject)
