"""Static plan/schedule verifier — structural checks over the port's
``DistPlan`` / ``TreePlan`` invariants, runnable without a device: the
host NumPy of ``src/repro/analysis/verify.py``, copied, with every plan
field read through :func:`_arr`, which takes a numpy array or a tensor.
On the same plan it reports the reference's codes, with the same
``where``.

The paper's pipeline stands or falls on plan correctness: a mis-colored
round or a mis-routed halo slot silently produces wrong numerics.  What
matters is the schedule *actually executed per PU* (Langguth/Schlag/
Schulz), so this pass proves structural properties of the built plan
itself, not the modeled objective:

  ==========  ============================================================
  code        invariant
  ==========  ============================================================
  PLAN001     metadata: sizes/B/n consistency, ``perm`` is a permutation
              of padded ids, ``row_mask`` matches ``sizes``, packed nnz
              bookkeeping agrees with ``nnz_blk``
  PLAN002     level structure: ``fanouts`` multiply to k, per-level
              schedule tuples are mutually sized, ``level_offsets`` tile
              the extended vector, the ancestor table matches the
              tree-major mixed radix
  PLAN003     proper coloring: each round of each level's quotient
              schedule is a matching (no node talks to two partners in
              one round) and is bidirectional
  PLAN004     permutation rounds: every ``round_perms*`` entry has
              distinct sources, distinct destinations, in-range nodes
  PLAN005     send schedule: masked ``send_idx`` entries address real
              (non-ghost) local rows
  PLAN006     write-write race: abstract replay of the comm schedule
              delivers every halo slot at most once
  PLAN007     read-before-write: every halo slot read by a real edge was
              written by the replay, reads stay inside the extended
              vector, level-l boundary rows never read a slower level's
              slot range, local reads never address ghost rows
  PLAN008     tiling: interior + per-level boundary segments exactly
              tile the flat packed nnz set per block (multiset-exact),
              segment padding is zero, ``interior_mask`` agrees
  PLAN009     routing: the replayed content of every halo slot is
              exactly the vertex each packed edge expects (catches slot
              aliasing that is self-consistent enough to pass PLAN006/7)
  PLAN010     replan cache (plans built with ``cache=True``): the cached
              host CSR/bookkeeping agrees with the plan it claims to
              patch — same n/k/B, per-block nnz, sorted CSR keys, level
              offsets (a stale cache makes the *next*
              ``apply_edge_delta`` wrong, not this plan)
  PART001-3   a ``core.api.HierPartition``: vertex map in range, nested
              rectangular ancestor table, ``fanouts`` / ``lams``
              consistent (:func:`verify_partition`)
  ==========  ============================================================

All checks are vectorized NumPy — O(nnz + rounds) plus sorts — and never
index out of bounds on corrupted inputs (range guards first, dependent
checks skipped).  ``build_plan`` / ``build_plan_tree`` verify their host
arrays before any field is placed on a device
(``sparse.distributed._maybe_verify``), so a plan bound for the card is
never copied back to be checked; called on a placed
plan, :func:`verify_plan` copies each field it reads to the host.

Not ported: the reference's ``check_mesh_axes`` (MESH0xx), which checks a
plan's ``comm='hier'`` folding against a TPU device mesh's axis names and
sizes.  One GPU holding every PU has no mesh (ROADMAP.md, "Not ported, on
purpose"); the multi-process mode's per-level process groups (ROADMAP.md
queue 1 item 9) are its counterpart.  :func:`partner_table` is the
per-level partner table that check reported, in block indices.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import torch

from .diagnostics import Report


def _arr(a) -> np.ndarray:
    """A plan field as a host ndarray: a tensor is copied to the host (a
    CPU tensor shares its memory), anything else goes through
    ``np.asarray``."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu").numpy()
    return np.asarray(a)


# --------------------------------------------------------------------------
# plan normalization: flat DistPlan and TreePlan as one per-level view
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Level:
    nq: int                 # quotient node count (suffix size for trees)
    S: int                  # halo slots per round
    R: int                  # colored rounds
    send_idx: np.ndarray    # (k, R, S)
    send_mask: np.ndarray   # (k, R, S)
    perms: tuple            # per round: tuple of (src, dst) quotient pairs


def _is_tree(plan) -> bool:
    return bool(getattr(plan, "fanouts", ()))


def _tree_suffix(fanouts) -> list[int]:
    """suffix[l+1] = prod(fanouts[h-1-l:]) — level l's quotient range."""
    h = len(fanouts)
    suffix = [1] * (h + 1)
    for t in range(h - 1, -1, -1):
        suffix[h - 1 - t + 1] = suffix[h - 1 - t] * int(fanouts[t])
    return suffix


def _levels_of(plan, rep: Report) -> list[_Level] | None:
    """Per-level schedule views, or None when the schedule tuples are too
    malformed to interpret (the shape diagnostics are already in ``rep``)."""
    k = int(plan.k)
    if _is_tree(plan):
        fanouts = tuple(int(f) for f in plan.fanouts)
        h = len(fanouts)
        if int(np.prod(fanouts)) != k:
            rep.add("PLAN002", f"prod(fanouts)={int(np.prod(fanouts))} != "
                               f"k={k}", where="fanouts", fanouts=fanouts)
            return None
        tups = (plan.S_lvl, plan.n_rounds_lvl, plan.send_idx_lvl,
                plan.send_mask_lvl, plan.round_perms_lvl)
        if any(len(t) != h for t in tups):
            rep.add("PLAN002",
                    f"per-level tuples must all have h={h} entries; got "
                    f"lengths {tuple(len(t) for t in tups)} for (S_lvl, "
                    f"n_rounds_lvl, send_idx_lvl, send_mask_lvl, "
                    f"round_perms_lvl)", where="levels")
            return None
        suffix = _tree_suffix(fanouts)
        levels = []
        for l in range(h):
            levels.append(_Level(
                nq=suffix[l + 1], S=int(plan.S_lvl[l]),
                R=int(plan.n_rounds_lvl[l]),
                send_idx=_arr(plan.send_idx_lvl[l]),
                send_mask=_arr(plan.send_mask_lvl[l]),
                perms=tuple(plan.round_perms_lvl[l])))
        return levels
    return [_Level(nq=k, S=int(plan.S), R=int(plan.n_rounds),
                   send_idx=_arr(plan.send_idx),
                   send_mask=_arr(plan.send_mask),
                   perms=tuple(plan.round_perms))]


def _level_offsets(plan, levels: list[_Level]) -> np.ndarray:
    """(h+1,) slot-range boundaries; ``offs[0] == B`` (flat and tree)."""
    sizes = [lv.R * lv.S for lv in levels]
    return int(plan.B) + np.concatenate(
        [[0], np.cumsum(sizes)]).astype(np.int64)


# --------------------------------------------------------------------------
# individual passes
# --------------------------------------------------------------------------

def _check_metadata(plan, rep: Report) -> bool:
    k, B, n = int(plan.k), int(plan.B), int(plan.n)
    ok = True
    if k <= 0 or B <= 0 or n <= 0:
        rep.add("PLAN001", f"k={k}, B={B}, n={n} must be positive")
        return False
    sizes = _arr(plan.sizes)
    if sizes.shape != (k,):
        rep.add("PLAN001", f"sizes has shape {sizes.shape}, want ({k},)")
        return False
    if int(sizes.sum()) != n:
        rep.add("PLAN001", f"sizes sum to {int(sizes.sum())} != n={n}")
        ok = False
    if sizes.max(initial=0) > B:
        rep.add("PLAN001", f"max block size {int(sizes.max())} exceeds "
                           f"B={B}")
        ok = False
    perm = _arr(plan.perm)
    if perm.shape != (n,):
        rep.add("PLAN001", f"perm has shape {perm.shape}, want ({n},)")
        return ok and False
    blk, rank = perm // B, perm % B
    if perm.min(initial=0) < 0 or (blk >= k).any():
        rep.add("PLAN001", "perm contains padded ids outside [0, k*B)")
        ok = False
    elif (rank >= sizes[blk]).any():
        bad = int(np.flatnonzero(rank >= sizes[blk])[0])
        rep.add("PLAN001", f"perm[{bad}] addresses ghost row "
                           f"{int(rank[bad])} of block {int(blk[bad])} "
                           f"(size {int(sizes[blk[bad]])})")
        ok = False
    if len(np.unique(perm)) != n:
        rep.add("PLAN001", "perm is not injective (two vertices share a "
                           "padded id)")
        ok = False
    row_mask = _arr(plan.row_mask)
    want = (np.arange(B)[None, :] < sizes[:, None]).astype(row_mask.dtype)
    if row_mask.shape != (k, B) or not np.array_equal(row_mask, want):
        rep.add("PLAN001", "row_mask does not mark exactly the first "
                           "sizes[b] rows of each block")
        ok = False
    nnz_blk = getattr(plan, "nnz_blk", None)
    pack_blk = getattr(plan, "_pack_blk", None)
    if nnz_blk is not None and pack_blk is not None:
        have = np.bincount(_arr(pack_blk), minlength=k)
        if not np.array_equal(have, _arr(nnz_blk)):
            rep.add("PLAN001", "nnz_blk disagrees with the packed edge "
                               "ownership (_pack_blk)")
            ok = False
    return ok


def _check_level_structure(plan, levels: list[_Level],
                           rep: Report) -> bool:
    k = int(plan.k)
    ok = True
    for l, lv in enumerate(levels):
        where = f"level {l}"
        if lv.S < 1 or lv.R < 0:
            rep.add("PLAN002", f"S={lv.S} (want >= 1), R={lv.R} "
                               f"(want >= 0)", where=where)
            ok = False
            continue
        for name, arr in (("send_idx", lv.send_idx),
                          ("send_mask", lv.send_mask)):
            if arr.shape != (k, lv.R, lv.S):
                rep.add("PLAN002",
                        f"{name} has shape {arr.shape}, want "
                        f"({k}, {lv.R}, {lv.S})", where=where)
                ok = False
        if len(lv.perms) != lv.R:
            rep.add("PLAN002", f"round_perms has {len(lv.perms)} rounds, "
                               f"want R={lv.R}", where=where)
            ok = False
        if k % lv.nq:
            rep.add("PLAN002", f"quotient size {lv.nq} does not divide "
                               f"k={k}", where=where)
            ok = False
    if _is_tree(plan):
        anc = getattr(plan, "anc", None)
        h = len(levels)
        if anc is not None:
            anc = _arr(anc)
            suffix = _tree_suffix(plan.fanouts)
            dev = np.arange(k, dtype=np.int64)
            want = (np.stack([dev // suffix[h - 1 - t]
                              for t in range(h - 1)])
                    if h > 1 else np.zeros((0, k), np.int64))
            if anc.shape != want.shape or not np.array_equal(anc, want):
                rep.add("PLAN002", "ancestor table does not match the "
                                   "tree-major mixed radix of fanouts "
                                   f"{tuple(plan.fanouts)}", where="anc")
                ok = False
    return ok


def _check_rounds(levels: list[_Level], rep: Report) -> None:
    for l, lv in enumerate(levels):
        for c, pairs in enumerate(lv.perms[:lv.R]):
            where = f"level {l} round {c}"
            srcs = [a for a, _ in pairs]
            dsts = [b for _, b in pairs]
            bad = [p for p in pairs
                   if not (0 <= p[0] < lv.nq and 0 <= p[1] < lv.nq)]
            if bad:
                rep.add("PLAN004", f"pairs {bad} outside quotient range "
                                   f"[0, {lv.nq})", where=where)
            if any(a == b for a, b in pairs):
                rep.add("PLAN004", "self-pair (a, a) in ppermute round",
                        where=where)
            if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
                rep.add("PLAN004",
                        "round is not a permutation: duplicate source or "
                        "destination node (ppermute delivery is undefined)",
                        where=where, pairs=tuple(pairs))
                continue
            # matching on the undirected quotient graph = proper coloring
            und = {(min(a, b), max(a, b)) for a, b in pairs}
            touched: dict[int, tuple] = {}
            for e in und:
                for node in e:
                    if node in touched and touched[node] != e:
                        rep.add("PLAN003",
                                f"node {node} talks to two partners in one "
                                f"round ({touched[node]} and {e}) — the "
                                "edge coloring is not proper on the "
                                "quotient graph", where=where)
                        break
                    touched[node] = e
            asym = [(a, b) for a, b in pairs if (b, a) not in set(pairs)]
            if asym:
                rep.add("PLAN003", f"one-directional pairs {asym}: the "
                                   "exchange schedule must be "
                                   "bidirectional", where=where)


def _check_send_schedule(plan, levels: list[_Level], rep: Report) -> None:
    sizes = _arr(plan.sizes)
    for l, lv in enumerate(levels):
        if lv.send_idx.shape != (plan.k, lv.R, lv.S):
            continue                       # shape already diagnosed
        live = lv.send_mask > 0
        idx = lv.send_idx
        bad = live & ((idx < 0) | (idx >= sizes[:, None, None]))
        if bad.any():
            b, c, s = (int(x[0]) for x in np.nonzero(bad))
            rep.add("PLAN005",
                    f"block {b} sends local row {int(idx[b, c, s])} in "
                    f"round {c} slot {s}, but only {int(sizes[b])} rows "
                    "are real (ghost-row send)", where=f"level {l}",
                    count=int(bad.sum()))


def _replay(plan, levels: list[_Level], offs: np.ndarray, rep: Report):
    """Abstract replay of the comm schedule.

    Returns ``(content, writes)``: ``content[b, j]`` is the padded global
    id (blk*B + rank) of the vertex whose value position ``j`` of block
    ``b``'s extended vector holds after all rounds (-1 = never written),
    ``writes[b, j]`` how many masked sends were delivered there — the
    write-write race detector (PLAN006).
    """
    k, B = int(plan.k), int(plan.B)
    ext_len = int(offs[-1])
    content = np.full((k, ext_len), -1, dtype=np.int64)
    content[:, :B] = np.arange(k, dtype=np.int64)[:, None] * B + np.arange(B)
    writes = np.zeros((k, ext_len), dtype=np.int32)
    dev_base = np.arange(k, dtype=np.int64)[:, None] * B
    for l, lv in enumerate(levels):
        if (lv.send_idx.shape != (k, lv.R, lv.S) or k % lv.nq
                or len(lv.perms) < lv.R):
            continue                       # shape already diagnosed
        n_sub = k // lv.nq
        for c in range(lv.R):
            send_val = np.where(lv.send_mask[:, c] > 0,
                                dev_base + lv.send_idx[:, c], -1)
            lo = int(offs[l]) + c * lv.S
            for a, b in lv.perms[c]:
                if not (0 <= a < lv.nq and 0 <= b < lv.nq):
                    continue               # PLAN004 already flagged
                for p in range(n_sub):
                    src, dst = p * lv.nq + a, p * lv.nq + b
                    sv = send_val[src]
                    live = sv >= 0
                    writes[dst, lo:lo + lv.S] += live
                    content[dst, lo:lo + lv.S] = np.where(
                        live, sv, content[dst, lo:lo + lv.S])
    races = writes > 1
    if races.any():
        b, j = (int(x[0]) for x in np.nonzero(races))
        rep.add("PLAN006",
                f"halo slot {j} of block {b} is written "
                f"{int(writes[b, j])} times — write-write race on the "
                "comm schedule", count=int(races.sum()))
    return content, writes


def _check_reads(plan, offs: np.ndarray, writes: np.ndarray,
                 rep: Report) -> None:
    k, B = int(plan.k), int(plan.B)
    ext_len = int(offs[-1])
    cols = _arr(plan.cols)
    nnz_blk = _arr(plan.nnz_blk)
    valid = np.arange(cols.shape[1])[None, :] < nnz_blk[:, None]
    out = valid & ((cols < 0) | (cols >= ext_len))
    if out.any():
        b, e = (int(x[0]) for x in np.nonzero(out))
        rep.add("PLAN007", f"edge {e} of block {b} reads column "
                           f"{int(cols[b, e])}, outside the extended "
                           f"vector [0, {ext_len})", count=int(out.sum()))
    sizes = _arr(plan.sizes)
    ghost = valid & (cols >= 0) & (cols < B) & (cols >= sizes[:, None])
    if ghost.any():
        b, e = (int(x[0]) for x in np.nonzero(ghost))
        rep.add("PLAN007", f"edge {e} of block {b} reads local ghost row "
                           f"{int(cols[b, e])} (block has "
                           f"{int(sizes[b])} real rows)",
                count=int(ghost.sum()))
    halo = valid & (cols >= B) & (cols < ext_len)
    wr = writes[np.arange(k)[:, None], np.clip(cols, 0, ext_len - 1)]
    unread = halo & (wr == 0)
    if unread.any():
        b, e = (int(x[0]) for x in np.nonzero(unread))
        rep.add("PLAN007",
                f"edge {e} of block {b} reads halo slot "
                f"{int(cols[b, e])} which no round ever writes "
                "(read-before-write)", count=int(unread.sum()))


def _segments_of(plan):
    """(label, rows, cols, vals, class) per accumulation segment, where
    ``class`` is -1 for interior and the level index for boundary."""
    segs = [("interior", plan.rows_int, plan.cols_int, plan.vals_int, -1)]
    if _is_tree(plan):
        for l in range(len(plan.fanouts)):
            segs.append((f"boundary level {l}", plan.rows_bnd_lvl[l],
                         plan.cols_bnd_lvl[l], plan.vals_bnd_lvl[l], l))
    else:
        segs.append(("boundary", plan.rows_bnd, plan.cols_bnd,
                     plan.vals_bnd, 0))
    return segs


def _check_tiling(plan, offs: np.ndarray, rep: Report) -> None:
    """Interior + per-level boundary segments exactly tile the flat packed
    nnz set (PLAN008), and each segment reads only its own and faster
    levels' slot ranges (the read-ordering half of PLAN007)."""
    k, B = int(plan.k), int(plan.B)
    ext_len = int(offs[-1])
    rows_a = _arr(plan.rows)
    cols_a = _arr(plan.cols)
    vals_a = _arr(plan.vals)
    nnz_blk = _arr(plan.nnz_blk)
    valid = np.arange(rows_a.shape[1])[None, :] < nnz_blk[:, None]
    if (valid & ((rows_a < 0) | (rows_a >= B))).any():
        rep.add("PLAN008", "flat packed rows outside [0, B); skipping "
                           "segment tiling")
        return
    # per-edge slot level from the flat plan (-1 local), per-row class =
    # highest level read — the independent reconstruction the segments
    # are compared against
    edge_lvl = np.searchsorted(offs, np.clip(cols_a, 0, ext_len - 1),
                               side="right") - 1
    row_lvl = np.full((k, B), -1, dtype=np.int64)
    bi, ei = np.nonzero(valid)
    np.maximum.at(row_lvl, (bi, rows_a[bi, ei]), edge_lvl[bi, ei])
    row_lvl_of_edge = row_lvl[np.arange(k)[:, None], rows_a]

    segs = _segments_of(plan)
    for label, r, c, v, cls in segs:
        r, c, v = _arr(r), _arr(c), _arr(v)
        if r.shape[0] != k or c.shape != r.shape or v.shape != r.shape:
            rep.add("PLAN008", f"{label} segment arrays are mis-shaped "
                               f"({r.shape}, {c.shape}, {v.shape})")
            continue
        sel = valid & (row_lvl_of_edge == cls)
        counts = sel.sum(axis=1)
        if int(counts.max(initial=0)) > r.shape[1]:
            rep.add("PLAN008", f"{label} segment is narrower than its "
                               f"class ({r.shape[1]} < "
                               f"{int(counts.max())})")
            continue
        for b in range(k):
            cnt = int(counts[b])
            exp = np.stack([rows_a[b, sel[b]], cols_a[b, sel[b]],
                            vals_a[b, sel[b]].view(np.int32)])
            got = np.stack([r[b, :cnt], c[b, :cnt],
                            v[b, :cnt].view(np.int32)])
            exp = exp[:, np.lexsort(exp)]
            got = got[:, np.lexsort(got)]
            if not np.array_equal(exp, got):
                rep.add("PLAN008",
                        f"{label} segment of block {b} is not the "
                        "(row, col, val) multiset of the flat edges in "
                        "its class", where=f"block {b}")
                break
            if (r[b, cnt:].any() or c[b, cnt:].any() or v[b, cnt:].any()):
                rep.add("PLAN008", f"{label} segment of block {b} has "
                                   "nonzero padding beyond its class "
                                   f"count {cnt}", where=f"block {b}")
        # read-ordering: a class-`cls` row waits only on levels <= cls,
        # so any real read past offs[cls+1] races the slower exchange
        limit = int(offs[cls + 1])
        pos = np.arange(r.shape[1])[None, :] < counts[:, None]
        late = pos & (c >= limit)
        if late.any():
            b, e = (int(x[0]) for x in np.nonzero(late))
            rep.add("PLAN007",
                    f"{label} segment of block {b} reads column "
                    f"{int(c[b, e])} >= {limit}: the accumulation does "
                    "not wait for that level's exchange "
                    "(read-before-write)", count=int(late.sum()))
    interior_mask = _arr(plan.interior_mask)
    sizes = _arr(plan.sizes)
    want = ((np.arange(B)[None, :] < sizes[:, None]) & (row_lvl < 0))
    if not np.array_equal(interior_mask.astype(bool), want):
        rep.add("PLAN008", "interior_mask does not equal "
                           "row_mask AND (row reads no halo slot)")


def _check_routing(plan, offs: np.ndarray, content: np.ndarray,
                   rep: Report) -> None:
    pb = getattr(plan, "_pack_blk", None)
    pp = getattr(plan, "_pack_pos", None)
    pd = getattr(plan, "_pack_dst", None)
    if pb is None or pp is None or pd is None:
        rep.info["routing"] = ("skipped: plan carries no packed-edge "
                               "provenance (_pack_blk/_pack_pos/_pack_dst)")
        return
    k, B = int(plan.k), int(plan.B)
    ext_len = int(offs[-1])
    cols_a = _arr(plan.cols)
    pb, pp, pd = (_arr(a) for a in (pb, pp, pd))
    if (pb < 0).any() or (pb >= k).any() or (pp < 0).any() \
            or (pp >= cols_a.shape[1]).any():
        rep.add("PLAN001", "_pack_blk/_pack_pos address cells outside the "
                           "packed arrays")
        return
    col = cols_a[pb, pp]
    expect = _arr(plan.perm)[pd]
    local = (col >= 0) & (col < B)
    got = np.where(local, pb * B + col,
                   content[pb, np.clip(col, 0, ext_len - 1)])
    got = np.where((col < 0) | (col >= ext_len), -1, got)
    bad = got != expect
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        rep.add("PLAN009",
                f"edge {i} (block {int(pb[i])}, col {int(col[i])}) reads "
                f"padded id {int(got[i])} but its destination vertex "
                f"{int(pd[i])} lives at padded id {int(expect[i])} — "
                "mis-routed or aliased halo slot", count=int(bad.sum()))


def _check_replan_cache(plan, offs: np.ndarray, rep: Report) -> None:
    """Consistency of the incremental-replanning cache carried by plans
    built with ``cache=True`` (PLAN010).  The cache is host bookkeeping
    for :func:`repro_torch.sparse.replan.apply_edge_delta`; a mismatch would
    not make *this* plan wrong, but would corrupt the next patch."""
    cache = getattr(plan, "_replan", None)
    if cache is None:
        return
    n, k, B = int(plan.n), int(plan.k), int(plan.B)
    if (int(cache.n), int(cache.k), int(cache.B)) != (n, k, B):
        rep.add("PLAN010", f"cache (n, k, B)=({cache.n}, {cache.k}, "
                           f"{cache.B}) != plan ({n}, {k}, {B})",
                where="_replan")
        return
    if cache.nnz != int(_arr(plan.nnz_blk).sum()):
        rep.add("PLAN010", f"cache holds {cache.nnz} CSR entries; plan's "
                           f"nnz_blk sums to "
                           f"{int(_arr(plan.nnz_blk).sum())}",
                where="_replan")
    if not np.array_equal(cache.per_blk, _arr(plan.nnz_blk)):
        rep.add("PLAN010", "cache per_blk disagrees with plan nnz_blk",
                where="_replan")
    if cache.part.shape != (n,) or (cache.part.size and (
            cache.part.min() < 0 or cache.part.max() >= k)):
        rep.add("PLAN010", f"cache part shape {cache.part.shape} / values "
                           f"not a valid (n,) block map", where="_replan")
    if len(cache.keys) > 1 and not bool(np.all(np.diff(cache.keys) > 0)):
        rep.add("PLAN010", "cache CSR keys are not strictly increasing "
                           "(non-canonical CSR)", where="_replan")
    if not np.array_equal(cache.offs, offs):
        rep.add("PLAN010", f"cache level offsets {cache.offs.tolist()} != "
                           f"plan level offsets {offs.tolist()}",
                where="_replan")


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def verify_plan(plan) -> Report:
    """Run every structural pass over a ``DistPlan`` or ``TreePlan``.

    Pure host-side NumPy; accepts any object with the plan field contract
    (duck-typed: a port plan, the host arrays it is built from, or a reference
    plan verify identically).
    Returns a :class:`Report`; call ``.raise_for_errors()`` to turn
    violations into a :class:`PlanVerificationError`.
    """
    kind = "TreePlan" if _is_tree(plan) else "DistPlan"
    extra = (f", fanouts={tuple(plan.fanouts)}" if _is_tree(plan) else
             f", rounds={int(plan.n_rounds)}")
    rep = Report(subject=f"{kind}(k={plan.k}, B={plan.B}, n={plan.n}"
                         f"{extra})")
    if not _check_metadata(plan, rep):
        return rep
    levels = _levels_of(plan, rep)
    if levels is None:
        return rep
    structure_ok = _check_level_structure(plan, levels, rep)
    _check_rounds(levels, rep)
    _check_send_schedule(plan, levels, rep)
    offs = _level_offsets(plan, levels)
    content, writes = _replay(plan, levels, offs, rep)
    if structure_ok:
        _check_reads(plan, offs, writes, rep)
        _check_tiling(plan, offs, rep)
        _check_routing(plan, offs, content, rep)
    _check_replan_cache(plan, offs, rep)
    return rep


def verify_partition(res, n: int | None = None) -> Report:
    """Structural checks over a ``core.api.HierPartition`` (PART0xx):
    the vertex map is in range, the ancestor table is nested and
    rectangular, and ``fanouts``/``lams`` are mutually consistent."""
    part = _arr(res.part)
    k = int(res.k)
    rep = Report(subject=f"HierPartition(k={k}, "
                         f"fanouts={tuple(res.fanouts)})")
    if n is not None and part.shape != (n,):
        rep.add("PART001", f"part has shape {part.shape}, want ({n},)")
    if part.size and (part.min() < 0 or part.max() >= k):
        rep.add("PART001", f"part values outside [0, {k})")
    anc = _arr(res.anc)
    if anc.ndim != 2 or anc.shape[1] != k:
        rep.add("PART002", f"ancestor table has shape {anc.shape}, want "
                           f"(h-1, {k})")
        return rep
    fanouts = tuple(int(f) for f in res.fanouts)
    if int(np.prod(fanouts)) != k:
        rep.add("PART002", f"prod(fanouts)={int(np.prod(fanouts))} != "
                           f"k={k}")
    prev = np.zeros(k, dtype=np.int64)
    prev_c = 1
    for t in range(anc.shape[0]):
        row = anc[t]
        c = int(row.max()) + 1 if row.size else 1
        # nested: a level-t group has exactly one parent group
        parent_of = {}
        for g, p in zip(row.tolist(), prev.tolist()):
            if parent_of.setdefault(g, p) != p:
                rep.add("PART002", f"level row {t} is not nested under "
                                   f"row {t - 1} (group {g} has two "
                                   "parents)")
                break
        counts = np.bincount(row, minlength=c)
        if row.size and counts.min() != counts.max():
            rep.add("PART002", f"level row {t} groups blocks unequally "
                               f"({counts.min()}..{counts.max()}) — tree "
                               "meshes are rectangular")
        if c % prev_c:
            rep.add("PART002", f"level row {t} has {c} groups, not a "
                               f"multiple of the parent's {prev_c}")
        prev, prev_c = row, c
    lams = getattr(res, "lams", None)
    if lams is not None and len(lams) != len(fanouts):
        rep.add("PART003", f"{len(lams)} objective weights for a depth-"
                           f"{len(fanouts)} tree")
    return rep


def partner_table(plan) -> dict[int, list[list[tuple[int, int]]]]:
    """Per-level exchange partner table in *device* (leaf-linear) indices:
    ``table[level][round]`` lists every (src_dev, dst_dev) delivery,
    expanded over all subtrees sharing the suffix schedule."""
    rep = Report(subject="partner_table")
    levels = _levels_of(plan, rep)
    if levels is None:
        raise ValueError(str(rep))
    k = int(plan.k)
    table: dict[int, list[list[tuple[int, int]]]] = {}
    for l, lv in enumerate(levels):
        n_sub = max(k // lv.nq, 1)
        rounds = []
        for c in range(lv.R):
            pairs = []
            for a, b in lv.perms[c] if c < len(lv.perms) else ():
                for p in range(n_sub):
                    pairs.append((p * lv.nq + a, p * lv.nq + b))
            rounds.append(pairs)
        table[l] = rounds
    return table
