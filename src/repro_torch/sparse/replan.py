"""Incremental delta replanning — O(delta) patching of tree plans: the
host NumPy of ``src/repro/sparse/replan.py``, copied and bit-equal to it,
with the plan's changed arrays uploaded as tensors to the plan's device.

Time-stepping simulations and evolving graphs change a small fraction of
matrix entries per step; paying a full :func:`build_plan_tree` (O(nnz)
extraction, per-level Misra-Gries coloring, packing) for every step makes
plan construction the dominant cost of a streaming workload.  This module
patches an existing plan instead:

* the partition (``part``/``order``/``perm``) is reused unchanged, so no
  data movement of the solver state is needed;
* local COO segments are re-extracted only for *affected blocks* (blocks
  that gained or lost entries) — an existing entry's halo level never
  changes (it is a function of the owner/receiver pair only), so
  untouched blocks keep their packed layout byte-for-byte;
* halo slot maps are patched by searchsorted insert/remove over the
  sorted (receiver, vertex) triple keys, with reference counts so a slot
  dies only when its *last* external entry does;
* :func:`repro_torch.sparse.distributed._class_schedule` re-runs only on
  tree levels whose triple set changed — unchanged levels keep their send
  schedules and round permutations *by reference* (no host-to-device
  copy).

The contract is bit-level: ``apply_edge_delta(plan, delta)`` equals
``build_plan_tree`` on the merged CSR field by field.  ``validate=`` runs
the plan verifier (``repro_torch.analysis``) on the patched plan as
``build_plan_tree`` does: on its host arrays (the cache's mirrors),
before the changed arrays are uploaded.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _as_idx(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64).ravel())


@dataclasses.dataclass(frozen=True)
class EdgeDelta:
    """A batch of CSR entry mutations against an n x n matrix.

    ``set_*`` entries are upserts: an existing (row, col) entry gets the
    new value, a missing one is inserted.  ``drop_*`` entries must exist.
    Entries are stored sorted by ``row * n + col``; duplicate keys within
    a batch, or a key both set and dropped, are rejected — a delta is a
    set of final states, not an event log.
    """
    n: int
    set_rows: np.ndarray
    set_cols: np.ndarray
    set_vals: np.ndarray
    drop_rows: np.ndarray
    drop_cols: np.ndarray

    def __init__(self, n, set_rows=(), set_cols=(), set_vals=(),
                 drop_rows=(), drop_cols=()):
        sr, sc = _as_idx(set_rows), _as_idx(set_cols)
        sv = np.ascontiguousarray(np.asarray(set_vals, dtype=np.float64)
                                  .ravel())
        dr, dc = _as_idx(drop_rows), _as_idx(drop_cols)
        if not (len(sr) == len(sc) == len(sv)):
            raise ValueError("set_rows/set_cols/set_vals length mismatch")
        if len(dr) != len(dc):
            raise ValueError("drop_rows/drop_cols length mismatch")
        for a in (sr, sc, dr, dc):
            if len(a) and (a.min() < 0 or a.max() >= n):
                raise ValueError("entry index out of range [0, n)")
        n = int(n)
        sk = sr * n + sc
        dk = dr * n + dc
        o = np.argsort(sk)
        sk, sr, sc, sv = sk[o], sr[o], sc[o], sv[o]
        o = np.argsort(dk)
        dk, dr, dc = dk[o], dr[o], dc[o]
        if len(sk) > 1 and (np.diff(sk) == 0).any():
            raise ValueError("duplicate (row, col) in set entries")
        if len(dk) > 1 and (np.diff(dk) == 0).any():
            raise ValueError("duplicate (row, col) in drop entries")
        if len(sk) and len(dk) and np.intersect1d(sk, dk).size:
            raise ValueError("(row, col) both set and dropped")
        object.__setattr__(self, "n", n)
        object.__setattr__(self, "set_rows", sr)
        object.__setattr__(self, "set_cols", sc)
        object.__setattr__(self, "set_vals", sv)
        object.__setattr__(self, "drop_rows", dr)
        object.__setattr__(self, "drop_cols", dc)

    @property
    def set_keys(self) -> np.ndarray:
        return self.set_rows * self.n + self.set_cols

    @property
    def drop_keys(self) -> np.ndarray:
        return self.drop_rows * self.n + self.drop_cols

    @property
    def size(self) -> int:
        return len(self.set_rows) + len(self.drop_rows)

    def __len__(self) -> int:
        return self.size

    @classmethod
    def diff(cls, indptr_a, indices_a, data_a,
             indptr_b, indices_b, data_b) -> "EdgeDelta":
        """The delta turning canonical CSR A into canonical CSR B."""
        n = len(indptr_a) - 1
        if len(indptr_b) - 1 != n:
            raise ValueError("CSR shapes differ")
        ka = _csr_keys(indptr_a, indices_a, n)
        kb = _csr_keys(indptr_b, indices_b, n)
        da, db = np.asarray(data_a), np.asarray(data_b)
        pa = np.searchsorted(ka, kb)
        in_a = np.zeros(len(kb), dtype=bool)
        if len(ka):
            hit = pa < len(ka)
            in_a[hit] = ka[np.minimum(pa[hit], len(ka) - 1)] == kb[hit]
        changed = in_a.copy()
        if in_a.any():
            changed[in_a] = da[pa[in_a]] != db[in_a]
        set_m = changed | ~in_a
        pb = np.searchsorted(kb, ka)
        in_b = np.zeros(len(ka), dtype=bool)
        if len(kb):
            hit = pb < len(kb)
            in_b[hit] = kb[np.minimum(pb[hit], len(kb) - 1)] == ka[hit]
        drop_m = ~in_b
        return cls(n, set_rows=kb[set_m] // n, set_cols=kb[set_m] % n,
                   set_vals=db[set_m],
                   drop_rows=ka[drop_m] // n, drop_cols=ka[drop_m] % n)


def _csr_keys(indptr, indices, n: int) -> np.ndarray:
    indptr = np.asarray(indptr)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    return src * n + np.asarray(indices, dtype=np.int64)


@dataclasses.dataclass
class _Merge:
    """Result of merging an :class:`EdgeDelta` into a canonical CSR.

    Kept entries are moved with boolean-mask compress/expand (``keep`` on
    the old side, ``keep_new`` on the new side) — measurably faster than
    integer fancy indexing at production nnz.
    """
    structural: bool
    indptr2: np.ndarray
    indices2: np.ndarray
    data2: np.ndarray
    keys2: np.ndarray
    rw_pos: np.ndarray       # old-CSR positions of reweighted entries
    rw_vals: np.ndarray      # new values, already cast to data.dtype
    del_pos: np.ndarray      # old-CSR positions removed (sorted)
    ins_keys: np.ndarray     # inserted keys (sorted)
    ins_rows: np.ndarray
    ins_cols: np.ndarray
    keep: np.ndarray | None      # (nnz,) bool: old entries kept
    keep_new: np.ndarray | None  # (nnz2,) bool: new positions of kept
    new_pos_ins: np.ndarray   # inserted entries' positions in the new CSR


def _find_sorted(haystack: np.ndarray, needles: np.ndarray):
    """(positions, found-mask) of ``needles`` in sorted ``haystack``."""
    pos = np.searchsorted(haystack, needles)
    found = np.zeros(len(needles), dtype=bool)
    if len(haystack):
        hit = pos < len(haystack)
        found[hit] = haystack[np.minimum(pos[hit], len(haystack) - 1)] \
            == needles[hit]
    return pos, found


def _merge_csr(indptr, indices, data, keys, delta: EdgeDelta) -> _Merge:
    n = len(indptr) - 1
    nnz = len(keys)
    sk = delta.set_keys
    pos, found = _find_sorted(keys, sk)
    rw_pos = pos[found]
    rw_vals = delta.set_vals[found].astype(data.dtype)
    ins_m = ~found
    ins_keys = sk[ins_m]
    ins_rows = delta.set_rows[ins_m]
    ins_cols = delta.set_cols[ins_m]
    dpos, dfound = _find_sorted(keys, delta.drop_keys)
    if not dfound.all():
        bad = np.flatnonzero(~dfound)[0]
        raise KeyError(
            f"drop entry ({delta.drop_rows[bad]}, {delta.drop_cols[bad]}) "
            "not present in the matrix")
    structural = bool(len(ins_keys) or len(dpos))
    if not structural:
        data2 = data.copy()
        data2[rw_pos] = rw_vals
        return _Merge(False, indptr, indices, data2, keys,
                      rw_pos, rw_vals, dpos, ins_keys, ins_rows, ins_cols,
                      None, None, np.zeros(0, dtype=np.int64))

    keep = np.ones(nnz, dtype=bool)
    keep[dpos] = False
    key_kept = keys[keep]
    new_pos_ins = (np.searchsorted(key_kept, ins_keys)
                   + np.arange(len(ins_keys), dtype=np.int64))
    nnz2 = len(key_kept) + len(ins_keys)
    keep_new = np.ones(nnz2, dtype=bool)
    keep_new[new_pos_ins] = False
    indices2 = np.empty(nnz2, dtype=np.asarray(indices).dtype)
    indices2[keep_new] = np.asarray(indices)[keep]
    indices2[new_pos_ins] = ins_cols.astype(indices2.dtype)
    data2 = np.empty(nnz2, dtype=data.dtype)
    data2[keep_new] = data[keep]
    data2[new_pos_ins] = delta.set_vals[ins_m].astype(data.dtype)
    keys2 = np.empty(nnz2, dtype=np.int64)
    keys2[keep_new] = key_kept
    keys2[new_pos_ins] = ins_keys
    if len(rw_pos):
        data2[np.searchsorted(keys2, keys[rw_pos])] = rw_vals
    deg2 = (np.diff(indptr)
            - np.bincount(keys[dpos] // n, minlength=n)
            + np.bincount(ins_rows, minlength=n))
    indptr2 = np.zeros(n + 1, dtype=np.asarray(indptr).dtype)
    indptr2[1:] = np.cumsum(deg2)
    return _Merge(True, indptr2, indices2, data2, keys2,
                  rw_pos, rw_vals, dpos, ins_keys, ins_rows, ins_cols,
                  keep, keep_new, new_pos_ins)


def apply_delta_csr(indptr, indices, data, delta: EdgeDelta):
    """Apply a delta to a canonical CSR; returns (indptr, indices, data).

    Standalone (no plan needed) — this is what the serving layer uses to
    form the mutated matrix whose fingerprint keys the patched operator.
    """
    n = len(indptr) - 1
    if delta.n != n:
        raise ValueError(f"delta is for n={delta.n}, matrix has n={n}")
    keys = _csr_keys(indptr, indices, n)
    m = _merge_csr(np.asarray(indptr), np.asarray(indices),
                   np.asarray(data), keys, delta)
    return m.indptr2, m.indices2, m.data2


@dataclasses.dataclass
class ReplanCache:
    """Host-side intermediates of one :func:`build_plan_tree` run.

    Everything :func:`apply_edge_delta` needs to rebuild *only* what a
    delta touches.  Arrays are the builder's own (shared, not copied);
    patched caches share unchanged arrays with their predecessor.
    """
    # canonical CSR of the planned matrix + its sorted entry keys
    n: int
    k: int
    B: int
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    keys: np.ndarray            # row * n + col, strictly increasing
    # layout (partition is reused across patches)
    part: np.ndarray            # relabeled, tree-major
    order: np.ndarray
    rank_in_block: np.ndarray
    sizes: np.ndarray
    vstarts: np.ndarray         # (k+1,) vertex range of each block in order
    fanouts: tuple
    suffix: tuple
    row_mask: np.ndarray
    # per-CSR-entry packing coordinates
    own: np.ndarray             # owner block (== plan._pack_blk)
    pos_edge: np.ndarray        # packed position (== plan._pack_pos)
    # halo triples in canonical (pair, vertex) order
    t_pair: np.ndarray          # recv * k + own
    t_v: np.ndarray
    t_lvl: np.ndarray
    rel_slot: np.ndarray        # slot within the level (color * S + pos)
    cnt: np.ndarray             # external entries referencing each triple
    rv_keys: np.ndarray         # sorted recv * n + v
    rv_trip: np.ndarray         # sorted position -> triple index
    offs: np.ndarray            # (h+1,) level slot boundaries, offs[0]==B
    # packed local COO (host mirrors of the plan's device arrays)
    rows_a: np.ndarray
    cols_a: np.ndarray
    vals_a: np.ndarray
    per_blk: np.ndarray
    # per-external-entry halo bookkeeping
    ext_blk: np.ndarray
    ext_pos: np.ndarray
    ext_trip: np.ndarray
    # segment bookkeeping (from _derive_tree_fields_np)
    seg_lvl: np.ndarray         # -2 pad, -1 interior, l boundary level
    seg_pos: np.ndarray
    seg_counts: np.ndarray      # (h+1, k)
    row_lvl: np.ndarray
    int_seg: tuple
    lvl_segs: list
    diag: np.ndarray
    diag_b: np.ndarray
    diag_e: np.ndarray
    diag_row: np.ndarray        # rows_a[diag_b, diag_e], precomputed
    # host mirrors of the per-level send schedules (what the verifier
    # reads, so a plan on the card is checked without copying it back)
    send_idx_lvl: tuple = ()
    send_mask_lvl: tuple = ()

    @property
    def h(self) -> int:
        return len(self.offs) - 1

    @property
    def nnz(self) -> int:
        return len(self.keys)


def capture_replan_cache(*, indptr, indices, data, src, part, order,
                         rank_in_block, sizes, B, k, n, fanouts, suffix,
                         flat, o2, ext, ext_keys, psrc, t_pair, t_v, t_lvl,
                         slot_of_trip, offs, rows_a, cols_a, vals_a,
                         per_blk, pos_edge, row_mask, host, send_idx_lvl,
                         send_mask_lvl):
    """Build a :class:`ReplanCache` from ``build_plan_tree`` internals.

    Returns None for a non-canonical CSR (unsorted or duplicate entries
    within a row) — such matrices can still be planned, just not patched.
    """
    keys = src.astype(np.int64) * n + np.asarray(indices, dtype=np.int64)
    if len(keys) > 1 and not (np.diff(keys) > 0).all():
        return None
    # triple index at each sorted-(recv, v) position: o2 maps triple t to
    # its pre-sort position, so the inverse permutation is the lookup
    rv_trip = np.empty(len(o2), dtype=np.int64)
    rv_trip[o2] = np.arange(len(o2), dtype=np.int64)
    rv_keys = flat.astype(np.int64)
    p_ext = np.searchsorted(rv_keys, ext_keys.astype(np.int64))
    cnt = np.bincount(p_ext, minlength=len(rv_keys)).astype(np.int64)[o2]
    ext_idx = np.flatnonzero(ext)
    rel_slot = (slot_of_trip - offs[t_lvl]).astype(np.int32)
    vstarts = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(sizes, out=vstarts[1:])
    return ReplanCache(
        n=n, k=k, B=B,
        indptr=np.asarray(indptr), indices=np.asarray(indices),
        data=np.asarray(data), keys=keys,
        part=part, order=order, rank_in_block=rank_in_block,
        sizes=sizes, vstarts=vstarts,
        fanouts=tuple(fanouts), suffix=tuple(suffix), row_mask=row_mask,
        own=psrc, pos_edge=pos_edge,
        t_pair=t_pair, t_v=t_v, t_lvl=t_lvl, rel_slot=rel_slot, cnt=cnt,
        rv_keys=rv_keys, rv_trip=rv_trip, offs=np.asarray(offs),
        rows_a=rows_a, cols_a=cols_a, vals_a=vals_a, per_blk=per_blk,
        ext_blk=psrc[ext_idx], ext_pos=pos_edge[ext_idx],
        ext_trip=rv_trip[p_ext],
        seg_lvl=host["seg_lvl"], seg_pos=host["seg_pos"],
        seg_counts=host["seg_counts"], row_lvl=host["row_lvl"],
        int_seg=host["int_seg"], lvl_segs=list(host["lvl_segs"]),
        diag=host["diag"], diag_b=host["diag_b"], diag_e=host["diag_e"],
        diag_row=rows_a[host["diag_b"], host["diag_e"]],
        send_idx_lvl=tuple(send_idx_lvl), send_mask_lvl=tuple(send_mask_lvl),
    )


def _host_fields(plan, cache: ReplanCache, S_lvl, n_rounds_lvl,
                 round_perms_lvl) -> dict:
    """The patched plan's fields as the host arrays ``cache`` mirrors —
    what :func:`.distributed._maybe_verify` checks before the upload."""
    int_r, int_c, int_v = cache.int_seg
    return dict(
        k=plan.k, B=plan.B, n=plan.n, S=max(S_lvl),
        n_rounds=sum(n_rounds_lvl), perm=plan.perm, sizes=plan.sizes,
        nnz_blk=cache.per_blk, rows=cache.rows_a, cols=cache.cols_a,
        vals=cache.vals_a, row_mask=cache.row_mask,
        interior_mask=cache.row_mask * ~(cache.row_lvl >= 0),
        rows_int=int_r, cols_int=int_c, vals_int=int_v,
        rows_bnd_lvl=tuple(seg[0] for seg in cache.lvl_segs),
        cols_bnd_lvl=tuple(seg[1] for seg in cache.lvl_segs),
        vals_bnd_lvl=tuple(seg[2] for seg in cache.lvl_segs),
        fanouts=plan.fanouts, anc=plan.anc, S_lvl=tuple(S_lvl),
        n_rounds_lvl=tuple(n_rounds_lvl),
        send_idx_lvl=cache.send_idx_lvl, send_mask_lvl=cache.send_mask_lvl,
        round_perms_lvl=tuple(round_perms_lvl), _pack_blk=cache.own,
        _pack_pos=cache.pos_edge, _pack_dst=cache.indices, _replan=cache)


def _recompute_diag_rows(diag2, cache, blk, row, vals_host):
    """Zero + re-accumulate the diagonal of the given (block, row) pairs
    in the fresh builder's np.add.at order (order matters bit-for-bit
    when a row has several diagonal-hitting entries)."""
    aff = np.zeros(diag2.shape, dtype=bool)
    aff[blk, row] = True
    sel = aff[cache.diag_b, cache.diag_row]
    db, de = cache.diag_b[sel], cache.diag_e[sel]
    diag2[blk, row] = 0.0
    np.add.at(diag2, (db, cache.diag_row[sel]), vals_host[db, de])


def _patch_values(plan, cache: ReplanCache, m: _Merge, validate):
    """Reweight-only fast path: no structure changed, so every packed
    position, slot map, schedule and segment layout is reused; only the
    value arrays (and the diagonal rows hit) are patched."""
    from .distributed import _maybe_verify, _tensor

    def upload(a):
        return _tensor(a, plan.device)

    rw32 = m.rw_vals.astype(np.float32)
    blk = cache.own[m.rw_pos]
    pos = cache.pos_edge[m.rw_pos]
    vals_a = cache.vals_a.copy()
    vals_a[blk, pos] = rw32

    slvl = cache.seg_lvl[blk, pos]
    spos = cache.seg_pos[blk, pos]
    int_r, int_c, int_v = cache.int_seg
    int_hit = (slvl == -1).any()
    if int_hit:
        sel = slvl == -1
        int_v = int_v.copy()
        int_v[blk[sel], spos[sel]] = rw32[sel]
    lvl_segs2, lvl_hit = [], []
    for l, (r_, c_, v_) in enumerate(cache.lvl_segs):
        sel = slvl == l
        lvl_hit.append(bool(sel.any()))
        if lvl_hit[-1]:
            v_ = v_.copy()
            v_[blk[sel], spos[sel]] = rw32[sel]
        lvl_segs2.append((r_, c_, v_))

    diag2 = cache.diag
    is_diag = (cache.keys[m.rw_pos] % cache.n
               == cache.keys[m.rw_pos] // cache.n)
    if is_diag.any():
        diag2 = diag2.copy()
        _recompute_diag_rows(diag2, cache, blk[is_diag],
                             cache.rows_a[blk[is_diag], pos[is_diag]],
                             vals_a)

    cache2 = dataclasses.replace(
        cache, data=m.data2, vals_a=vals_a,
        int_seg=(int_r, int_c, int_v), lvl_segs=lvl_segs2, diag=diag2)
    report = _maybe_verify(_host_fields(plan, cache2, plan.S_lvl,
                                        plan.n_rounds_lvl,
                                        plan.round_perms_lvl), validate)
    vals_int_j = upload(int_v) if int_hit else plan.vals_int
    vals_bnd_j = [upload(seg[2]) if hit else old for seg, hit, old in
                  zip(lvl_segs2, lvl_hit, plan.vals_bnd_lvl)]
    diag_j = upload(diag2) if is_diag.any() else plan.diag
    out = dataclasses.replace(
        plan, vals=upload(vals_a), vals_int=vals_int_j,
        vals_bnd_lvl=tuple(vals_bnd_j), diag=diag_j,
        _bell={}, _bj_inv=None, _replan=cache2)
    out.verify_report = report
    return out


def _patch_structure(plan, cache: ReplanCache, m: _Merge, validate):
    """Insert/remove path.  Work scales with the delta plus the size of
    the *affected blocks* (blocks that gained or lost entries) plus a few
    O(nnz) memcpy/scatter passes — never with a full re-extraction."""
    from .distributed import (_class_schedule, _derive_tree_fields_np,
                              _maybe_verify, _tensor)

    def upload(a):
        return _tensor(a, plan.device)

    n, k, B, h = cache.n, cache.k, cache.B, cache.h
    suffix = cache.suffix

    # ---- per-entry owner/position bookkeeping in the new CSR ------------
    nnz2 = len(m.keys2)
    del_own = cache.own[m.del_pos]
    del_dst = cache.indices[m.del_pos]
    ins_own = cache.part[m.ins_rows]
    ins_dst = m.ins_cols
    own2 = np.empty(nnz2, dtype=np.int32)
    own2[m.keep_new] = cache.own[m.keep]
    own2[m.new_pos_ins] = ins_own
    per_blk2 = (cache.per_blk
                - np.bincount(del_own, minlength=k)
                + np.bincount(ins_own, minlength=k))
    aff_mask = np.zeros(k, dtype=bool)
    aff_mask[del_own] = True
    aff_mask[ins_own] = True
    aff = np.flatnonzero(aff_mask)
    pos_edge2 = np.empty(nnz2, dtype=np.int64)
    pos_edge2[m.keep_new] = cache.pos_edge[m.keep]
    pos_edge2[m.new_pos_ins] = 0      # rebuilt below (A blocks only)

    # ---- triple ref-counts: remove / insert external entries ------------
    cnt2 = cache.cnt.copy()
    d_ext = cache.part[del_dst] != del_own
    if d_ext.any():
        dk_rv = del_own[d_ext].astype(np.int64) * n + del_dst[d_ext]
        p_del = np.searchsorted(cache.rv_keys, dk_rv)
        np.subtract.at(cnt2, cache.rv_trip[p_del], 1)
    i_ext = cache.part[ins_dst] != ins_own
    new_rv = np.zeros(0, dtype=np.int64)
    new_rv_cnt = np.zeros(0, dtype=np.int64)
    if i_ext.any():
        ik_rv = ins_own[i_ext].astype(np.int64) * n + ins_dst[i_ext]
        p_ins, found = _find_sorted(cache.rv_keys, ik_rv)
        if found.any():
            np.add.at(cnt2, cache.rv_trip[p_ins[found]], 1)
        new_rv, new_rv_cnt = np.unique(ik_rv[~found], return_counts=True)

    keep_t = cnt2 > 0
    old_idx = np.flatnonzero(keep_t)
    drop_lvls = cache.t_lvl[np.flatnonzero(~keep_t)]

    # ---- merged triple list, canonical (pair, vertex) order -------------
    nv = new_rv % n
    nrecv = new_rv // n
    nown = cache.part[nv].astype(np.int64)
    npair = nrecv * k + nown
    ordn = np.argsort(npair * n + nv, kind="stable")
    nv, nrecv, npair = nv[ordn], nrecv[ordn], npair[ordn]
    ncnt = new_rv_cnt[ordn].astype(np.int64)
    nlvl = np.zeros(len(nv), dtype=np.int64)
    for l in range(h):
        differ = (nrecv // suffix[l]) != (npair % k) // suffix[l]
        nlvl = np.where(differ, l, nlvl)

    old_pv = cache.t_pair[old_idx] * n + cache.t_v[old_idx]
    new_pv = npair * n + nv
    pos_old = (np.arange(len(old_idx), dtype=np.int64)
               + np.searchsorted(new_pv, old_pv))
    pos_new = (np.searchsorted(old_pv, new_pv)
               + np.arange(len(new_pv), dtype=np.int64))
    T2 = len(old_idx) + len(new_pv)

    def merge_t(old_vals, new_vals, dtype):
        out = np.empty(T2, dtype=dtype)
        out[pos_old] = old_vals
        out[pos_new] = new_vals
        return out

    t_pair2 = merge_t(cache.t_pair[old_idx], npair, np.int64)
    t_v2 = merge_t(cache.t_v[old_idx], nv, np.int64)
    t_lvl2 = merge_t(cache.t_lvl[old_idx], nlvl, np.int64)
    cnt3 = merge_t(cnt2[old_idx], ncnt, np.int64)
    old_to_new = np.full(len(cache.t_pair), -1, dtype=np.int64)
    old_to_new[old_idx] = pos_old

    # ---- reschedule only levels whose triple set changed ----------------
    changed_lvls = np.unique(np.concatenate([drop_lvls, nlvl]))
    S_lvl2 = list(plan.S_lvl)
    R_lvl2 = list(plan.n_rounds_lvl)
    si_h = list(cache.send_idx_lvl)
    sm_h = list(cache.send_mask_lvl)
    perms2 = list(plan.round_perms_lvl)
    rel_slot2 = np.empty(T2, dtype=np.int32)
    rel_slot2[pos_old] = cache.rel_slot[old_idx]
    rel_slot2[pos_new] = 0
    dev = np.arange(k, dtype=np.int64)
    for l in changed_lvls.tolist():
        sel = t_lvl2 == l
        sz = suffix[l + 1]
        S_l, R_l, si, sm, perms, slot = _class_schedule(
            t_pair2[sel], t_v2[sel], k, dev % sz, sz, cache.rank_in_block)
        rel_slot2[sel] = slot
        S_lvl2[l], R_lvl2[l] = S_l, R_l
        si_h[l], sm_h[l] = si, sm
        perms2[l] = perms
    offs2 = B + np.concatenate(
        [[0], np.cumsum([r * s for r, s in zip(R_lvl2, S_lvl2)])]).astype(int)
    slot_abs2 = (offs2[t_lvl2] + rel_slot2).astype(np.int32)
    slots_moved = len(changed_lvls) > 0

    # new sorted-(recv, v) lookup
    rvk_all = (t_pair2 // k) * n + t_v2
    ord_rv = np.argsort(rvk_all)
    rv_keys2, rv_trip2 = rvk_all[ord_rv], ord_rv

    # ---- packed COO: copy, zero affected blocks, patch the rest ---------
    nnz_pad2 = max(int(per_blk2.max()) if k else 1, 1)
    w = min(cache.rows_a.shape[1], nnz_pad2)
    rows_a2 = np.zeros((k, nnz_pad2), dtype=np.int32)
    cols_a2 = np.zeros((k, nnz_pad2), dtype=np.int32)
    vals_a2 = np.zeros((k, nnz_pad2), dtype=np.float32)
    rows_a2[:, :w] = cache.rows_a[:, :w]
    cols_a2[:, :w] = cache.cols_a[:, :w]
    vals_a2[:, :w] = cache.vals_a[:, :w]
    rows_a2[aff] = 0
    cols_a2[aff] = 0
    vals_a2[aff] = 0

    rw_blk = cache.own[m.rw_pos]
    rw_p = cache.pos_edge[m.rw_pos]
    rw32 = m.rw_vals.astype(np.float32)
    nm = ~aff_mask[rw_blk]             # reweights in untouched blocks
    vals_a2[rw_blk[nm], rw_p[nm]] = rw32[nm]

    keep_ext = ~aff_mask[cache.ext_blk]
    kext_trip = old_to_new[cache.ext_trip[keep_ext]]
    if slots_moved and keep_ext.any():
        cols_a2[cache.ext_blk[keep_ext], cache.ext_pos[keep_ext]] = \
            slot_abs2[kext_trip]

    # ---- rebuild affected blocks from the new CSR -----------------------
    verts = np.concatenate(
        [cache.order[cache.vstarts[b]:cache.vstarts[b + 1]] for b in aff]
        or [np.zeros(0, dtype=np.int64)])
    deg2 = np.diff(m.indptr2)
    dv = deg2[verts]
    tot = int(dv.sum())
    e_start = np.cumsum(dv) - dv
    e_idx = (np.repeat(np.asarray(m.indptr2, dtype=np.int64)[verts], dv)
             + (np.arange(tot, dtype=np.int64) - np.repeat(e_start, dv)))
    blk_rep = np.repeat(cache.part[verts], dv)
    per_aff = per_blk2[aff]
    blk_e_start = np.cumsum(per_aff) - per_aff
    pos_rep = (np.arange(tot, dtype=np.int64)
               - np.repeat(blk_e_start, per_aff))
    rows_loc = cache.rank_in_block[np.repeat(verts, dv)]
    dst_e = np.asarray(m.indices2)[e_idx]
    cols_loc = cache.rank_in_block[dst_e].astype(np.int32)
    ext_e = cache.part[dst_e] != blk_rep
    trip_e = np.zeros(0, dtype=np.int64)
    if ext_e.any():
        rvk = blk_rep[ext_e].astype(np.int64) * n + dst_e[ext_e]
        trip_e = rv_trip2[np.searchsorted(rv_keys2, rvk)]
        cols_loc[ext_e] = slot_abs2[trip_e]
    rows_a2[blk_rep, pos_rep] = rows_loc
    cols_a2[blk_rep, pos_rep] = cols_loc
    vals_a2[blk_rep, pos_rep] = np.asarray(m.data2)[e_idx]
    pos_edge2[e_idx] = pos_rep

    ext_blk2 = np.concatenate([cache.ext_blk[keep_ext], blk_rep[ext_e]])
    ext_pos2 = np.concatenate([cache.ext_pos[keep_ext], pos_rep[ext_e]])
    ext_trip2 = np.concatenate([kext_trip, trip_e])

    # ---- segments: re-derive affected blocks, merge with the rest -------
    sub = _derive_tree_fields_np(rows_a2[aff], cols_a2[aff], vals_a2[aff],
                                 per_blk2[aff], B, offs2)
    seg_counts2 = cache.seg_counts.copy()
    seg_counts2[:, aff] = sub["seg_counts"]
    pads = np.maximum(seg_counts2.max(axis=1), 1).astype(np.int64)

    sw = cache.seg_lvl.shape[1]
    seg_lvl2 = np.full((k, nnz_pad2), -2, dtype=np.int8)
    seg_lvl2[:, :min(sw, nnz_pad2)] = cache.seg_lvl[:, :min(sw, nnz_pad2)]
    seg_pos2 = np.zeros((k, nnz_pad2), dtype=np.int32)
    seg_pos2[:, :min(sw, nnz_pad2)] = cache.seg_pos[:, :min(sw, nnz_pad2)]
    subw = sub["seg_lvl"].shape[1]
    seg_lvl2[aff] = -2
    seg_lvl2[aff, :subw] = sub["seg_lvl"]
    seg_pos2[aff] = 0
    seg_pos2[aff, :subw] = sub["seg_pos"]
    row_lvl2 = cache.row_lvl.copy()
    row_lvl2[aff] = sub["row_lvl"]

    def merge_seg(old_seg, sub_seg, pad2):
        out = []
        for o_, s_ in zip(old_seg, sub_seg):
            a = np.zeros((k, pad2), dtype=o_.dtype)
            wc = min(o_.shape[1], pad2)
            a[:, :wc] = o_[:, :wc]
            a[aff] = 0
            a[aff, :s_.shape[1]] = s_
            out.append(a)
        return out

    int_seg2 = merge_seg(cache.int_seg, sub["int_seg"], int(pads[0]))
    lvl_segs2 = [merge_seg(cache.lvl_segs[l], sub["lvl_segs"][l],
                           int(pads[l + 1])) for l in range(h)]

    # untouched blocks: patch reweighted values / moved halo slots into
    # the merged segments at their cached (segment, position) coordinates
    def seg_scatter(seg_arrays, which, blk, pos, val):
        s_of = cache.seg_lvl[blk, pos]
        s_pos = cache.seg_pos[blk, pos]
        sel = s_of == -1
        if sel.any():
            int_seg2[which][blk[sel], s_pos[sel]] = val[sel]
        for l in range(h):
            sel = s_of == l
            if sel.any():
                lvl_segs2[l][which][blk[sel], s_pos[sel]] = val[sel]
        del seg_arrays

    if nm.any():
        seg_scatter(None, 2, rw_blk[nm], rw_p[nm], rw32[nm])
    if slots_moved and keep_ext.any():
        seg_scatter(None, 1, cache.ext_blk[keep_ext],
                    cache.ext_pos[keep_ext],
                    slot_abs2[kext_trip])

    # ---- diagonal -------------------------------------------------------
    diag2 = cache.diag.copy()
    diag2[aff] = sub["diag"]
    is_diag = nm & (cache.keys[m.rw_pos] % n == cache.keys[m.rw_pos] // n)
    if is_diag.any():
        _recompute_diag_rows(diag2, cache, rw_blk[is_diag],
                             cache.rows_a[rw_blk[is_diag], rw_p[is_diag]],
                             vals_a2)
    keep_d = ~aff_mask[cache.diag_b]
    db2 = np.concatenate([cache.diag_b[keep_d], aff[sub["diag_b"]]])
    de2 = np.concatenate([cache.diag_e[keep_d], sub["diag_e"]])
    o = np.lexsort((de2, db2))
    db2, de2 = db2[o], de2[o]
    diag_row2 = rows_a2[db2, de2]

    bnd_row2 = row_lvl2 >= 0
    interior_mask2 = cache.row_mask * ~bnd_row2

    cache2 = dataclasses.replace(
        cache,
        indptr=m.indptr2, indices=m.indices2, data=m.data2, keys=m.keys2,
        own=own2, pos_edge=pos_edge2, per_blk=per_blk2,
        t_pair=t_pair2, t_v=t_v2, t_lvl=t_lvl2, rel_slot=rel_slot2,
        cnt=cnt3, rv_keys=rv_keys2, rv_trip=rv_trip2, offs=offs2,
        rows_a=rows_a2, cols_a=cols_a2, vals_a=vals_a2,
        ext_blk=ext_blk2, ext_pos=ext_pos2, ext_trip=ext_trip2,
        seg_lvl=seg_lvl2, seg_pos=seg_pos2, seg_counts=seg_counts2,
        row_lvl=row_lvl2, int_seg=tuple(int_seg2),
        lvl_segs=[tuple(s) for s in lvl_segs2],
        diag=diag2, diag_b=db2, diag_e=de2, diag_row=diag_row2,
        send_idx_lvl=tuple(si_h), send_mask_lvl=tuple(sm_h))
    report = _maybe_verify(_host_fields(plan, cache2, S_lvl2, R_lvl2,
                                        perms2), validate)

    changed = set(changed_lvls.tolist())
    si2 = [upload(si_h[l]) if l in changed else plan.send_idx_lvl[l]
           for l in range(h)]
    sm2 = [upload(sm_h[l]) if l in changed else plan.send_mask_lvl[l]
           for l in range(h)]
    out = dataclasses.replace(
        plan,
        S=max(S_lvl2), n_rounds=sum(R_lvl2),
        rows=upload(rows_a2), cols=upload(cols_a2),
        vals=upload(vals_a2),
        rows_int=upload(int_seg2[0]),
        cols_int=upload(int_seg2[1]),
        vals_int=upload(int_seg2[2]),
        rows_bnd_lvl=tuple(upload(s[0]) for s in lvl_segs2),
        cols_bnd_lvl=tuple(upload(s[1]) for s in lvl_segs2),
        vals_bnd_lvl=tuple(upload(s[2]) for s in lvl_segs2),
        diag=upload(diag2), nnz_blk=per_blk2.copy(),
        interior_mask=upload(interior_mask2),
        S_lvl=tuple(S_lvl2), n_rounds_lvl=tuple(R_lvl2),
        send_idx_lvl=tuple(si2), send_mask_lvl=tuple(sm2),
        round_perms_lvl=tuple(perms2),
        _pack_blk=own2, _pack_pos=pos_edge2, _pack_dst=m.indices2,
        _cols_global=None, _bell={}, _bj_inv=None, _replan=cache2)
    out.verify_report = report
    return out


def apply_edge_delta(plan, delta: EdgeDelta, validate=None):
    """Patch ``plan`` (a cached :class:`TreePlan`) for ``delta``.

    Returns a new plan bit-equal to ``build_plan_tree`` on the merged
    CSR with the same partition/tree, on the plan's device.  Reweight-only
    deltas touch O(delta) entries plus a few value-array memcpys and
    uploads; structural deltas re-extract only the blocks that gained/lost
    entries and re-color only the tree levels whose halo triple set
    changed.  ``validate`` as in ``build_plan_tree`` (None -> the
    ``REPRO_VALIDATE`` environment variable).
    """
    cache = getattr(plan, "_replan", None)
    if cache is None:
        raise ValueError(
            "plan has no replan cache (built with cache=False, from a "
            "non-canonical CSR, or not a tree plan) — rebuild with "
            "build_plan_tree(..., cache=True)")
    if delta.n != cache.n:
        raise ValueError(f"delta n={delta.n} != plan n={cache.n}")
    m = _merge_csr(cache.indptr, cache.indices, cache.data, cache.keys,
                   delta)
    if not m.structural:
        return _patch_values(plan, cache, m, validate)
    return _patch_structure(plan, cache, m, validate)


def migrate_state(old_plan, new_plan, *arrays):
    """Permute solver state between two plans of the same matrix size.

    Gathers each (k, B[, nb]) array or tensor to global vertex order
    under ``old_plan`` and re-scatters it under ``new_plan``, as a tensor
    on the new plan's device — the warm-start path after a drift-triggered
    full repartition (CG iterate, residual or preconditioner state keep
    their values; only their layout moves).
    """
    if old_plan.n != new_plan.n:
        raise ValueError(
            f"cannot migrate state: old n={old_plan.n}, new n={new_plan.n}")
    out = tuple(torch.from_numpy(np.ascontiguousarray(new_plan.scatter_vec(
        old_plan.gather_vec(a)))).to(new_plan.device) for a in arrays)
    return out[0] if len(out) == 1 else out
