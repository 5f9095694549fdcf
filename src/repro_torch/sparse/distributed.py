"""Distributed SpMV / CG over a heterogeneous partition — the port of
``src/repro/sparse/distributed.py`` (flat plans, ``comm='halo'``) for one
GPU that holds all k PUs.

Plan.  :func:`build_plan` is the reference's vectorized host NumPy builder,
copied and bit-equal to it: each block is padded to B = max block size
(``row_mask`` marks real rows), the quotient graph of the partition is
edge-colored (Misra-Gries, <= Delta+1 rounds) and each color class is one
exchange round; halo columns are remapped once to slots ``B + round*S +
pos``.  :func:`plan_from_arrays` builds the port's :class:`DistPlan` from a
plan's fields as arrays, so a reference plan and a port plan can be the same
plan.

Runtime (stacked mode).  The reference runs one shard_map program per
device; here the k blocks live in one ``(k, B)`` tensor.  Each round's
``ppermute`` becomes a gather over the block axis from a per-round ``(k,)``
source-of-destination index plus a ``(k,)`` receive mask, both built on the
device once.  ``comm='halo'`` keeps the reference's split of each block's
matrix into interior rows (no halo column; matvec issued before the
exchange) and boundary rows (accumulated from the extended vector); the
interior matvec is an ``index_add_`` over padded COO (``local_format='coo'``)
or the block-ELL CUDA kernel over the stacked ``(k, S_b, NNZB, bm, bk)``
form (``'bell'``).  The reference's ``psum`` dot becomes a
``row_mask``-weighted sum over the whole ``(k, B)`` tensor.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from ..core.refinement import vizing_edge_coloring
from ..device import resolve_device
from ..kernels.spmv_bell import padded_coo_to_block_ell, spmv_block_ell
from .cg import cg_solve, jacobi_preconditioner

# plan fields that live on the device, with the reference's dtypes
DEVICE_FIELDS = ("rows", "cols", "vals", "row_mask", "send_idx", "send_mask",
                 "rows_int", "cols_int", "vals_int", "rows_bnd", "cols_bnd",
                 "vals_bnd", "interior_mask", "diag")
HOST_FIELDS = ("perm", "block_of", "sizes", "nnz_blk")
SCALAR_FIELDS = ("k", "B", "S", "n_rounds", "n")


@dataclasses.dataclass
class DistPlan:
    """Host-built plan + device tensors for the stacked distributed
    operator.  Every device tensor carries a leading block axis of size k.
    """

    k: int
    B: int                      # padded rows per block
    S: int                      # padded halo slots per round
    n_rounds: int
    n: int                      # true global size
    perm: np.ndarray            # old vertex id -> padded new id (blk*B+rank)
    block_of: np.ndarray        # (k,) first padded id of each block
    sizes: np.ndarray           # (k,) true rows per block
    nnz_blk: np.ndarray         # (k,) true nnz per block
    round_perms: tuple          # per round: tuple of (src, dst) pairs
    device: torch.device
    # device data
    rows: torch.Tensor          # (k, nnz_pad) int32 local row
    cols: torch.Tensor          # (k, nnz_pad) int32 local col in [0, B+R*S)
    vals: torch.Tensor          # (k, nnz_pad) f32
    row_mask: torch.Tensor      # (k, B) f32
    send_idx: torch.Tensor      # (k, R, S) int32 local indices to send
    send_mask: torch.Tensor     # (k, R, S) f32
    # interior/boundary split of the same nnz set: a row is *boundary* iff
    # any of its edges reads a halo slot
    rows_int: torch.Tensor      # (k, nnz_int_pad) int32
    cols_int: torch.Tensor      # (k, nnz_int_pad) int32, all < B
    vals_int: torch.Tensor      # (k, nnz_int_pad) f32
    rows_bnd: torch.Tensor      # (k, nnz_bnd_pad) int32
    cols_bnd: torch.Tensor      # (k, nnz_bnd_pad) int32, in [0, B+R*S)
    vals_bnd: torch.Tensor      # (k, nnz_bnd_pad) f32
    interior_mask: torch.Tensor  # (k, B) f32: real AND interior rows
    diag: torch.Tensor          # (k, B) f32 diagonal of A (Jacobi)
    _bell: dict = dataclasses.field(default_factory=dict)

    def scatter_vec(self, x: np.ndarray) -> np.ndarray:
        """(n,) global vector -> (k, B) padded block-major layout (host).
        Padding rows stay zero."""
        x = np.asarray(x)
        dt = x.dtype if np.issubdtype(x.dtype, np.floating) else np.float32
        out = np.zeros((self.k, self.B) + x.shape[1:], dtype=dt)
        out[self.perm // self.B, self.perm % self.B] = x
        return out

    def gather_vec(self, xb) -> np.ndarray:
        """(k, B) array or tensor -> (n,) global order (host)."""
        if isinstance(xb, torch.Tensor):
            xb = xb.cpu().numpy()
        return np.asarray(xb)[self.perm // self.B, self.perm % self.B]

    def bell_local(self, bm: int = 8, bk: int = 128):
        """Block-ELL form of the *interior* edges, stacked over blocks.

        Returns (blocks, cols) on the plan's device: (k, S_b, NNZB, bm, bk)
        float32 and (k, S_b, NNZB) int32, NNZB the max over blocks.  The
        blocks are float32 whatever the plan's dtype, as in the reference.
        Interior columns are all < B, so the kernel needs no halo data.
        Cached per (bm, bk).
        """
        key = (bm, bk)
        cached = self._bell.get(key)
        if cached is not None:
            return cached
        ri = self.rows_int.cpu().numpy()
        ci = self.cols_int.cpu().numpy()
        vi = self.vals_int.cpu().numpy()
        per = [padded_coo_to_block_ell(ri[b], ci[b], vi[b], self.B,
                                       bm=bm, bk=bk)
               for b in range(self.k)]
        nnzb = max(blk.shape[1] for blk, _, _ in per)
        Sb = per[0][0].shape[0]
        blocks = np.zeros((self.k, Sb, nnzb, bm, bk), dtype=np.float32)
        cols = np.zeros((self.k, Sb, nnzb), dtype=np.int32)
        for b, (blk, col, _meta) in enumerate(per):
            blocks[b, :, :blk.shape[1]] = blk
            cols[b, :, :col.shape[1]] = col
        del per
        cached = (torch.from_numpy(blocks).to(self.device),
                  torch.from_numpy(cols).to(self.device))
        self._bell[key] = cached
        return cached


def plan_from_arrays(fields: dict, device) -> DistPlan:
    """The port's :class:`DistPlan` from a plan's fields: the reference
    ``DistPlan``'s scalars, ``round_perms`` and arrays (as numpy arrays,
    dtypes kept).  The device fields go to ``device``."""
    device = resolve_device(device)
    kw = {f: int(fields[f]) for f in SCALAR_FIELDS}
    kw.update({f: np.asarray(fields[f]) for f in HOST_FIELDS})
    kw.update({f: torch.from_numpy(np.array(fields[f], order="C"))
               .to(device) for f in DEVICE_FIELDS})
    kw["round_perms"] = tuple(tuple((int(s), int(d)) for s, d in r)
                              for r in fields["round_perms"])
    return DistPlan(device=device, **kw)


def _edge_endpoints(indptr: np.ndarray, indices: np.ndarray):
    src = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return src, np.asarray(indices)


def _pack_local_coo(indptr: np.ndarray, src: np.ndarray, data: np.ndarray,
                    part: np.ndarray, order: np.ndarray, k: int,
                    rows_l: np.ndarray, cols_l: np.ndarray,
                    per_blk: np.ndarray):
    """Pack edges per owning block into (k, nnz_pad) padded-COO arrays —
    scatter, no per-block loop.  The slot of edge e is derived from CSR
    structure in O(nnz) — no argsort: within a block, edges are laid out
    by (owner rank, CSR order), exactly the order a stable argsort over
    part[src] would give — the packed edge order the bit-equality tests
    hold against the reference.

    Returns ``(rows_a, cols_a, vals_a, pos_edge)``.
    """
    n = len(indptr) - 1
    nnz_pad = max(int(per_blk.max()) if len(per_blk) else 1, 1)
    deg = np.diff(indptr)
    deg_o = deg[order]
    # edge start of each vertex inside its block's packed segment
    vstart = np.empty(n, dtype=np.int64)
    blk_edge_start = np.cumsum(per_blk) - per_blk
    vstart[order] = (np.cumsum(deg_o) - deg_o) - blk_edge_start[part[order]]
    pos_edge = (vstart[src]
                + (np.arange(len(src)) - np.repeat(indptr[:-1], deg)))
    own = part[src]
    rows_a = np.zeros((k, nnz_pad), dtype=np.int32)
    cols_a = np.zeros((k, nnz_pad), dtype=np.int32)
    vals_a = np.zeros((k, nnz_pad), dtype=np.float32)
    rows_a[own, pos_edge] = rows_l
    cols_a[own, pos_edge] = cols_l
    vals_a[own, pos_edge] = data
    return rows_a, cols_a, vals_a, pos_edge


def _pack_segment(rows_a: np.ndarray, cols_a: np.ndarray, vals_a: np.ndarray,
                  sel: np.ndarray):
    """Pack the edges selected by boolean mask ``sel`` (k, nnz_pad) into
    fresh (k, pad) arrays, preserving per-block packed edge order."""
    k = rows_a.shape[0]
    counts = sel.sum(axis=1)
    pad = max(int(counts.max()) if k else 0, 1)
    pos = np.cumsum(sel, axis=1) - 1
    b, e = np.nonzero(sel)
    r = np.zeros((k, pad), dtype=np.int32)
    c = np.zeros((k, pad), dtype=np.int32)
    v = np.zeros((k, pad), dtype=np.float32)
    p = pos[b, e]
    r[b, p] = rows_a[b, e]
    c[b, p] = cols_a[b, e]
    v[b, p] = vals_a[b, e]
    return r, c, v


def _derive_overlap_fields(rows_a: np.ndarray, cols_a: np.ndarray,
                           vals_a: np.ndarray, per_blk: np.ndarray,
                           B: int) -> dict:
    """Split each block's packed COO into interior/boundary row segments.

    A local row is *boundary* iff any of its edges has a halo-slot column
    (col >= B); every edge of a boundary row — including its local ones —
    goes to the boundary segment, so the interior matvec depends only on
    x_loc and can be issued before the exchange rounds.
    Within a block the original packed edge order is preserved in both
    segments, and interior + boundary exactly tile the true nnz set.

    Also extracts the (k, B) diagonal of A (rows == cols can only hold for
    local edges, and local ranks are unique, so rows == cols <=> src == dst)
    for Jacobi preconditioning.  Pure vectorized NumPy, derived only from
    the packed arrays.
    """
    k, nnz_pad = rows_a.shape
    per_blk = np.asarray(per_blk, dtype=np.int64)
    valid = np.arange(nnz_pad)[None, :] < per_blk[:, None]     # (k, nnz_pad)
    halo_edge = valid & (cols_a >= B)
    bnd_row = np.zeros((k, B), dtype=bool)
    bi, ei = np.nonzero(halo_edge)
    bnd_row[bi, rows_a[bi, ei]] = True
    blk_col = np.arange(k)[:, None]
    edge_bnd = valid & bnd_row[blk_col, rows_a]
    edge_int = valid & ~edge_bnd

    pack = functools.partial(_pack_segment, rows_a, cols_a, vals_a)
    rows_int, cols_int, vals_int = pack(edge_int)
    rows_bnd, cols_bnd, vals_bnd = pack(edge_bnd)

    diag = np.zeros((k, B), dtype=np.float32)
    on_diag = valid & (rows_a == cols_a)
    db, de = np.nonzero(on_diag)
    np.add.at(diag, (db, rows_a[db, de]), vals_a[db, de])
    return dict(
        rows_int=rows_int, cols_int=cols_int,
        vals_int=vals_int, rows_bnd=rows_bnd,
        cols_bnd=cols_bnd, vals_bnd=vals_bnd,
        diag=diag, nnz_blk=per_blk.copy(),
        _bnd_row=bnd_row,
    )


# build_plan uses O(k*n) dense tables (counting sorts) up to this many
# cells.  The widest live table is the int32 halo-slot map (4 B/cell; the
# bool bitmaps are freed before it is allocated), so the single-shot dense
# path peaks at ~64 MiB of transient tables at this limit.  Beyond it the
# bitmap is *sharded by vertex range*: the same dedupe runs one
# O(k * chunk) chunk at a time (chunk sized so k * chunk stays at the
# limit), so production-scale k*n keeps the counting-sort extraction
# instead of falling back to O(E log E) comparison sorts.  Module-level so
# tests can force the sharded path.
DENSE_PLAN_LIMIT = 1 << 24


def _block_layout(part: np.ndarray, k: int, dense: bool = False):
    """Block-contiguous vertex layout shared by all plan builders.

    Returns ``(sizes, B, order, rank_in_block, perm, block_of)``.  With
    ``dense`` a (k, n) one-hot flatnonzero replaces the argsort — that is
    the counting sort for the (block, id) key directly, so both paths
    yield the identical ``order``.
    """
    n = len(part)
    sizes = np.bincount(part, minlength=k)
    B = int(sizes.max())
    if dense:
        onehot = np.zeros(k * n, dtype=bool)
        onehot[part.astype(np.int64) * n + np.arange(n)] = True
        order = np.flatnonzero(onehot) % n             # new (unpadded) -> old
        del onehot
    else:
        order = np.argsort(part, kind="stable")
    starts = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    rank_in_block = np.empty(n, dtype=np.int32)
    rank_in_block[order] = np.arange(n, dtype=np.int64) - starts[part[order]]
    perm = part.astype(np.int64) * B + rank_in_block   # padded new id
    block_of = np.arange(k, dtype=np.int64) * B
    return sizes, B, order, rank_in_block, perm, block_of


def _ext_col_slots(flat_post: np.ndarray, flat_sorted, o2: np.ndarray,
                   slot_of_trip: np.ndarray, ext_keys: np.ndarray,
                   k: int, n: int, dense: bool) -> np.ndarray:
    """Halo slot per external edge, from the per-triple slots.

    Dense path: scatter the slots into a (k, n) table and gather by edge
    key.  Sharded path: no O(k*n) table — binary-search the sorted
    (recv, v) keys instead (``slot_at[p]`` = slot of the p-th sorted key).
    """
    if dense:
        slot_arr = np.empty(k * n, dtype=np.int32)     # (recv, v) -> slot
        slot_arr[flat_post] = slot_of_trip
        return slot_arr[ext_keys]
    slot_at = np.empty(len(flat_sorted), dtype=np.int32)
    slot_at[o2] = slot_of_trip
    return slot_at[np.searchsorted(flat_sorted, ext_keys)]


def _halo_recv_v_pairs(part: np.ndarray, psrc: np.ndarray, dst: np.ndarray,
                       ext: np.ndarray, k: int, n: int, dense: bool):
    """Deduped (receiver, vertex) halo pairs, ascending by ``recv*n + v``.

    Two equivalent bitmap paths (identical output):

      dense   — O(nnz + k*n): one (k, n) needed-bitmap + flatnonzero.
                Used when the bitmap fits (k*n <= DENSE_PLAN_LIMIT cells).
      sharded — the same dedupe one vertex-range chunk at a time
                (k * chunk <= DENSE_PLAN_LIMIT cells live at once) for
                production-scale k*n; per chunk the flatnonzero gives
                (recv, v) ascending, and chunks partition the v range, so
                one stable radix pass on recv restores global order.

    Returns ``(flat, ext_keys)``: the sorted unique keys and the per-ext-
    edge key (int32 on the dense path — k*n fits — int64 on the sharded).
    """
    if dense:
        needed = np.zeros(k * n, dtype=bool)
        ext_keys = psrc[ext] * np.int32(n) + dst[ext]
        needed[ext_keys] = True
        flat = np.flatnonzero(needed)                  # sorted (recv, v)
        return flat, ext_keys
    e_recv, e_dst = psrc[ext].astype(np.int64), dst[ext].astype(np.int64)
    ext_keys = e_recv * n + e_dst
    cn = max(1, DENSE_PLAN_LIMIT // max(k, 1))
    chunk_of = e_dst // cn
    n_chunks = -(-n // cn)
    ord_c = np.argsort(chunk_of, kind="stable")
    bounds = np.searchsorted(chunk_of[ord_c], np.arange(n_chunks + 1))
    parts_flat = []
    for ci in range(n_chunks):
        sl = ord_c[bounds[ci]:bounds[ci + 1]]
        if not len(sl):
            continue
        v0 = ci * cn
        width = min(cn, n - v0)
        bm = np.zeros(k * width, dtype=bool)
        bm[e_recv[sl] * width + (e_dst[sl] - v0)] = True
        fz = np.flatnonzero(bm)                        # sorted (recv, v_loc)
        parts_flat.append((fz // width) * np.int64(n) + v0 + fz % width)
    flat = (np.concatenate(parts_flat) if parts_flat
            else np.zeros(0, dtype=np.int64))
    return flat[np.argsort(flat // n, kind="stable")], ext_keys


def build_plan(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
               part: np.ndarray, k: int, device=None) -> DistPlan:
    """Build the distributed plan for matrix (CSR) + partition — vectorized
    host NumPy, copied from the reference and bit-equal to it, with the
    device fields placed on ``device`` (default the card).

    O(nnz log nnz) in NumPy kernels (the log from sorts); no Python
    iteration over vertices, edges, or halo slots.  There is no
    ``validate=``: the plan verifier is not ported yet (ROADMAP.md queue 1
    item 10), and ``REPRO_VALIDATE`` is not read.
    """
    device = resolve_device(device)
    n = len(indptr) - 1
    part = np.ascontiguousarray(part, dtype=np.int32)
    # dense-table mode: O(k*n) bitmaps replace O(x log x) sorts wherever a
    # small-range counting sort suffices; vertex-sharded bitmaps beyond
    dense = k * n <= DENSE_PLAN_LIMIT
    sizes, B, order, rank_in_block, perm, block_of = _block_layout(
        part, k, dense=dense)

    # ---- halo triples: (receiver, owner, vertex), deduped & sorted -------
    src, dst = _edge_endpoints(indptr, indices)
    psrc, pdst = part[src], part[dst]
    ext = psrc != pdst
    flat, ext_keys = _halo_recv_v_pairs(part, psrc, dst, ext, k, n, dense)
    flat_sorted = None if dense else flat              # ascending (recv, v)
    t_v = flat % n
    # small-range pair keys: 1-2 radix passes in the stable argsort below
    pair_t = np.int16 if k * k <= np.iinfo(np.int16).max else np.int32
    t_pair = ((flat // n).astype(pair_t) * pair_t(k)
              + part[t_v].astype(pair_t))              # recv*k + own
    o2 = np.argsort(t_pair, kind="stable")             # radix; keeps v asc
    t_pair, t_v, flat = t_pair[o2], t_v[o2], flat[o2]
    # triples sharing a (recv, own) pair are contiguous and sorted by v;
    # halo slot position = rank within the pair group.  t_pair is sorted,
    # so pair groups fall out of the boundary flags — no second unique/sort.
    m = len(t_pair)
    newp = np.empty(m, dtype=bool)
    if m:
        newp[0] = True
        np.not_equal(t_pair[1:], t_pair[:-1], out=newp[1:])
    grp_first = np.flatnonzero(newp)                   # triple idx per pair
    uniq_pairs = t_pair[grp_first]
    pair_counts = np.diff(np.append(grp_first, m))
    pair_of_trip = np.cumsum(newp) - 1
    t_pos = np.arange(m) - grp_first[pair_of_trip]
    S = int(pair_counts.max()) if len(pair_counts) else 1
    S = max(1, S)

    # ---- edge-color the undirected quotient graph ------------------------
    p_recv, p_own = uniq_pairs // k, uniq_pairs % k
    und_key = (np.minimum(p_recv, p_own) * k + np.maximum(p_recv, p_own))
    uniq_und = np.unique(und_key)
    und_a, und_b = uniq_und // k, uniq_und % k
    und_w = np.zeros(len(uniq_und), dtype=np.float64)
    np.add.at(und_w, np.searchsorted(uniq_und, und_key), pair_counts)
    qp = np.stack([und_a, und_b], axis=1).astype(np.int64)
    colors = (vizing_edge_coloring(qp, und_w) if len(qp)
              else np.zeros(0, np.int32))
    n_rounds = int(colors.max() + 1) if len(colors) else 1
    # (k, k) directed-pair -> round lookup (tiny), so per-triple color is a
    # single gather instead of min/max arithmetic over all triples
    color_dir = np.zeros(k * k, dtype=np.int32)
    color_dir[und_a * k + und_b] = colors
    color_dir[und_b * k + und_a] = colors
    t_color = color_dir[t_pair]

    # ---- send schedule (owner side) --------------------------------------
    # each color class is a matching, so an owner serves one receiver per
    # round: the (own, color, pos) scatter below has no collisions.
    send_idx = np.zeros((k, n_rounds, S), dtype=np.int32)
    send_mask = np.zeros((k, n_rounds, S), dtype=np.float32)
    t_own = (uniq_pairs % k)[pair_of_trip]        # owner of each triple
    send_idx[t_own, t_color, t_pos] = rank_in_block[t_v]
    send_mask[t_own, t_color, t_pos] = 1.0
    pair_color = color_dir[und_a * k + und_b]
    round_perms: list[list[tuple[int, int]]] = [[] for _ in range(n_rounds)]
    for a, b, c in zip(und_a.tolist(), und_b.tolist(), pair_color.tolist()):
        # o->r and r->o swap in the same round (bidirectional ppermute)
        round_perms[c].append((a, b))
        round_perms[c].append((b, a))

    # ---- local matrix in padded-COO with remapped columns ----------------
    rows_l = rank_in_block[src]
    # local rank everywhere, then overwrite external edges with halo slots
    cols_l = rank_in_block[dst]
    # halo slot of remote vertex u on receiver r: B + round*S + pos,
    # precomputed per triple so the per-edge remap is one gather
    slot_of_trip = (B + t_color * S + t_pos).astype(np.int32)
    cols_l[ext] = _ext_col_slots(flat, flat_sorted, o2, slot_of_trip,
                                 ext_keys, k, n, dense)
    own = psrc
    per_blk = np.bincount(own, minlength=k)
    rows_a, cols_a, vals_a, pos_edge = _pack_local_coo(
        indptr, src, data, part, order, k, rows_l, cols_l, per_blk)

    row_mask = (np.arange(B)[None, :] < sizes[:, None]).astype(np.float32)

    split = _derive_overlap_fields(rows_a, cols_a, vals_a, per_blk, B)
    bnd_row = split.pop("_bnd_row")
    interior_mask = row_mask * ~bnd_row

    return plan_from_arrays(dict(
        k=k, B=B, S=S, n_rounds=n_rounds, n=n, perm=perm, block_of=block_of,
        sizes=sizes, rows=rows_a, cols=cols_a, vals=vals_a,
        row_mask=row_mask, send_idx=send_idx, send_mask=send_mask,
        round_perms=tuple(tuple(r) for r in round_perms),
        interior_mask=interior_mask, **split), device)


# --------------------------------------------------------------------------
# Stacked runtime: all k blocks in one (k, B) tensor on one device
# --------------------------------------------------------------------------

COMM_MODES = ("halo",)
LOCAL_FORMATS = ("coo", "bell")
_LATER = "ROADMAP.md queue 1 item 5"


def _round_tables(plan: DistPlan):
    """Per round, the (k,) source block each block receives from and the
    (k,) receive mask (0 where a block has no partner that round) — the
    stacked form of the round's ``ppermute`` pairs."""
    R, k = plan.n_rounds, plan.k
    src_of = np.tile(np.arange(k, dtype=np.int64), (R, 1))
    recv = np.zeros((R, k), dtype=np.float32)
    for c, perm in enumerate(plan.round_perms):
        for s, d in perm:
            src_of[c, d] = s
            recv[c, d] = 1.0
    return (torch.from_numpy(src_of).to(plan.device),
            torch.from_numpy(recv).to(plan.device).to(plan.vals.dtype))


def make_dist_spmv(plan: DistPlan, comm: str = "halo",
                   local_format: str = "coo") -> Callable:
    """y = A @ x on (k, B) stacked block-major vectors, overlapped-halo
    schedule: the interior matvec (rows that read no halo slot) first, then
    the exchange rounds, then the boundary rows from the extended
    (k, B + R*S) vector.  Index tensors are flattened over the block axis
    once, here, so each matvec is a few whole-tensor launches."""
    if comm not in COMM_MODES:
        if comm in ("halo_seq", "allgather", "hier"):
            raise NotImplementedError(
                f"comm={comm!r} is not ported yet; see {_LATER}")
        raise ValueError(f"unknown comm mode {comm!r}; choose {COMM_MODES}")
    if local_format not in LOCAL_FORMATS:
        raise ValueError(f"unknown local format {local_format!r}; "
                         f"choose {LOCAL_FORMATS}")
    k, B, R, S = plan.k, plan.B, plan.n_rounds, plan.S
    W = B + R * S
    dev = plan.device
    boff = torch.arange(k, dtype=torch.int64, device=dev)[:, None]
    send_idx = plan.send_idx.long().reshape(k, R * S)
    send_mask = plan.send_mask
    src_of, recv_mask = _round_tables(plan)
    rounds = torch.arange(R, device=dev)[:, None]
    rb = (boff * B + plan.rows_bnd.long()).reshape(-1)
    cb = (boff * W + plan.cols_bnd.long()).reshape(-1)
    vb = plan.vals_bnd.reshape(-1)
    row_mask = plan.row_mask

    def exchange(x):
        sends = torch.gather(x, 1, send_idx).view(k, R, S) * send_mask
        recv = sends.transpose(0, 1)[rounds, src_of] * recv_mask[:, :, None]
        return torch.cat([x, recv.transpose(0, 1).reshape(k, R * S)], dim=1)

    if local_format == "coo":
        ri = (boff * B + plan.rows_int.long()).reshape(-1)
        ci = (boff * B + plan.cols_int.long()).reshape(-1)
        vi = plan.vals_int.reshape(-1)

        def interior(x):
            y = torch.zeros(k * B, dtype=x.dtype, device=x.device)
            return y.index_add_(0, ri, vi * x.reshape(-1)[ci])
    else:
        blocks, bcols = plan.bell_local()

        def interior(x):
            return spmv_block_ell(blocks, bcols, x).reshape(-1)

    def matvec(x):
        if tuple(x.shape) != (k, B):
            raise ValueError(
                f"operand of shape {tuple(x.shape)} is not ({k}, {B}); "
                "batched RHS is not ported yet (ROADMAP.md queue 1 item 7)")
        y = interior(x)                      # no halo dependence
        x_ext = exchange(x)
        y = y.index_add_(0, rb, vb * x_ext.reshape(-1)[cb])
        return y.view(k, B) * row_mask

    return matvec


def make_dist_cg(plan: DistPlan, tol: float = 1e-6, max_iters: int = 500,
                 comm: str = "halo", local_format: str = "coo",
                 precondition: str | None = None) -> Callable:
    """Whole-CG solve on (k, B) operands: the chunked ``cg.cg_solve`` with
    the stacked matvec and the ``row_mask``-weighted dot (the reference's
    psum-reduced local dot).  ``precondition='jacobi'`` uses the plan's
    on-device diagonal.  Returns ``solve(b) -> (x, residual, iters)``."""
    if precondition == "block_jacobi":
        raise NotImplementedError(
            f"precondition='block_jacobi' is not ported yet; see {_LATER}")
    if precondition not in (None, "jacobi"):
        raise ValueError(f"unknown precondition {precondition!r}")
    matvec = make_dist_spmv(plan, comm, local_format)
    row_mask = plan.row_mask
    prec = jacobi_preconditioner(plan.diag) if precondition else None

    def dot(u, v):
        return (u * row_mask * v).sum()

    def solve(b):
        res = cg_solve(matvec, b, tol=tol, max_iters=max_iters, dot=dot,
                       precondition=prec)
        return res.x, res.residual, res.iters

    return solve
