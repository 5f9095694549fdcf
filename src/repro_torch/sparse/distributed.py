"""Distributed SpMV / CG over a heterogeneous partition — the port of
``src/repro/sparse/distributed.py`` for one GPU that holds all k PUs: flat
and tree plans, and every exchange schedule of the reference's runtime.

Plans.  The builders are the reference's host NumPy, copied and bit-equal
to it.  :func:`build_plan` (vectorized; :func:`build_plan_reference` is
the reference's per-edge oracle for it) pads each block to B = max block
size (``row_mask`` marks real rows), edge-colors the quotient graph of the
partition (Misra-Gries, <= Delta+1 rounds) and makes each color class one
exchange round; halo columns are remapped once to slots ``B + round*S +
pos``.  :func:`build_plan_tree` (:func:`build_plan_hier` is its two-level
instance) relabels the blocks tree-major and splits the halo by the LCA
level of each block pair, one colored schedule per tree level over
*suffix* indices.  :func:`plan_from_arrays` / :func:`tree_plan_from_arrays`
build the port's plans from a plan's fields as arrays, so a reference plan
and a port plan can be the same plan.

Runtime (stacked mode).  The reference runs one shard_map program per
device; here the k blocks live in one ``(k, B)`` tensor, or ``(k, B, nb)``
for an RHS batch, whose trailing axis every schedule with a COO interior
carries through (the reference's ``_bcol``).  Each round's
``ppermute`` becomes a gather over the block axis from a per-round ``(k,)``
source-of-destination index plus a ``(k,)`` receive mask, both built on the
device once; a tree level's suffix-indexed pairs fire in every subtree of
that level.  The schedules (``comm``):

  * ``halo``      — interior rows (no halo column) first, then the rounds,
                    then the boundary rows from the extended vector;
  * ``halo_seq``  — every round first, then one matvec over all rows;
  * ``allgather`` — the whole ``(k*B,)`` vector (a reshape of the stacked
                    tensor), then a matvec over padded global columns;
  * ``hier``      — a :class:`TreePlan`'s interior rows, then every level's
                    rounds, then each level's boundary rows, innermost
                    first, from ``[x | level-0 slots | ... | level-(h-1)
                    slots]``.  The reference overlaps the levels; one
                    stream has nothing to overlap, and the slots read are
                    the same.

The interior matvec of ``halo`` / ``hier`` is an ``index_add_`` over padded
COO (``local_format='coo'``) or the block-ELL SpMV over the stacked
``(k, S_b, NNZB, bm, bk)`` form (``'bell'``: the sell route over the
blocks' nonzero entries, :meth:`DistPlan.bell_index`; single-RHS as in the
reference: it raises ``ValueError`` on a batched operand).  The
reference's ``psum`` dot becomes a ``row_mask``-weighted sum over the
whole ``(k, B)`` tensor, per column for a batch.  The
mesh-only parts of the reference (the ``axis``/``mesh`` arguments,
``_validate_tree_axes``, ``abstract_mesh_for``) have no counterpart: one
GPU has no device mesh.
"""
from __future__ import annotations

import dataclasses
import functools
import time
import types
from typing import Callable

import numpy as np
import torch

from ..analysis import validate_requested, verify_plan
from ..core.refinement import vizing_edge_coloring
from ..core.topology import normalize_pod_of, normalize_tree_of
from ..device import resolve_device
from ..kernels.spmv_bell import (BellIndex, bell_index,
                                 padded_coo_to_block_ell, spmv_block_ell)
from .cg import cg_solve, jacobi_preconditioner

# plan fields that live on the device, with the reference's dtypes
DEVICE_FIELDS = ("rows", "cols", "vals", "row_mask", "send_idx", "send_mask",
                 "rows_int", "cols_int", "vals_int", "rows_bnd", "cols_bnd",
                 "vals_bnd", "interior_mask", "diag")
HOST_FIELDS = ("perm", "block_of", "sizes", "nnz_blk")
SCALAR_FIELDS = ("k", "B", "S", "n_rounds", "n")
# the packing order of the edges, from which cols_global is built
PACK_FIELDS = ("_pack_blk", "_pack_pos", "_pack_dst")
# a TreePlan has no flat schedule: its halo fields are per-level tuples
TREE_DEVICE_FIELDS = ("rows", "cols", "vals", "row_mask", "rows_int",
                      "cols_int", "vals_int", "interior_mask", "diag")
TREE_LEVEL_FIELDS = ("send_idx_lvl", "send_mask_lvl", "rows_bnd_lvl",
                     "cols_bnd_lvl", "vals_bnd_lvl")
TREE_HOST_FIELDS = ("anc", "block_map")
TREE_TUPLE_FIELDS = ("fanouts", "S_lvl", "n_rounds_lvl")


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
    # interior/boundary split of the same nnz set: a row is *boundary* iff
    # any of its edges reads a halo slot
    rows_int: torch.Tensor      # (k, nnz_int_pad) int32
    cols_int: torch.Tensor      # (k, nnz_int_pad) int32, all < B
    vals_int: torch.Tensor      # (k, nnz_int_pad) f32
    interior_mask: torch.Tensor  # (k, B) f32: real AND interior rows
    diag: torch.Tensor          # (k, B) f32 diagonal of A (Jacobi)
    # the flat schedule; None on a TreePlan, whose halo is per level
    send_idx: torch.Tensor = None   # (k, R, S) int32 local indices to send
    send_mask: torch.Tensor = None  # (k, R, S) f32
    rows_bnd: torch.Tensor = None   # (k, nnz_bnd_pad) int32
    cols_bnd: torch.Tensor = None   # (k, nnz_bnd_pad) int32, in [0, B+R*S)
    vals_bnd: torch.Tensor = None   # (k, nnz_bnd_pad) f32
    # host packing order of the edges (only allgather's columns need it)
    _pack_blk: np.ndarray = None    # (nnz,) owning block, packed order
    _pack_pos: np.ndarray = None    # (nnz,) slot within block
    _pack_dst: np.ndarray = None    # (nnz,) global dst vertex, packed order
    _cols_global: torch.Tensor = None
    _bell: dict = dataclasses.field(default_factory=dict)
    _bj_inv: torch.Tensor = None    # lazy (k, B, B) block-Jacobi inverses
    # host intermediates for O(delta) replanning (sparse/replan.py); None
    # on a plan built without a cache
    _replan: object = None
    # the ``analysis.Report`` of the ``validate=`` pass that built (or
    # patched) this plan, ``info["seconds"]`` its host time; None when
    # unverified.  A class attribute, not a field: plan equality and
    # ``dataclasses.replace`` (a mutated plan) never see it
    verify_report = None

    @property
    def cols_global(self) -> torch.Tensor:
        """(k, nnz_pad) int32 columns in padded global ids (blk*B + rank),
        built on first access from the packing order."""
        if self._cols_global is None:
            if self._pack_blk is None:
                raise ValueError("this plan carries neither cols_global nor "
                                 "the packing order it is built from")
            out = np.zeros(tuple(self.rows.shape), dtype=np.int32)
            out[self._pack_blk, self._pack_pos] = \
                self.perm[self._pack_dst].astype(np.int32)
            self._cols_global = torch.from_numpy(out).to(self.device)
        return self._cols_global

    def scatter_vec(self, x: np.ndarray) -> np.ndarray:
        """(n,) global vector -> (k, B) padded block-major layout (host).
        An (n, nb) RHS batch scatters to (k, B, nb); padding rows stay
        zero in every column."""
        x = np.asarray(x)
        dt = x.dtype if np.issubdtype(x.dtype, np.floating) else np.float32
        out = np.zeros((self.k, self.B) + x.shape[1:], dtype=dt)
        out[self.perm // self.B, self.perm % self.B] = x
        return out

    def gather_vec(self, xb) -> np.ndarray:
        """(k, B[, nb]) array or tensor -> (n[, nb]) global order
        (host)."""
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

    def bell_index(self, bm: int = 8, bk: int = 128) -> BellIndex:
        """The sell route's index of :meth:`bell_local`'s blocks (their
        nonzero entries), built on the plan's device and cached with them,
        so a patched plan (``_bell={}``) rebuilds it too."""
        key = ("index", bm, bk)
        cached = self._bell.get(key)
        if cached is None:
            blocks, cols = self.bell_local(bm, bk)
            cached = self._bell[key] = bell_index(blocks, cols, self.B)
        return cached

    def block_jacobi_inv(self) -> torch.Tensor:
        """(k, B, B) f32 inverses of the per-PU diagonal blocks of A, on the
        plan's device.

        The diagonal block of PU b is assembled from the *local* edges the
        plan already extracted (cols < B).  Rows with no local entries
        (ghost padding rows, fully-halo rows) get an identity diagonal,
        which keeps their zero residuals out of the Krylov space.  Lazily
        computed and cached; the reference's dense O(k B^3) float64 host
        inversion, meant for test scales: at B = 368,811 the f32 inverses
        alone would take 4.35 TB.
        """
        if self._bj_inv is None:
            rows = self.rows.cpu().numpy()
            cols = self.cols.cpu().numpy()
            vals = self.vals.cpu().numpy().astype(np.float64)
            k, nnz_pad = rows.shape
            per = np.asarray(self.nnz_blk, dtype=np.int64)
            valid = np.arange(nnz_pad)[None, :] < per[:, None]
            loc = valid & (cols < self.B)
            M = np.zeros((k, self.B, self.B), dtype=np.float64)
            bi, ei = np.nonzero(loc)
            np.add.at(M, (bi, rows[bi, ei], cols[bi, ei]), vals[bi, ei])
            zero_row = ~M.any(axis=2)                       # ghost + no-local
            zb, zr = np.nonzero(zero_row)
            M[zb, zr, zr] = 1.0
            self._bj_inv = torch.from_numpy(
                np.linalg.inv(M).astype(np.float32)).to(self.device)
        return self._bj_inv


@dataclasses.dataclass
class TreePlan(DistPlan):
    """Arbitrary-depth tree plan (:func:`build_plan_tree`; the two-level
    :func:`build_plan_hier` is the ``h == 2`` instance).

    Blocks are *tree-major*: device position = the leaf slot of the
    ``fanouts`` mixed radix (outermost digit first).  Halo edges are split
    by the LCA level of their block pair (level 0 = siblings, level h-1 =
    root-crossing), one segment per level, each with its own Misra-Gries
    coloring over that level's quotient graph, whose nodes are *suffix*
    indices (the last ``level + 1`` radix digits): one schedule fires in
    every subtree of the level at once (blocks without a given edge send
    masked zeros).

    The extended vector layout is ``[x_loc | lvl-0 slots | ... |
    lvl-(h-1) slots]``: a boundary row's class is the highest level it
    reads.  The flat schedule fields (``send_idx`` / ``send_mask`` /
    ``round_perms`` / ``rows_bnd``...) are not populated — a TreePlan only
    runs under ``comm='hier'``.  The two-level names (``S_intra`` /
    ``n_rounds_inter`` / ``send_idx_intra`` / ``rows_bnd_inter`` / ``pods``
    / ``k_local`` / ``pod_of``...) are read-only views of the level tuples.
    """

    fanouts: tuple = ()                 # (k_1, ..., k_h), prod == k
    anc: np.ndarray = None              # (h-1, k) canonical table, tree-major
    block_map: np.ndarray = None        # (k,) original block id -> device pos
    S_lvl: tuple = ()                   # per-level halo slots per round
    n_rounds_lvl: tuple = ()            # per-level colored round count
    send_idx_lvl: tuple = ()            # per level: (k, R_l, S_l) int32
    send_mask_lvl: tuple = ()           # per level: (k, R_l, S_l) f32
    round_perms_lvl: tuple = ()         # per level, per round:
    #                                     suffix-linearized (src, dst) pairs
    rows_bnd_lvl: tuple = ()            # per level: rows whose highest
    cols_bnd_lvl: tuple = ()            #   read is that level's slot range
    vals_bnd_lvl: tuple = ()

    # -- tree structure -----------------------------------------------------
    @property
    def h(self) -> int:
        return len(self.fanouts)

    def level_offsets(self) -> np.ndarray:
        """(h+1,) slot-range boundaries of the extended vector: level l
        slots live in ``[offs[l], offs[l+1])``; ``offs[0] == B``."""
        sizes = [r * s for r, s in zip(self.n_rounds_lvl, self.S_lvl)]
        return self.B + np.concatenate([[0], np.cumsum(sizes)]).astype(int)

    def level_sizes(self) -> tuple:
        """Per level l, the number of blocks in one of its subtrees,
        ``prod(fanouts[h-1-l:])``: the range of its suffix indices."""
        return tuple(int(np.prod(self.fanouts[self.h - 1 - l:]))
                     for l in range(self.h))

    # -- two-level views (the pod API) ---------------------------------------
    @property
    def pods(self) -> int:
        return self.fanouts[0] if self.h >= 2 else 1

    @property
    def k_local(self) -> int:
        return self.k // self.pods

    @property
    def pod_of(self) -> np.ndarray:
        """(k,) top-level group of each tree-major block."""
        return np.arange(self.k, dtype=np.int64) // self.k_local

    def _two_level(self, name: str, idx: int):
        if self.h > 2:
            raise AttributeError(
                f"{name} is the two-level view; this plan is depth "
                f"{self.h} — use the *_lvl tuples")
        return idx

    @property
    def S_intra(self) -> int:
        return self.S_lvl[self._two_level("S_intra", 0)]

    @property
    def S_inter(self) -> int:
        self._two_level("S_inter", 1)
        return self.S_lvl[1] if self.h >= 2 else 1

    @property
    def n_rounds_intra(self) -> int:
        return self.n_rounds_lvl[self._two_level("n_rounds_intra", 0)]

    @property
    def n_rounds_inter(self) -> int:
        self._two_level("n_rounds_inter", 1)
        return self.n_rounds_lvl[1] if self.h >= 2 else 0

    @property
    def send_idx_intra(self):
        return self.send_idx_lvl[self._two_level("send_idx_intra", 0)]

    @property
    def send_mask_intra(self):
        return self.send_mask_lvl[self._two_level("send_mask_intra", 0)]

    @property
    def send_idx_inter(self):
        return self.send_idx_lvl[self._two_level("send_idx_inter", 1)]

    @property
    def send_mask_inter(self):
        return self.send_mask_lvl[self._two_level("send_mask_inter", 1)]

    @property
    def round_perms_intra(self) -> tuple:
        return self.round_perms_lvl[self._two_level("round_perms_intra", 0)]

    @property
    def round_perms_inter(self) -> tuple:
        return self.round_perms_lvl[self._two_level("round_perms_inter", 1)]

    @property
    def rows_bnd_intra(self):
        return self.rows_bnd_lvl[self._two_level("rows_bnd_intra", 0)]

    @property
    def cols_bnd_intra(self):
        return self.cols_bnd_lvl[self._two_level("cols_bnd_intra", 0)]

    @property
    def vals_bnd_intra(self):
        return self.vals_bnd_lvl[self._two_level("vals_bnd_intra", 0)]

    @property
    def rows_bnd_inter(self):
        return self.rows_bnd_lvl[self._two_level("rows_bnd_inter", 1)]

    @property
    def cols_bnd_inter(self):
        return self.cols_bnd_lvl[self._two_level("cols_bnd_inter", 1)]

    @property
    def vals_bnd_inter(self):
        return self.vals_bnd_lvl[self._two_level("vals_bnd_inter", 1)]


# The two-level plan is the h == 2 TreePlan, under the reference's name.
HierPlan = TreePlan




def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _pairs(perms) -> tuple:
    return tuple(tuple((int(s), int(d)) for s, d in r) for r in perms)


def _common_fields(fields: dict, device, device_fields) -> dict:
    kw = {f: int(fields[f]) for f in SCALAR_FIELDS}
    kw.update({f: np.asarray(fields[f]) for f in HOST_FIELDS})
    kw.update({f: _tensor(fields[f], device) for f in device_fields})
    kw.update({f: np.asarray(fields[f]) for f in PACK_FIELDS
               if fields.get(f) is not None})
    if fields.get("cols_global") is not None:
        kw["_cols_global"] = _tensor(fields["cols_global"], device)
    return kw


def plan_from_arrays(fields: dict, device) -> DistPlan:
    """The port's :class:`DistPlan` from a flat plan's fields: the
    reference ``DistPlan``'s scalars, ``round_perms`` and arrays (as numpy
    arrays, dtypes kept).  The device fields go to ``device``.  Either the
    packing order (``_pack_blk`` / ``_pack_pos`` / ``_pack_dst``) or a
    finished ``cols_global`` may come along for ``comm='allgather'``."""
    device = resolve_device(device)
    kw = _common_fields(fields, device, DEVICE_FIELDS)
    kw["round_perms"] = _pairs(fields["round_perms"])
    return DistPlan(device=device, **kw)


def tree_plan_from_arrays(fields: dict, device) -> TreePlan:
    """The port's :class:`TreePlan` from a tree plan's fields: scalars,
    host arrays, the level tuples (``fanouts``, ``S_lvl``,
    ``n_rounds_lvl``, ``round_perms_lvl`` and per-level arrays) and the
    shared device arrays, as :func:`plan_from_arrays` takes them."""
    device = resolve_device(device)
    kw = _common_fields(fields, device, TREE_DEVICE_FIELDS)
    kw.update({f: np.asarray(fields[f]) for f in TREE_HOST_FIELDS})
    kw.update({f: tuple(int(v) for v in fields[f])
               for f in TREE_TUPLE_FIELDS})
    kw.update({f: tuple(_tensor(a, device) for a in fields[f])
               for f in TREE_LEVEL_FIELDS})
    kw["round_perms_lvl"] = tuple(_pairs(r)
                                  for r in fields["round_perms_lvl"])
    return TreePlan(device=device, round_perms=(), **kw)


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


def _maybe_verify(fields: dict, validate: bool | None):
    """Run the structural verifier (``repro_torch.analysis``) on a freshly
    built or patched plan, given as its *host* arrays — before any field is
    placed on a device, so a plan bound for the card is never copied back
    to be checked.  Raises ``analysis.PlanVerificationError`` (a
    ``ValueError``) naming every violated invariant.  Returns the report,
    its ``info["seconds"]`` the verifier's host seconds (the builders keep
    it as ``plan.verify_report``), or None when not asked."""
    if not validate_requested(validate):
        return None
    t0 = time.perf_counter()
    rep = verify_plan(types.SimpleNamespace(**fields))
    rep.info["seconds"] = time.perf_counter() - t0
    rep.raise_for_errors()
    return rep


def build_plan(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
               part: np.ndarray, k: int, device=None,
               validate: bool | None = None) -> DistPlan:
    """Build the distributed plan for matrix (CSR) + partition — vectorized
    host NumPy, copied from the reference and bit-equal to it, with the
    device fields placed on ``device`` (default the card).

    O(nnz log nnz) in NumPy kernels (the log from sorts); no Python
    iteration over vertices, edges, or halo slots.  ``validate=`` runs the
    ``repro_torch.analysis`` structural verifier on the host arrays
    (default: the ``REPRO_VALIDATE`` environment variable).
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

    fields = dict(
        k=k, B=B, S=S, n_rounds=n_rounds, n=n, perm=perm, block_of=block_of,
        sizes=sizes, rows=rows_a, cols=cols_a, vals=vals_a,
        row_mask=row_mask, send_idx=send_idx, send_mask=send_mask,
        round_perms=tuple(tuple(r) for r in round_perms),
        interior_mask=interior_mask, **split,
        _pack_blk=own, _pack_pos=pos_edge, _pack_dst=dst)
    report = _maybe_verify(fields, validate)
    plan = plan_from_arrays(fields, device)
    plan.verify_report = report
    return plan


def build_plan_reference(indptr: np.ndarray, indices: np.ndarray,
                         data: np.ndarray, part: np.ndarray,
                         k: int, device=None) -> DistPlan:
    """The reference's per-edge plan builder, copied: the oracle that
    :func:`build_plan` is held bit-equal to.  O(|halo|) Python iteration —
    do not use beyond toy meshes."""
    device = resolve_device(device)
    n = len(indptr) - 1
    part = np.asarray(part)
    sizes = np.bincount(part, minlength=k)
    B = int(sizes.max())
    order = np.argsort(part, kind="stable")
    starts = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    rank_in_block = np.empty(n, dtype=np.int64)
    rank_in_block[order] = np.arange(n) - starts[part[order]]
    perm = part.astype(np.int64) * B + rank_in_block
    block_of = np.arange(k, dtype=np.int64) * B

    src, dst = _edge_endpoints(indptr, indices)
    ext = part[src] != part[dst]
    recv_blk = part[src][ext].astype(np.int64)
    own_blk = part[dst][ext].astype(np.int64)
    needed = dst[ext].astype(np.int64)
    pair_key = recv_blk * k + own_blk
    uniq_keys, inv = np.unique(pair_key, return_inverse=True)
    need_map: dict[tuple[int, int], np.ndarray] = {}
    for i, key in enumerate(uniq_keys):
        r, o = int(key // k), int(key % k)
        need_map[(r, o)] = np.unique(needed[inv == i])

    und_pairs = sorted({(min(r, o), max(r, o)) for (r, o) in need_map})
    qp = np.array(und_pairs, dtype=np.int64).reshape(-1, 2)
    qw = np.array([len(need_map.get((a, b), ())) +
                   len(need_map.get((b, a), ())) for a, b in und_pairs],
                  dtype=np.float64)
    colors = (vizing_edge_coloring(qp, qw) if len(qp)
              else np.zeros(0, np.int32))
    n_rounds = int(colors.max() + 1) if len(colors) else 1
    S = max(1, max((len(v) for v in need_map.values()), default=1))

    send_idx = np.zeros((k, n_rounds, S), dtype=np.int32)
    send_mask = np.zeros((k, n_rounds, S), dtype=np.float32)
    halo_slot: dict[tuple[int, int], int] = {}
    round_perms: list[list[tuple[int, int]]] = [[] for _ in range(n_rounds)]
    for e, (a, b) in enumerate(und_pairs):
        c = int(colors[e])
        for (o, r) in ((a, b), (b, a)):
            need = need_map.get((r, o))
            if need is None or len(need) == 0:
                continue
            loc = rank_in_block[need].astype(np.int32)
            send_idx[o, c, :len(need)] = loc
            send_mask[o, c, :len(need)] = 1.0
            for p, u in enumerate(need):
                halo_slot[(r, int(u))] = B + c * S + p
        round_perms[c].append((a, b))
        round_perms[c].append((b, a))

    rows_l = rank_in_block[src].astype(np.int32)
    cols_l = np.empty(len(dst), dtype=np.int32)
    same = ~ext
    cols_l[same] = rank_in_block[dst[same]].astype(np.int32)
    for i in np.nonzero(ext)[0]:
        cols_l[i] = halo_slot[(int(part[src[i]]), int(dst[i]))]
    own = part[src]
    per_blk = np.bincount(own, minlength=k)
    nnz_pad = max(int(per_blk.max()) if len(per_blk) else 1, 1)
    rows_a = np.zeros((k, nnz_pad), dtype=np.int32)
    cols_a = np.zeros((k, nnz_pad), dtype=np.int32)
    vals_a = np.zeros((k, nnz_pad), dtype=np.float32)
    ord2 = np.argsort(own, kind="stable")
    off = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(per_blk, out=off[1:])
    for b in range(k):
        sl = ord2[off[b]:off[b + 1]]
        rows_a[b, :len(sl)] = rows_l[sl]
        cols_a[b, :len(sl)] = cols_l[sl]
        vals_a[b, :len(sl)] = data[sl]

    row_mask = np.zeros((k, B), dtype=np.float32)
    for b in range(k):
        row_mask[b, :sizes[b]] = 1.0

    split = _derive_overlap_fields(rows_a, cols_a, vals_a, per_blk, B)
    bnd_row = split.pop("_bnd_row")
    interior_mask = row_mask * ~bnd_row

    blk_e = own[ord2]
    return plan_from_arrays(dict(
        k=k, B=B, S=S, n_rounds=n_rounds, n=n, perm=perm, block_of=block_of,
        sizes=sizes, rows=rows_a, cols=cols_a, vals=vals_a,
        row_mask=row_mask, send_idx=send_idx, send_mask=send_mask,
        round_perms=tuple(tuple(r) for r in round_perms),
        interior_mask=interior_mask, **split,
        _pack_blk=blk_e,
        _pack_pos=np.arange(len(src)) - off[blk_e],
        _pack_dst=dst[ord2]), device)


# --------------------------------------------------------------------------
# hierarchical (arbitrary-depth tree) plans
# --------------------------------------------------------------------------

def _class_schedule(t_pair: np.ndarray, t_v: np.ndarray, k: int,
                    q_of: np.ndarray, nq: int, rank_in_block: np.ndarray):
    """Schedule one halo class (intra- or inter-pod) of directed-pair
    triples.

    ``t_pair`` (sorted ``recv*k + own`` keys; triples within a pair sorted
    by vertex) is grouped into pair runs; the class's quotient graph —
    nodes ``q_of[block]`` (local pu index for intra, global block id for
    inter), so intra edges from *different pods* with the same local
    endpoints merge into one colored edge and share a ppermute pair — is
    Misra-Gries edge-colored; the owner-side send schedule and per-triple
    halo slots fall out of (color, position-in-pair).

    Returns ``(S, n_rounds, send_idx, send_mask, round_pairs, slot)`` with
    ``slot`` the *relative* slot ``color * S + pos`` per triple and
    ``round_pairs[c]`` the bidirectional quotient-node pairs of round c.
    """
    m = len(t_pair)
    newp = np.empty(m, dtype=bool)
    if m:
        newp[0] = True
        np.not_equal(t_pair[1:], t_pair[:-1], out=newp[1:])
    grp_first = np.flatnonzero(newp)
    uniq_pairs = t_pair[grp_first].astype(np.int64)
    pair_counts = np.diff(np.append(grp_first, m))
    pair_of_trip = np.cumsum(newp) - 1
    t_pos = np.arange(m) - grp_first[pair_of_trip] if m else np.zeros(0, int)
    S = max(1, int(pair_counts.max()) if len(pair_counts) else 1)

    p_recv, p_own = uniq_pairs // k, uniq_pairs % k
    q_r, q_o = q_of[p_recv], q_of[p_own]
    und_key = np.minimum(q_r, q_o) * nq + np.maximum(q_r, q_o)
    uniq_und, und_inv = np.unique(und_key, return_inverse=True)
    und_a, und_b = uniq_und // nq, uniq_und % nq
    und_w = np.zeros(len(uniq_und), dtype=np.float64)
    np.add.at(und_w, und_inv, pair_counts)
    qp = np.stack([und_a, und_b], axis=1).astype(np.int64)
    colors = (vizing_edge_coloring(qp, und_w) if len(qp)
              else np.zeros(0, np.int32))
    n_rounds = int(colors.max() + 1) if len(colors) else 0
    color_dir = np.zeros(nq * nq, dtype=np.int32)
    color_dir[und_a * nq + und_b] = colors
    color_dir[und_b * nq + und_a] = colors
    t_color = (color_dir[q_of[(t_pair.astype(np.int64)) // k] * nq
                         + q_of[t_pair.astype(np.int64) % k]]
               if m else np.zeros(0, np.int32))

    send_idx = np.zeros((k, n_rounds, S), dtype=np.int32)
    send_mask = np.zeros((k, n_rounds, S), dtype=np.float32)
    t_own = (uniq_pairs % k)[pair_of_trip] if m else np.zeros(0, int)
    send_idx[t_own, t_color, t_pos] = rank_in_block[t_v]
    send_mask[t_own, t_color, t_pos] = 1.0
    round_pairs: list[list[tuple[int, int]]] = [[] for _ in range(n_rounds)]
    pair_color = color_dir[und_a * nq + und_b]
    for a, b, c in zip(und_a.tolist(), und_b.tolist(), pair_color.tolist()):
        round_pairs[c].append((a, b))
        round_pairs[c].append((b, a))
    slot = (t_color * S + t_pos).astype(np.int32)
    return (S, n_rounds, send_idx, send_mask,
            tuple(tuple(r) for r in round_pairs), slot)


def _derive_tree_fields_np(rows_a: np.ndarray, cols_a: np.ndarray,
                           vals_a: np.ndarray, per_blk: np.ndarray,
                           B: int, offs: np.ndarray) -> dict:
    """NumPy core of :func:`_derive_tree_fields` — host arrays only.

    Besides the packed segments it returns the per-edge segment
    bookkeeping (``seg_lvl``/``seg_pos``/``seg_counts``, ``row_lvl`` and
    the diagonal entry positions) that :mod:`.replan` patches segments
    with.
    """
    k, nnz_pad = rows_a.shape
    h = len(offs) - 1
    per_blk = np.asarray(per_blk, dtype=np.int64)
    valid = np.arange(nnz_pad)[None, :] < per_blk[:, None]
    # per-edge slot level: -1 local, l for cols in [offs[l], offs[l+1])
    edge_lvl = np.searchsorted(np.asarray(offs), cols_a, side="right") - 1
    edge_lvl = np.where(valid, edge_lvl, -1)
    # per-row highest level read
    row_lvl = np.full((k, B), -1, dtype=np.int64)
    bi, ei = np.nonzero(valid)
    np.maximum.at(row_lvl, (bi, rows_a[bi, ei]), edge_lvl[bi, ei])

    blk_col = np.arange(k)[:, None]
    row_lvl_of_edge = row_lvl[blk_col, rows_a]
    # per-edge segment (-2 padding, -1 interior, l = boundary level) and
    # the edge's packed position inside that segment
    seg_lvl = np.where(valid, row_lvl_of_edge, -2).astype(np.int8)
    seg_pos = np.zeros((k, nnz_pad), dtype=np.int32)
    seg_counts = np.zeros((h + 1, k), dtype=np.int64)
    segs = []
    for s in range(-1, h):
        sel = valid & (row_lvl_of_edge == s)
        counts = sel.sum(axis=1)
        seg_counts[s + 1] = counts
        pad = max(int(counts.max()) if k else 0, 1)
        pos = np.cumsum(sel, axis=1) - 1
        b, e = np.nonzero(sel)
        p = pos[b, e]
        seg_pos[b, e] = p.astype(np.int32)
        r = np.zeros((k, pad), dtype=np.int32)
        c = np.zeros((k, pad), dtype=np.int32)
        v = np.zeros((k, pad), dtype=np.float32)
        r[b, p] = rows_a[b, e]
        c[b, p] = cols_a[b, e]
        v[b, p] = vals_a[b, e]
        segs.append((r, c, v))

    diag = np.zeros((k, B), dtype=np.float32)
    on_diag = valid & (rows_a == cols_a)
    db, de = np.nonzero(on_diag)
    np.add.at(diag, (db, rows_a[db, de]), vals_a[db, de])
    return dict(
        int_seg=segs[0], lvl_segs=segs[1:], diag=diag,
        nnz_blk=per_blk.copy(), row_lvl=row_lvl,
        seg_lvl=seg_lvl, seg_pos=seg_pos, seg_counts=seg_counts,
        diag_b=db, diag_e=de,
    )


def _derive_tree_fields(rows_a: np.ndarray, cols_a: np.ndarray,
                        vals_a: np.ndarray, per_blk: np.ndarray,
                        B: int, offs: np.ndarray) -> dict:
    """(h+1)-way interior / per-level boundary split.

    A row's class is the *highest* slot level any of its edges reads
    (``offs`` are the level-range boundaries, ``offs[0] == B``; reads
    below B are local).  Every edge of a row goes to the row's segment,
    so the h+1 segments exactly tile the true nnz set and the flat
    plan's boundary set is the union of the level segments.  The
    interior criterion (no halo reads at all) is identical to the flat
    plan's, so the interior segment is bit-equal to :func:`build_plan`'s
    on the same partition.  ``_host`` carries the raw output for the
    replan cache (popped by :func:`build_plan_tree`).
    """
    host = _derive_tree_fields_np(rows_a, cols_a, vals_a, per_blk, B, offs)
    rows_int, cols_int, vals_int = host["int_seg"]
    lvl_seg = host["lvl_segs"]
    return dict(
        rows_int=rows_int, cols_int=cols_int, vals_int=vals_int,
        rows_bnd_lvl=tuple(r for r, _, _ in lvl_seg),
        cols_bnd_lvl=tuple(c for _, c, _ in lvl_seg),
        vals_bnd_lvl=tuple(v for _, _, v in lvl_seg),
        diag=host["diag"], nnz_blk=host["nnz_blk"],
        _bnd_row=host["row_lvl"] >= 0, _host=host,
    )


def build_plan_tree(indptr: np.ndarray, indices: np.ndarray,
                    data: np.ndarray, part: np.ndarray,
                    tree, k: int, fanouts=None,
                    device=None, cache: bool = True,
                    validate: bool | None = None) -> TreePlan:
    """Build the arbitrary-depth distributed plan for a tree mesh.

    ``tree`` is anything ``core.topology.normalize_tree_of`` accepts: a
    pod count or (k,) pod array (the two-level instance), an explicit
    (h-1, k) ancestor table — e.g. the partition-derived table of the
    reference's ``core.api.partition_tree`` / ``tree_assignment_for``
    (generally non-contiguous after the per-level sweeps) — or ``None`` with
    ``fanouts`` for the canonical contiguous grouping.  Every level must
    group blocks equally (the tree meshes are rectangular).  Blocks are
    relabeled tree-major (lexicographic by ancestor path); ``block_map``
    maps the caller's block ids to device positions (scatter/gather are
    unaffected — they go through ``perm``).

    Each tree level gets its own Misra-Gries coloring of its quotient
    graph over *suffix* indices (the last ``level + 1`` mixed-radix
    digits), so one ppermute schedule over the level's axis suffix fires
    in every subtree at once; the outermost level linearizes the full
    axis tuple.  Vectorized NumPy throughout; the only Python loops are
    over tree levels, quotient edges and chunks, as in
    :func:`build_plan`.  Host NumPy copied from the reference and
    bit-equal to it; the device fields go to ``device`` (default the
    card).  ``cache=True`` keeps the host intermediates that
    :func:`.replan.apply_edge_delta` patches in O(delta) (``plan._replan``;
    None for a non-canonical CSR).  ``validate=`` as in :func:`build_plan`
    (the host arrays and the replan cache, PLAN010 included, are verified
    before any field is placed).
    """
    device = resolve_device(device)
    n = len(indptr) - 1
    part = np.ascontiguousarray(part, dtype=np.int32)
    # one validation definition shared with the partitioner side
    anc_in = normalize_tree_of(tree, k, fanouts)
    h = anc_in.shape[0] + 1
    # tree-major relabeling: device position = leaf slot of the mixed
    # radix — stable lexicographic by ancestor path (top row primary),
    # the depth-h generalization of build_plan_hier's pod-major argsort
    order_blocks = (np.lexsort(tuple(anc_in[::-1])) if h > 1
                    else np.arange(k, dtype=np.int64))
    block_map = np.empty(k, dtype=np.int64)
    block_map[order_blocks] = np.arange(k)
    part = block_map[part].astype(np.int32)
    # canonical table / fanouts of the relabeled (device-position) blocks
    counts = [int(anc_in[t].max()) + 1 for t in range(h - 1)] + [k]
    fanouts_out, prev = [], 1
    for c in counts:
        fanouts_out.append(c // prev)
        prev = c
    fanouts_out = tuple(fanouts_out)
    # suffix size of level l = prod(fanouts[h-1-l:]): the range its
    # quotient nodes (and ppermute indices) live in
    suffix = [1] * (h + 1)
    for t in range(h - 1, -1, -1):
        suffix[h - 1 - t + 1] = suffix[h - 1 - t] * fanouts_out[t]
    dev = np.arange(k, dtype=np.int64)
    anc_dev = np.stack([dev // suffix[h - 1 - t]
                        for t in range(h - 1)]) if h > 1 else \
        np.zeros((0, k), dtype=np.int64)

    dense = k * n <= DENSE_PLAN_LIMIT
    sizes, B, order, rank_in_block, perm, block_of = _block_layout(
        part, k, dense=dense)

    # ---- halo triples, split by LCA level -------------------------------
    # same dense/vertex-sharded bitmap extraction as build_plan (one
    # definition, DENSE_PLAN_LIMIT respected), then triples ordered by
    # (directed pair, vertex) via the stable radix pass
    src, dst = _edge_endpoints(indptr, indices)
    psrc, pdst = part[src], part[dst]
    ext = psrc != pdst
    flat, ext_keys = _halo_recv_v_pairs(part, psrc, dst, ext, k, n, dense)
    flat_sorted = None if dense else flat              # ascending (recv, v)
    t_v_pre = flat % n
    t_pair_pre = ((flat // n).astype(np.int64) * k
                  + part[t_v_pre].astype(np.int64))    # recv*k + own
    o2 = np.argsort(t_pair_pre, kind="stable")         # keeps v ascending
    t_pair_all = t_pair_pre[o2]
    t_v_all = t_v_pre[o2]
    flat_post = flat[o2]
    # LCA level per triple: highest level whose suffix indices differ
    t_recv, t_own = t_pair_all // k, t_pair_all % k
    t_lvl = np.zeros(len(t_pair_all), dtype=np.int64)
    for l in range(h):
        differ = (t_recv // suffix[l]) != (t_own // suffix[l])
        t_lvl = np.where(differ, l, t_lvl)

    S_lvl, R_lvl, si_lvl, sm_lvl, perms_lvl = [], [], [], [], []
    slot_of_trip = np.empty(len(t_pair_all), dtype=np.int32)
    off = B
    for l in range(h):
        sel = t_lvl == l
        sz = suffix[l + 1]
        S_l, R_l, si, sm, perms, slot = _class_schedule(
            t_pair_all[sel], t_v_all[sel], k, dev % sz, sz, rank_in_block)
        slot_of_trip[sel] = off + slot
        off += R_l * S_l
        S_lvl.append(S_l)
        R_lvl.append(R_l)
        si_lvl.append(si)
        sm_lvl.append(sm)
        perms_lvl.append(perms)
    offs = B + np.concatenate(
        [[0], np.cumsum([r * s for r, s in zip(R_lvl, S_lvl)])]).astype(int)

    # ---- local matrix in padded-COO (same packing as build_plan) --------
    rows_l = rank_in_block[src]
    cols_l = rank_in_block[dst]
    cols_l[ext] = _ext_col_slots(flat_post, flat_sorted, o2, slot_of_trip,
                                 ext_keys, k, n, dense)
    own = psrc
    per_blk = np.bincount(own, minlength=k)
    rows_a, cols_a, vals_a, pos_edge = _pack_local_coo(
        indptr, src, data, part, order, k, rows_l, cols_l, per_blk)

    row_mask = (np.arange(B)[None, :] < sizes[:, None]).astype(np.float32)

    split = _derive_tree_fields(rows_a, cols_a, vals_a, per_blk, B, offs)
    bnd_row = split.pop("_bnd_row")
    host_split = split.pop("_host")
    interior_mask = row_mask * ~bnd_row

    # host intermediates for O(delta) patching (sparse/replan.py); a
    # canonical sorted CSR is required, so a non-canonical input simply
    # gets no cache
    replan_cache = None
    if cache:
        from .replan import capture_replan_cache
        replan_cache = capture_replan_cache(
            indptr=np.asarray(indptr), indices=dst,
            data=np.asarray(data), src=src,
            part=part, order=order, rank_in_block=rank_in_block,
            sizes=sizes, B=B, k=k, n=n, fanouts=fanouts_out,
            suffix=tuple(suffix), flat=flat, o2=o2, ext=ext,
            ext_keys=ext_keys, psrc=psrc,
            t_pair=t_pair_all, t_v=t_v_all, t_lvl=t_lvl,
            slot_of_trip=slot_of_trip, offs=offs,
            rows_a=rows_a, cols_a=cols_a, vals_a=vals_a,
            per_blk=per_blk, pos_edge=pos_edge,
            row_mask=row_mask, host=host_split,
            send_idx_lvl=si_lvl, send_mask_lvl=sm_lvl)

    fields = dict(
        k=k, B=B, S=max(S_lvl), n_rounds=sum(R_lvl), n=n, perm=perm,
        block_of=block_of, sizes=sizes, rows=rows_a, cols=cols_a,
        vals=vals_a, row_mask=row_mask, interior_mask=interior_mask,
        **split, fanouts=fanouts_out, anc=anc_dev, block_map=block_map,
        S_lvl=S_lvl, n_rounds_lvl=R_lvl, send_idx_lvl=si_lvl,
        send_mask_lvl=sm_lvl, round_perms_lvl=perms_lvl,
        _pack_blk=own, _pack_pos=pos_edge, _pack_dst=dst)
    report = _maybe_verify(dict(fields, _replan=replan_cache), validate)
    plan = tree_plan_from_arrays(fields, device)
    plan._replan = replan_cache
    plan.verify_report = report
    return plan


def build_plan_hier(indptr: np.ndarray, indices: np.ndarray,
                    data: np.ndarray, part: np.ndarray,
                    pods, k: int, device=None,
                    validate: bool | None = None) -> TreePlan:
    """Build the two-level distributed plan for a multi-pod mesh — the
    ``h == 2`` instance of :func:`build_plan_tree`.

    ``pods`` is either the pod count (blocks are grouped contiguously —
    block b goes to pod ``b // (k // pods)``, matching
    ``core.topology.Topology.pod_assignment``: Algorithm-1 orders fast PUs
    first, so the fast PUs that share the heaviest cut land in one pod) or
    an explicit (k,) pod id per block — e.g. the partition-derived
    assignment of the reference's ``core.api.partition_hier`` /
    ``pod_assignment_for`` (generally non-contiguous after the pod-level
    sweep).  Pods must be
    equal-sized (the mesh is rectangular).
    """
    # one validation definition shared with the partitioner side
    pod_of_block = normalize_pod_of(pods, k)
    return build_plan_tree(indptr, indices, data, part,
                           pod_of_block[None, :], k, device=device,
                           validate=validate)


# --------------------------------------------------------------------------
# Stacked runtime: all k blocks in one (k, B) tensor on one device
# --------------------------------------------------------------------------

COMM_MODES = ("halo", "halo_seq", "allgather", "hier")
LOCAL_FORMATS = ("coo", "bell")


def _round_tables(round_perms, n_rounds: int, k: int, size: int,
                  device, dtype):
    """Per round, the (k,) source block each block receives from and the
    (k,) receive mask (0 where a block has no partner that round) — the
    stacked form of the round's ``ppermute`` pairs.  A pair ``(s, d)``
    indexes blocks within a group of ``size`` consecutive blocks and fires
    in every such group: a flat plan has one group of k; tree level l has
    one per subtree, ``size = prod(fanouts[h-1-l:])``."""
    src_of = np.tile(np.arange(k, dtype=np.int64), (n_rounds, 1))
    recv = np.zeros((n_rounds, k), dtype=np.float32)
    base = np.arange(0, k, size, dtype=np.int64)
    for c, perm in enumerate(round_perms):
        for s, d in perm:
            src_of[c, base + d] = base + s
            recv[c, base + d] = 1.0
    return (torch.from_numpy(src_of).to(device),
            torch.from_numpy(recv).to(device).to(dtype))


def _make_exchange(plan: DistPlan) -> Callable:
    """``x (k, B[, nb]) -> x_ext (k, W[, nb])``: x followed by every
    round's received slots, level by level for a :class:`TreePlan` (``[x |
    level-0 slots | ... | level-(h-1) slots]``), in the reference's slot
    layout.

    The closure keeps its slot layout, ``exchange.layout``: per level with
    slots, ``(level, first slot column, rounds, slots per round)`` — what
    the exchange audit (``repro_torch.analysis.trace``) decodes a probe's
    received slots with."""
    k = plan.k
    if isinstance(plan, TreePlan):
        levels = zip(plan.send_idx_lvl, plan.send_mask_lvl,
                     plan.round_perms_lvl, plan.level_sizes())
    else:
        levels = [(plan.send_idx, plan.send_mask, plan.round_perms, k)]
    tables, layout, off = [], [], plan.B
    for lvl, (send_idx, send_mask, perms, size) in enumerate(levels):
        R, S = send_idx.shape[1:]
        if R * S == 0:                  # a level with no rounds: no slots
            continue
        src_of, recv_mask = _round_tables(perms, R, k, size, plan.device,
                                          plan.vals.dtype)
        tables.append((send_idx.long().reshape(k, R * S), send_mask, src_of,
                       recv_mask[:, :, None],
                       torch.arange(R, device=plan.device)[:, None]))
        layout.append((lvl, off, R, S))
        off += R * S

    def exchange(x):
        parts = [x]
        cols = tuple(x.shape[2:])                # () or (nb,)
        for idx, mask, src_of, recv_mask, rounds in tables:
            gidx = idx.view(idx.shape + (1,) * len(cols)).expand(
                idx.shape + cols)
            sends = torch.gather(x, 1, gidx).view(mask.shape + cols)
            sends = sends * _bcol(mask, sends)
            recv = sends.transpose(0, 1)[rounds, src_of]
            recv = recv * _bcol(recv_mask, recv)
            parts.append(recv.transpose(0, 1).reshape((k, -1) + cols))
        return torch.cat(parts, dim=1)

    exchange.layout = tuple(layout)
    return exchange


def _flat_coo(rows, cols, vals, B: int, W: int):
    """(k, nnz) block-local padded COO -> flat (k*B,) row and (k*W,) column
    indices and flat values, so a matvec is a few whole-tensor launches."""
    boff = torch.arange(rows.shape[0], dtype=torch.int64,
                        device=rows.device)[:, None]
    return ((boff * B + rows.long()).reshape(-1),
            (boff * W + cols.long()).reshape(-1), vals.reshape(-1))


def _bcol(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Align a per-row weight or mask with ``x``'s trailing RHS axes (the
    reference's ``_bcol``)."""
    return m.reshape(tuple(m.shape) + (1,) * (x.dim() - m.dim()))


def _accumulate(y, coo, xw):
    """y[rows] += vals * xw[cols] over flat indices (``index_add_``); ``y``
    is (k*B[, nb]) and ``xw`` (k, W[, nb])."""
    r, c, v = coo
    xf = xw.reshape((-1,) + tuple(xw.shape[2:]))[c]
    return y.index_add_(0, r, _bcol(v, xf) * xf)


def _check_modes(plan: DistPlan, comm: str, local_format: str) -> None:
    """The reference's argument checks, with its exception types."""
    if comm not in COMM_MODES:
        raise ValueError(f"unknown comm mode {comm!r}; choose {COMM_MODES}")
    if local_format not in LOCAL_FORMATS:
        raise ValueError(f"unknown local format {local_format!r}; "
                         f"choose {LOCAL_FORMATS}")
    if local_format == "bell" and comm not in ("halo", "hier"):
        raise ValueError("local_format='bell' requires comm='halo' or "
                         "'hier' (the interior/boundary split the kernel "
                         "is built from)")
    if isinstance(plan, TreePlan) != (comm == "hier"):
        raise ValueError(
            "comm='hier' requires a TreePlan (build_plan_tree / "
            "build_plan_hier) and a TreePlan only runs under comm='hier' "
            "— its halo layout has separate per-level slot ranges that "
            f"the flat schedules cannot address (got comm={comm!r}, "
            f"plan={type(plan).__name__})")


def make_dist_spmv(plan: DistPlan, comm: str = "halo",
                   local_format: str = "coo") -> Callable:
    """y = A @ x on (k, B) stacked block-major vectors, under the exchange
    schedule ``comm`` (see the module docstring) with the interior matvec
    in ``local_format``.  Index tensors are flattened over the block axis
    once, here.  The returned callable carries ``comm`` and its
    ``exchange`` (None under ``allgather``, whose flat padded-global COO
    is ``gathered``) for the exchange audit."""
    _check_modes(plan, comm, local_format)
    k, B = plan.k, plan.B
    row_mask = plan.row_mask
    tree = isinstance(plan, TreePlan)
    W = (int(plan.level_offsets()[-1]) if tree       # width of x_ext
         else B + plan.n_rounds * plan.S)

    def zeros(x):
        return torch.zeros((k * B,) + tuple(x.shape[2:]), dtype=x.dtype,
                           device=x.device)

    exchange = coo = None
    if comm == "allgather":
        # the gathered (k*B,) vector is the stacked tensor itself
        coo = _flat_coo(plan.rows, plan.cols_global, plan.vals, B, 0)

        def fn(x):
            return _accumulate(zeros(x), coo, x)
    elif comm == "halo_seq":
        exchange = _make_exchange(plan)
        every = _flat_coo(plan.rows, plan.cols, plan.vals, B, W)

        def fn(x):
            return _accumulate(zeros(x), every, exchange(x))
    else:                                        # halo, hier
        exchange = _make_exchange(plan)
        segs = (zip(plan.rows_bnd_lvl, plan.cols_bnd_lvl, plan.vals_bnd_lvl)
                if tree else [(plan.rows_bnd, plan.cols_bnd, plan.vals_bnd)])
        bnd = [_flat_coo(*seg, B, W) for seg in segs]
        if local_format == "coo":
            inner = _flat_coo(plan.rows_int, plan.cols_int, plan.vals_int,
                              B, B)

            def interior(x):
                return _accumulate(zeros(x), inner, x)
        else:
            blocks, bcols = plan.bell_local()
            index = plan.bell_index()

            def interior(x):
                if x.dim() > 2:
                    raise ValueError(
                        "local_format='bell' is single-RHS (the block-ELL "
                        "interior of the distributed schedules is a vector "
                        "kernel, as in the reference); use "
                        "local_format='coo' for batched solves")
                return spmv_block_ell(blocks, bcols, x,
                                      index=index).reshape(-1)

        def fn(x):
            y = interior(x)                      # no halo dependence
            x_ext = exchange(x)
            for seg in bnd:                      # innermost level first
                y = _accumulate(y, seg, x_ext)
            return y

    def matvec(x):
        if tuple(x.shape[:2]) != (k, B) or x.dim() > 3:
            raise ValueError(f"operand of shape {tuple(x.shape)} is not "
                             f"({k}, {B}) or ({k}, {B}, nb)")
        return fn(x).view(x.shape) * _bcol(row_mask, x)

    matvec.batch_native = True
    matvec.comm = comm
    matvec.exchange = exchange
    matvec.gathered = coo
    return matvec


def block_jacobi_preconditioner(plan: DistPlan) -> Callable:
    """z = M^-1 r with M = blockdiag(A_bb), the per-PU diagonal blocks
    (:meth:`DistPlan.block_jacobi_inv`), as one batched ``(k, B, B) x
    (k, B[, nb])`` product.  Ghost rows are identity in M^-1 and their
    residuals exactly zero, so padding stays out of the Krylov space."""
    minv = plan.block_jacobi_inv()

    def apply(r):
        if r.dim() == 3:
            return torch.bmm(minv.to(r.dtype), r)
        return torch.bmm(minv.to(r.dtype), r.unsqueeze(-1)).squeeze(-1)

    apply.batch_native = True
    return apply


def make_dist_cg(plan: DistPlan, tol: float = 1e-6, max_iters: int = 500,
                 comm: str = "halo", local_format: str = "coo",
                 precondition: str | None = None) -> Callable:
    """Whole-CG solve on (k, B) operands: the chunked ``cg.cg_solve`` with
    the stacked matvec and the ``row_mask``-weighted dot (the reference's
    psum-reduced local dot).  A (k, B, nb) operand runs the multi-RHS
    masked loop and gives (nb,) residuals and iterations.
    ``precondition='jacobi'`` uses the plan's on-device diagonal,
    ``'block_jacobi'`` the per-PU diagonal blocks.  Returns ``solve(b) ->
    (x, residual, iters)``."""
    if precondition not in (None, "jacobi", "block_jacobi"):
        raise ValueError(f"unknown precondition {precondition!r}")
    matvec = make_dist_spmv(plan, comm, local_format)
    row_mask = plan.row_mask
    prec = None
    if precondition == "jacobi":
        prec = jacobi_preconditioner(plan.diag)
    elif precondition == "block_jacobi":
        prec = block_jacobi_preconditioner(plan)

    def dot(u, v):
        return (u * _bcol(row_mask, u) * v).sum((0, 1))

    dot.batch_native = True                     # one sum per column

    def solve(b):
        res = cg_solve(matvec, b, tol=tol, max_iters=max_iters, dot=dot,
                       precondition=prec, batched=b.dim() == 3)
        return res.x, res.residual, res.iters

    return solve
