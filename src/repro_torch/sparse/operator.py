"""The Operator protocol — one interface over the port's SpMV backends (the
port of ``src/repro/sparse/operator.py``, all eight of its backends):

  * ``coo``            — single-device padded-COO ``index_add_`` (spmv.py);
  * ``bell``           — the block-ELL SpMV (kernels/spmv_bell.py, the
                         sell route over the blocks' nonzeros);
  * ``dist_halo``      — the stacked distributed runtime: interior rows,
                         halo rounds, boundary rows, padded-COO interior;
  * ``dist_halo_seq``  — every halo round, then one matvec over all rows;
  * ``dist_bell``      — ``dist_halo`` with the interior matvec in the
                         block-ELL kernel;
  * ``dist_allgather`` — the whole padded vector, then a matvec over
                         global columns (the partitioner-oblivious
                         baseline);
  * ``dist_hier``      — the per-tree-level schedule over a tree plan
                         (``pods=``, ``fanouts=`` or ``tree=``);
  * ``dist_hier_bell`` — ``dist_hier`` with the block-ELL interior.

An Operator has ``n``, ``matvec(x)`` and ``dot(u, v)`` in operator space
((n,) single-device, (k, B) padded block-major distributed), ``diag()``,
``scatter(x)`` (host (n,) vector -> operator space on the device) and
``gather(y)`` (operator space -> host (n,) vector).  An (n, nb) RHS batch
scatters to (n, nb) / (k, B, nb) and gathers back.  Host float64 input is
narrowed to float32, as ``jnp.asarray`` does in the reference.

``batch_native`` (every backend but ``dist_bell`` / ``dist_hier_bell``,
which raise on a batched operand as the reference does): the matvec takes
a trailing RHS axis whole, so batched CG hands it the (..., nb) operand.
``bell`` is batch native through its multi-column kernel, where the
reference ``jax.vmap``s its Pallas kernel over the columns.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from ..device import as_float, resolve_device, to_device
from ..kernels.spmv_bell import (BellIndex, bell_index,
                                 csr_to_block_ell, spmv_block_ell)
from .cg import CGResult, cg_solve, vdot
from .distributed import (DistPlan, block_jacobi_preconditioner,
                          build_plan, build_plan_tree, make_dist_cg,
                          make_dist_spmv)
from .spmv import csr_diagonal, csr_to_padded_coo, spmv_coo


@runtime_checkable
class Operator(Protocol):
    """Structural protocol — see module docstring for the contract."""

    n: int

    def matvec(self, x): ...

    def dot(self, u, v): ...

    def diag(self): ...

    def scatter(self, x): ...

    def gather(self, y): ...


# --------------------------------------------------------------------------
# Single-device backends
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CooOperator:
    """Padded-COO SpMV (any sparsity).  ``rows``/``cols`` are held as int64
    on the device, ready for ``index_add_``, which carries a trailing RHS
    axis through natively."""

    n: int
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor

    batch_native = True
    dot = staticmethod(vdot)

    @classmethod
    def from_csr(cls, indptr, indices, data, nnz_pad: int | None = None,
                 device=None):
        device = resolve_device(device)
        rows, cols, vals = csr_to_padded_coo(indptr, indices, data,
                                             nnz_pad=nnz_pad)
        return cls(n=len(indptr) - 1,
                   rows=torch.from_numpy(rows.astype(np.int64)).to(device),
                   cols=torch.from_numpy(cols.astype(np.int64)).to(device),
                   vals=to_device(vals, device))

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def matvec(self, x):
        return spmv_coo(self.rows, self.cols, self.vals, x, n=self.n)

    def diag(self):
        """On-device diagonal extraction from the padded-COO triples."""
        on_diag = torch.where(self.rows == self.cols, self.vals,
                              torch.zeros_like(self.vals))
        return torch.zeros(self.n, dtype=self.vals.dtype,
                           device=self.device).index_add_(0, self.rows,
                                                          on_diag)

    def scatter(self, x):
        return to_device(as_float(x), self.device)

    def gather(self, y):
        return y.cpu().numpy()


@dataclasses.dataclass
class BlockEllOperator:
    """Block-ELL SpMV through the sell route (its plain version on the
    CPU): the blocks' nonzero entries, indexed once by
    :func:`~repro_torch.kernels.spmv_bell.bell_index`, for an (n,) operand
    and for an (n, nb) batch alike."""

    n: int
    blocks: torch.Tensor
    cols: torch.Tensor
    diag_: torch.Tensor
    index: BellIndex

    batch_native = True
    dot = staticmethod(vdot)

    @classmethod
    def from_csr(cls, indptr, indices, data, bm: int = 8, bk: int = 128,
                 nnzb: int | None = None, device=None):
        device = resolve_device(device)
        n = len(indptr) - 1
        blocks, cols, _meta = csr_to_block_ell(indptr, indices, data, n,
                                               bm=bm, bk=bk, nnzb=nnzb)
        blocks = to_device(blocks, device)
        cols = torch.from_numpy(cols).to(device)
        return cls(n=n, blocks=blocks, cols=cols,
                   diag_=to_device(csr_diagonal(indptr, indices, data),
                                   device),
                   index=bell_index(blocks, cols, n))

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def matvec(self, x):
        return spmv_block_ell(self.blocks, self.cols, x, index=self.index)

    def diag(self):
        return self.diag_

    def scatter(self, x):
        return to_device(as_float(x), self.device)

    def gather(self, y):
        return y.cpu().numpy()


# --------------------------------------------------------------------------
# Distributed backend (stacked on one device)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DistributedOperator:
    """Stacked distributed SpMV over a partition plan.

    ``comm`` picks the exchange schedule — ``'halo'`` (interior rows
    first, the default), ``'halo_seq'`` (sequential), ``'allgather'``
    (partitioner-oblivious baseline) or ``'hier'`` (per tree level; needs
    a ``TreePlan``, see :meth:`from_csr`); ``local_format`` picks the
    interior matvec — ``'coo'`` ``index_add_`` or ``'bell'`` (the
    block-ELL kernel; ``comm='halo'`` or ``'hier'``).

    Operator space is the (k, B[, nb]) padded block-major layout, and
    ``dot`` is a plain sum because ghost rows are zero in both vectors.
    ``solve`` runs the whole CG with the ``row_mask``-weighted dot of the
    reference's fused program.  ``batch_native``: the schedules carry a
    trailing RHS axis; ``local_format='bell'`` raises ``ValueError`` on it,
    as the reference does."""

    plan: DistPlan
    comm: str = "halo"
    local_format: str = "coo"

    batch_native = True
    dot = staticmethod(vdot)

    def __post_init__(self):
        self.n = self.plan.n
        self._spmv = make_dist_spmv(self.plan, comm=self.comm,
                                    local_format=self.local_format)
        self._fused = {}   # (tol, max_iters, precondition) -> solver

    @classmethod
    def from_csr(cls, indptr, indices, data, part, k, comm: str = "halo",
                 local_format: str = "coo", pods=None, fanouts=None,
                 tree=None, device=None, validate: bool | None = None):
        """``comm='hier'`` builds the tree plan — ``pods`` (pod count or
        explicit (k,) pod-of-block array) for the two-level instance,
        ``fanouts`` / ``tree`` ((k_1, ..., k_h) tuple / explicit (h-1, k)
        ancestor table) for any depth; every other ``comm`` the flat
        plan.  ``validate`` goes to ``build_plan`` / ``build_plan_tree``
        (None: the ``REPRO_VALIDATE`` environment variable)."""
        if comm == "hier":
            if pods is None and fanouts is None and tree is None:
                raise ValueError(
                    "comm='hier' needs pods= (pod count or (k,) "
                    "pod-of-block array), fanouts= ((k_1, ..., k_h) "
                    "tree shape) or tree= ((h-1, k) ancestor table)")
            if pods is not None and tree is not None:
                raise ValueError("pass either pods= or tree=, not both")
            plan = build_plan_tree(indptr, indices, data, part,
                                   pods if pods is not None else tree,
                                   k, fanouts=fanouts, device=device,
                                   validate=validate)
        else:
            if pods is not None or fanouts is not None or tree is not None:
                raise ValueError("pods=/fanouts=/tree= only apply to "
                                 "comm='hier'")
            plan = build_plan(indptr, indices, data, part, k, device=device,
                              validate=validate)
        return cls(plan=plan, comm=comm, local_format=local_format)

    @property
    def device(self) -> torch.device:
        return self.plan.device

    def matvec(self, x):
        return self._spmv(x)

    def diag(self):
        return self.plan.diag

    def block_jacobi_preconditioner(self):
        """z = M^-1 r with M = blockdiag(A_bb): one batched (B, B) product
        per block (one ``bmm`` over an RHS batch) from the plan's cached
        inverses."""
        return block_jacobi_preconditioner(self.plan)

    def fused_solver(self, tol: float = 1e-6, max_iters: int = 500,
                     precondition: str | None = None):
        """The cached whole-CG solver on *operator-space* operands
        ((k, B[, nb]) -> (x, residual, iters)) — what :meth:`solve` runs
        after scattering."""
        key = (tol, max_iters, precondition)
        fused = self._fused.get(key)
        if fused is None:
            fused = self._fused[key] = make_dist_cg(
                self.plan, tol=tol, max_iters=max_iters, comm=self.comm,
                local_format=self.local_format, precondition=precondition)
        return fused

    def scatter(self, x):
        return to_device(self.plan.scatter_vec(as_float(x)), self.device)

    def gather(self, y):
        return self.plan.gather_vec(y)

    def solve(self, b, tol: float = 1e-6, max_iters: int = 500,
              precondition: str | None = None) -> CGResult:
        """Whole CG on a (n,) global right-hand side (host array), or an
        (n, nb) RHS batch, which runs the multi-RHS masked loop and returns
        per-column iters / residual; the result is in operator space."""
        fused = self.fused_solver(tol, max_iters, precondition)
        x, res, it = fused(self.scatter(b))
        return CGResult(x=x, iters=it, residual=res)


# --------------------------------------------------------------------------
# Factory + harness entry point
# --------------------------------------------------------------------------

BACKENDS = ("coo", "bell", "dist_halo", "dist_halo_seq", "dist_bell",
            "dist_allgather", "dist_hier", "dist_hier_bell")

_DIST_MODES = {
    "dist_halo": ("halo", "coo"),
    "dist_halo_seq": ("halo_seq", "coo"),
    "dist_bell": ("halo", "bell"),
    "dist_allgather": ("allgather", "coo"),
    "dist_hier": ("hier", "coo"),
    "dist_hier_bell": ("hier", "bell"),
}

_HIER_BACKENDS = ("dist_hier", "dist_hier_bell")


def make_operator(indptr, indices, data, backend: str = "coo", *,
                  part=None, k: int | None = None, device=None,
                  **kw) -> Operator:
    """One factory for every backend (see BACKENDS), on ``device``
    (default the card).  The distributed backends need ``part=`` and
    ``k=``; the reference's mesh becomes the one device.  ``dist_hier`` /
    ``dist_hier_bell`` also need ``pods=``, ``fanouts=`` or ``tree=``.

    ``part`` may also be a hierarchical partition (duck-typed on
    ``.part`` / ``.pod_of``, as the reference's ``core.api.HierPartition``
    is): the block partition, ``k`` and, for the hier backends, its
    ancestor table (``.anc``, else ``.pod_of``) are unpacked from it."""
    device = resolve_device(device)
    if part is not None and hasattr(part, "part") and hasattr(part,
                                                              "pod_of"):
        hp = part
        part = np.asarray(hp.part)
        if k is None:
            k = hp.k
        if backend in _HIER_BACKENDS and "pods" not in kw:
            kw.setdefault("tree", np.asarray(hp.anc)
                          if getattr(hp, "anc", None) is not None
                          else np.asarray(hp.pod_of))
    if backend == "coo":
        return CooOperator.from_csr(indptr, indices, data, device=device,
                                    **kw)
    if backend == "bell":
        return BlockEllOperator.from_csr(indptr, indices, data,
                                         device=device, **kw)
    if backend in _DIST_MODES:
        if part is None or k is None:
            raise ValueError(f"{backend} needs part=, k=")
        comm, local_format = _DIST_MODES[backend]
        return DistributedOperator.from_csr(indptr, indices, data, part, k,
                                            comm=comm,
                                            local_format=local_format,
                                            device=device, **kw)
    raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")


def cg_solve_global(op: Operator, b: np.ndarray, tol: float = 1e-6,
                    max_iters: int = 500, precondition: str | None = None,
                    device=None) -> tuple[np.ndarray, int, float]:
    """Scatter -> CG -> gather.  Returns (x_global, iters, res) on the
    host.  ``device`` (default the card) must be the operator's device.

    A 2-D ``b`` of shape (n, nb) is an RHS batch: the multi-RHS masked
    loop runs every column and iters / res come back as (nb,) arrays."""
    device = resolve_device(device)
    if op.device.type != device.type:
        raise ValueError(f"operator lives on {op.device}, not {device}")
    batched = np.ndim(b) == 2
    res = cg_solve(op, op.scatter(b), tol=tol, max_iters=max_iters,
                   precondition=precondition, batched=batched)
    if batched:
        return (op.gather(res.x), res.iters.cpu().numpy(),
                res.residual.cpu().numpy())
    return (op.gather(res.x), int(res.iters.cpu()),
            float(res.residual.cpu()))
