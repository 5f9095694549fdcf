"""The Operator protocol — one interface over the port's SpMV backends (the
port of ``src/repro/sparse/operator.py``):

  * ``coo``       — single-device padded-COO ``index_add_`` (spmv.py);
  * ``bell``      — the block-ELL CUDA kernel (kernels/spmv_bell.py);
  * ``dist_halo`` — the stacked distributed runtime, overlapped halo
                    exchange with a padded-COO interior matvec;
  * ``dist_bell`` — the same with the interior matvec in the block-ELL
                    kernel.

An Operator has ``n``, ``matvec(x)`` and ``dot(u, v)`` in operator space
((n,) single-device, (k, B) padded block-major distributed), ``diag()``,
``scatter(x)`` (host (n,) vector -> operator space on the device) and
``gather(y)`` (operator space -> host (n,) vector).  Host float64 input is
narrowed to float32, as ``jnp.asarray`` does in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from ..device import as_float, resolve_device, to_device
from ..kernels.spmv_bell import csr_to_block_ell, spmv_block_ell
from .cg import CGResult, cg_solve, vdot
from .distributed import DistPlan, build_plan, make_dist_cg, make_dist_spmv
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
    on the device, ready for ``index_add_``."""

    n: int
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor

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

    def dot(self, u, v):
        return vdot(u, v)

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
    """Block-ELL SpMV through the CUDA kernel (its plain version on the
    CPU)."""

    n: int
    blocks: torch.Tensor
    cols: torch.Tensor
    diag_: torch.Tensor

    @classmethod
    def from_csr(cls, indptr, indices, data, bm: int = 8, bk: int = 128,
                 nnzb: int | None = None, device=None):
        device = resolve_device(device)
        n = len(indptr) - 1
        blocks, cols, _meta = csr_to_block_ell(indptr, indices, data, n,
                                               bm=bm, bk=bk, nnzb=nnzb)
        return cls(n=n, blocks=to_device(blocks, device),
                   cols=torch.from_numpy(cols).to(device),
                   diag_=to_device(csr_diagonal(indptr, indices, data),
                                   device))

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def matvec(self, x):
        return spmv_block_ell(self.blocks, self.cols, x)

    def dot(self, u, v):
        return vdot(u, v)

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
    """Stacked distributed SpMV over a partition plan; operator space is
    the (k, B) padded block-major layout, and ``dot`` is a plain sum
    because ghost rows are zero in both vectors.  ``solve`` runs the whole
    CG with the ``row_mask``-weighted dot of the reference's fused
    program."""

    plan: DistPlan
    comm: str = "halo"
    local_format: str = "coo"

    def __post_init__(self):
        self.n = self.plan.n
        self._spmv = make_dist_spmv(self.plan, comm=self.comm,
                                    local_format=self.local_format)
        self._fused = {}   # (tol, max_iters, precondition) -> solver

    @classmethod
    def from_csr(cls, indptr, indices, data, part, k, comm: str = "halo",
                 local_format: str = "coo", device=None):
        plan = build_plan(indptr, indices, data, part, k, device=device)
        return cls(plan=plan, comm=comm, local_format=local_format)

    @property
    def device(self) -> torch.device:
        return self.plan.device

    def matvec(self, x):
        return self._spmv(x)

    def dot(self, u, v):
        return vdot(u, v)

    def diag(self):
        return self.plan.diag

    def scatter(self, x):
        return to_device(self.plan.scatter_vec(as_float(x)), self.device)

    def gather(self, y):
        return self.plan.gather_vec(y)

    def solve(self, b, tol: float = 1e-6, max_iters: int = 500,
              precondition: str | None = None) -> CGResult:
        """Whole CG on a (n,) global right-hand side (host array);
        returns the result in operator space."""
        key = (tol, max_iters, precondition)
        fused = self._fused.get(key)
        if fused is None:
            fused = self._fused[key] = make_dist_cg(
                self.plan, tol=tol, max_iters=max_iters, comm=self.comm,
                local_format=self.local_format, precondition=precondition)
        x, res, it = fused(self.scatter(b))
        return CGResult(x=x, iters=it, residual=res)


# --------------------------------------------------------------------------
# Factory + harness entry point
# --------------------------------------------------------------------------

BACKENDS = ("coo", "bell", "dist_halo", "dist_bell")
_REFERENCE_BACKENDS = ("dist_halo_seq", "dist_allgather", "dist_hier",
                       "dist_hier_bell")
_DIST_MODES = {"dist_halo": ("halo", "coo"), "dist_bell": ("halo", "bell")}


def make_operator(indptr, indices, data, backend: str = "coo", *,
                  part=None, k: int | None = None, device=None,
                  **kw) -> Operator:
    """One factory for the ported backends (see BACKENDS), on ``device``
    (default the card).  The distributed backends need ``part=`` and
    ``k=``; the reference's mesh becomes the one device."""
    device = resolve_device(device)
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
    if backend in _REFERENCE_BACKENDS:
        raise NotImplementedError(f"backend {backend!r} is not ported yet; "
                                  "see ROADMAP.md queue 1 item 5")
    raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")


def cg_solve_global(op: Operator, b: np.ndarray, tol: float = 1e-6,
                    max_iters: int = 500, precondition: str | None = None,
                    device=None) -> tuple[np.ndarray, int, float]:
    """Scatter -> CG -> gather.  Returns (x_global, iters, res) on the
    host.  ``device`` (default the card) must be the operator's device."""
    device = resolve_device(device)
    if op.device.type != device.type:
        raise ValueError(f"operator lives on {op.device}, not {device}")
    if np.ndim(b) != 1:
        raise NotImplementedError("batched RHS is not ported yet; see "
                                  "ROADMAP.md queue 1 item 7")
    res = cg_solve(op, op.scatter(b), tol=tol, max_iters=max_iters,
                   precondition=precondition)
    return (op.gather(res.x), int(res.iters.cpu()),
            float(res.residual.cpu()))
