"""Conjugate-gradient solver (Sec. VI-a: CG on systems derived from the
graph's Laplacian) — the port of ``src/repro/sparse/cg.py`` (plain and
preconditioned single-RHS modes: Jacobi, block-Jacobi through a
distributed Operator, or a callable M^-1).

The reference runs one ``lax.while_loop`` whose stop test stays on the
device.  In eager PyTorch a stop test per iteration would be a host sync
per iteration, so the port runs *chunks* of ``CHUNK`` iterations: inside a
chunk, the on-device flag ``active = (rs > tol2) & (it < max_iters)``
zeroes alpha and the ``it`` increment and keeps p and rs once the solve has
converged, so the extra iterations change nothing and ``x`` and ``iters``
match the reference loop.  The host reads the flag once per chunk, before
launching the next one.

The operator is a bare matvec callable or an Operator (``matvec`` / ``dot``
/ ``diag``).  All epsilon guards follow the dtype (``torch.finfo``): a
near-zero alpha/beta denominator yields a zero step instead of an overflow,
and the ``tol2`` floor never asks for a residual below the smallest normal.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

CHUNK = 8           # iterations between two host reads of the stop flag


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor         # 0-d int32
    residual: torch.Tensor      # 0-d, sqrt of the last ||r||^2


def jacobi_preconditioner(diag: torch.Tensor) -> Callable:
    """M^-1 r = r / diag(A), with zero diagonal entries (padded ghost rows
    in the distributed layout) passed through as zero — ghost residuals are
    exactly zero, so this keeps them out of the Krylov space."""
    nz = diag != 0
    inv = torch.where(nz, 1.0 / torch.where(nz, diag, torch.ones_like(diag)),
                      torch.zeros_like(diag))

    def apply(r):
        return r * inv

    return apply


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, or 0 where |den| is at or below the smallest normal of
    its dtype."""
    tiny = torch.finfo(den.dtype).tiny
    ok = den.abs() > tiny
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _tol2_floor(tol: float, b2: torch.Tensor) -> torch.Tensor:
    """Squared absolute tolerance ``tol^2 ||b||^2``, with ``b2`` and the
    product floored to the smallest normal: a zero RHS converges at once,
    and the test never asks for a residual the dtype cannot represent."""
    tiny = torch.finfo(b2.dtype).tiny
    return torch.clamp(tol * tol * torch.clamp(b2, min=tiny), min=tiny)


def vdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Inner product over every element (operator space may be 2-D)."""
    return (u * v).sum()


def _resolve_operator(matvec, dot, precondition):
    """Unpack an Operator (matvec/dot/preconditioner).  Returns
    ``(matvec, dot, precondition)``."""
    if hasattr(matvec, "matvec"):
        op = matvec
        matvec = op.matvec
        dot = dot or getattr(op, "dot", None)
        if precondition == "jacobi":
            precondition = jacobi_preconditioner(op.diag())
        elif precondition == "block_jacobi":
            bj = getattr(op, "block_jacobi_preconditioner", None)
            if bj is None:
                raise ValueError(
                    "precondition='block_jacobi' needs an Operator with "
                    "per-PU blocks (DistributedOperator); "
                    f"{type(op).__name__} has none")
            precondition = bj()
    if isinstance(precondition, str):
        raise ValueError(f"precondition={precondition!r} needs an Operator "
                         "(jacobi: any backend with diag(); block_jacobi: "
                         "distributed backends); pass a callable M^-1 "
                         "instead")
    return matvec, dot or vdot, precondition


def _host_flag(flag: torch.Tensor) -> bool:
    """The solver's one device-to-host read per chunk: copy the 0-d
    ``active`` flag to the host and test it."""
    return bool(flag.to("cpu"))


def cg_solve(matvec: Callable[[torch.Tensor], torch.Tensor],
             b: torch.Tensor, x0: torch.Tensor | None = None,
             tol: float = 1e-6, max_iters: int = 500,
             dot: Callable | None = None,
             precondition: str | Callable | None = None,
             batched: bool = False) -> CGResult:
    """CG / preconditioned CG on ``b``'s device.

    ``precondition`` is ``None`` (plain CG), a callable ``z = M^-1(r)``,
    ``'jacobi'`` (through the Operator's ``diag()``) or ``'block_jacobi'``
    (through a distributed Operator's per-PU blocks).  Convergence is always
    tested on the unpreconditioned residual ||r||^2 <= tol^2 ||b||^2.
    The result does not depend on ``CHUNK``.
    """
    if batched:
        raise NotImplementedError(
            "batched multi-RHS CG is not ported yet; see ROADMAP.md queue 1 "
            "item 7 (serving slice)")
    matvec, dot, M = _resolve_operator(matvec, dot, precondition)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - matvec(x)
    tol2 = _tol2_floor(tol, dot(b, b))
    it = torch.zeros((), dtype=torch.int32, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)

    if M is not None:
        z = M(r)
        p = z
        rz = dot(r, z)
        rr = dot(r, r)
    else:
        p = r
        rr = dot(r, r)

    def active():
        return (rr > tol2) & (it < max_iters)

    while _host_flag(active()):
        for _ in range(CHUNK):
            act = active()
            ap = matvec(p)
            if M is not None:
                alpha = torch.where(act, _safe_div(rz, dot(p, ap)), zero)
                x = x + alpha * p
                r = r - alpha * ap
                z = M(r)
                rz_new = dot(r, z)
                p = torch.where(act, z + _safe_div(rz_new, rz) * p, p)
                rz = torch.where(act, rz_new, rz)
                rr = torch.where(act, dot(r, r), rr)
            else:
                alpha = torch.where(act, _safe_div(rr, dot(p, ap)), zero)
                x = x + alpha * p
                r = r - alpha * ap
                rs_new = dot(r, r)
                p = torch.where(act, r + _safe_div(rs_new, rr) * p, p)
                rr = torch.where(act, rs_new, rr)
            it = it + act.to(torch.int32)
    return CGResult(x=x, iters=it, residual=torch.sqrt(rr))
