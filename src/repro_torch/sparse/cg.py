"""Conjugate-gradient solver (Sec. VI-a: CG on systems derived from the
graph's Laplacian) — the port of ``src/repro/sparse/cg.py``: plain and
preconditioned CG (Jacobi, block-Jacobi through a distributed Operator, or
a callable M^-1), single-RHS or batched over a trailing RHS axis.

The reference runs one ``lax.while_loop`` whose stop test stays on the
device.  In eager PyTorch a stop test per iteration would be a host sync
per iteration, so the port runs *chunks* of ``CHUNK`` iterations: inside a
chunk, the on-device flag ``active = (rs > tol2) & (it < max_iters)``
zeroes alpha and the ``it`` increment and keeps p and rs once the solve has
converged, so the extra iterations change nothing and ``x`` and ``iters``
match the reference loop.  The host reads the flag once per chunk, before
launching the next one.

Multi-RHS batching (``batched=True``): ``b`` carries a trailing RHS axis
(``(n, nb)`` single-device, ``(k, B, nb)`` distributed) and every column
advances in one loop with its own convergence mask: a finished column's
alpha and beta are masked to zero, so its x, r and p freeze while the
others go on, and ``iters`` / ``residual`` are ``(nb,)``.  The reference
``jax.vmap``s a single-column matvec, preconditioner and dot over the
columns; here a matvec or preconditioner that declares ``batch_native``
takes the ``(..., nb)`` operand whole, any other is applied column by
column, and so is a ``dot`` other than :func:`vdot` (whose batched form is
one sum per column).

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
    iters: torch.Tensor         # 0-d int32, or (nb,) per column if batched
    residual: torch.Tensor      # sqrt of the last ||r||^2, 0-d or (nb,)


def jacobi_preconditioner(diag: torch.Tensor) -> Callable:
    """M^-1 r = r / diag(A), with zero diagonal entries (padded ghost rows
    in the distributed layout) passed through as zero — ghost residuals are
    exactly zero, so this keeps them out of the Krylov space.  Batch
    native: an ``r`` with one more (trailing RHS) axis than ``diag`` is
    scaled column by column."""
    nz = diag != 0
    inv = torch.where(nz, 1.0 / torch.where(nz, diag, torch.ones_like(diag)),
                      torch.zeros_like(diag))

    def apply(r):
        return r * (inv[..., None] if r.dim() > inv.dim() else inv)

    apply.batch_native = True
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
    ``(matvec, dot, precondition, batch_native)``."""
    batch_native = bool(getattr(matvec, "batch_native", False))
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
    return matvec, dot or vdot, precondition, batch_native


def _host_flag(flag: torch.Tensor) -> bool:
    """The solver's one device-to-host read per chunk: copy the 0-d
    ``active`` flag to the host and test it."""
    return bool(flag.to("cpu"))


def _per_column(fn: Callable) -> Callable:
    """A single-column function applied to each column of a trailing RHS
    axis (the reference's ``jax.vmap(fn, in_axes=-1, out_axes=-1)``)."""
    def apply(x):
        return torch.stack([fn(x[..., j]) for j in range(x.shape[-1])],
                           dim=-1)
    return apply


def _column_dot(dot: Callable) -> Callable:
    """``(..., nb) x (..., nb) -> (nb,)`` from a dot: one sum per column
    for :func:`vdot`, a ``batch_native`` dot as it is, any other dot
    column by column."""
    if dot is vdot:
        return lambda u, v: (u * v).reshape(-1, u.shape[-1]).sum(0)
    if getattr(dot, "batch_native", False):
        return dot
    return lambda u, v: torch.stack([dot(u[..., j], v[..., j])
                                     for j in range(u.shape[-1])])


def _cg_solve_batched(matvec, b, x0, tol, max_iters, dot, M,
                      batch_native) -> CGResult:
    """Multi-RHS CG: all columns advance in one chunked loop; converged
    columns freeze (alpha/beta masked to zero) while the others iterate.
    The host reads ``active.any()`` once per chunk."""
    nb = b.shape[-1]
    mv = matvec if batch_native else _per_column(matvec)
    dotb = _column_dot(dot)
    Mb = None
    if M is not None:
        Mb = M if getattr(M, "batch_native", False) else _per_column(M)

    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - mv(x)
    tol2 = _tol2_floor(tol, dotb(b, b))                # (nb,)
    z = Mb(r) if Mb is not None else r
    p = z
    rz = dotb(r, z)
    rr = dotb(r, r)
    it = torch.zeros((nb,), dtype=torch.int32, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)

    def active():
        return (rr > tol2) & (it < max_iters)

    while _host_flag(active().any()):
        for _ in range(CHUNK):
            act = active()                             # (nb,) column masks
            ap = mv(p)
            # masked alpha: a converged column takes a zero step, so its
            # x and r stay frozen (the (nb,) scalars broadcast against the
            # trailing axis of the (..., nb) vectors)
            alpha = torch.where(act, _safe_div(rz, dotb(p, ap)), zero)
            x = x + alpha * p
            r = r - alpha * ap
            z = Mb(r) if Mb is not None else r
            rz_new = dotb(r, z)
            beta = torch.where(act, _safe_div(rz_new, rz), zero)
            p = torch.where(act, z + beta * p, p)
            rz = torch.where(act, rz_new, rz)
            rr = torch.where(act, dotb(r, r), rr)
            it = it + act.to(torch.int32)
    return CGResult(x=x, iters=it, residual=torch.sqrt(rr))


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
    ``batched=True`` treats the last axis of ``b`` as an RHS batch (see the
    module docstring); ``matvec`` / ``dot`` / ``precondition`` stay
    single-column unless they declare ``batch_native``.
    The result does not depend on ``CHUNK``.
    """
    matvec, dot, M, batch_native = _resolve_operator(matvec, dot,
                                                     precondition)
    if batched:
        return _cg_solve_batched(matvec, b, x0, tol, max_iters, dot, M,
                                 batch_native)
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
