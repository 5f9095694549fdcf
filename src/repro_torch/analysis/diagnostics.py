"""Structured diagnostics shared by the analysis passes — the port of
``src/repro/analysis/diagnostics.py``.

Every check emits :class:`Diagnostic` records (a stable ``code``, a
human-readable message, and a machine-readable ``details`` dict) into a
:class:`Report` instead of raising at the first failure, so one verifier
run over a corrupted plan names *every* violated invariant — the mutation
suite asserts on codes, the CLI prints them, and the build-time
``validate=`` hook raises :class:`PlanVerificationError` carrying the
whole report.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One violated invariant (or lint finding).

    ``code`` is the stable identifier (``PLAN0xx`` / ``PART0xx`` for the
    plan and partition verifier, ``TORCH0xx`` for the lint, ``TRACE0xx``
    for the exchange audit); ``where`` locates it (a plan context like
    ``level 1 round 2`` or a ``path:line`` for lint findings); ``details``
    carries whatever small arrays/scalars made the check fail, for
    programmatic consumers.
    """

    code: str
    message: str
    where: str = ""
    details: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.code}{loc}: {self.message}"

    def to_dict(self) -> dict[str, Any]:
        return {"code": self.code, "message": self.message,
                "where": self.where, "details": jsonable(self.details)}


@dataclasses.dataclass
class Report:
    """Outcome of one analysis pass over one subject."""

    subject: str
    diagnostics: list[Diagnostic] = dataclasses.field(default_factory=list)
    # side-channel results (e.g. the per-level partner table)
    info: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.diagnostics

    def add(self, code: str, message: str, where: str = "",
            **details: Any) -> None:
        self.diagnostics.append(Diagnostic(code=code, message=message,
                                           where=where, details=details))

    def codes(self) -> set[str]:
        return {d.code for d in self.diagnostics}

    def raise_for_errors(self) -> None:
        if self.diagnostics:
            raise PlanVerificationError(self)

    def __str__(self) -> str:
        if self.ok:
            return f"{self.subject}: OK"
        lines = [f"{self.subject}: {len(self.diagnostics)} violation(s)"]
        lines += [f"  {d}" for d in self.diagnostics]
        return "\n".join(lines)

    def to_dict(self) -> dict[str, Any]:
        """JSON-ready form — the ``--format=json`` CLI payload."""
        return {"subject": self.subject, "ok": self.ok,
                "diagnostics": [d.to_dict() for d in self.diagnostics],
                "info": jsonable(self.info)}


def jsonable(x: Any) -> Any:
    """Best-effort conversion to JSON-serializable types: tensors (copied
    to the host), numpy scalars and arrays, tuples, non-string dict keys,
    and result dataclasses that expose ``to_dict`` all flatten; anything
    unknown falls back to ``repr`` rather than failing the dump."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").tolist()
    if hasattr(x, "to_dict"):
        return jsonable(x.to_dict())
    if hasattr(x, "item") and not hasattr(x, "__len__"):    # numpy scalar
        return x.item()
    if hasattr(x, "tolist"):                                # numpy array
        return x.tolist()
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, set, frozenset)):
        return [jsonable(v) for v in x]
    return repr(x)


def validate_requested(validate: bool | None) -> bool:
    """Whether a builder's ``validate=`` asks for the verifier:
    ``None`` defers to the ``REPRO_VALIDATE`` environment variable (the
    test suite's conftest turns it on; otherwise builds skip the pass
    unless asked), as in the reference."""
    if validate is None:
        validate = os.environ.get("REPRO_VALIDATE", "0") not in ("", "0")
    return bool(validate)


class PlanVerificationError(ValueError):
    """A plan (or partition) failed structural verification.

    Subclasses ``ValueError`` so existing callers treating bad plan inputs
    as value errors keep working; ``.report`` carries the diagnostics.
    """

    def __init__(self, report: Report):
        self.report = report
        super().__init__(str(report))
