"""Static analysis for the port's distributed-plan pipeline — the torch
counterpart of ``src/repro/analysis/``.

  * ``verify``  — the structural verifier over ``DistPlan`` / ``TreePlan``
                  invariants (PLAN0xx) and ``HierPartition`` results
                  (PART0xx): the reference's host NumPy, copied, reporting
                  its codes on the same plan.  ``build_plan`` and its kin
                  run it on their host arrays under ``validate=`` /
                  ``REPRO_VALIDATE`` (on in the test suite via conftest);
  * ``lint``    — custom AST lint (TORCH001+): ``torch.distributed``
                  outside a comm module, blanket ``except: pass``,
                  unseeded global RNG and host syncs in solver paths;
  * ``trace``   — the exchange audit (TRACE001+): one matvec and one CG
                  chunk of an operator run on its device, what its
                  exchange delivers held against a plan's rounds, and the
                  dtype flow of every aten op.

``python -m repro_torch.analysis`` is the CLI (``lint`` / ``verify`` /
``partners`` / ``trace``, ``--format=text|json|github``).
"""
from .diagnostics import (Diagnostic, PlanVerificationError, Report,
                          validate_requested)
from .lint import LINT_RULES, lint_paths
from .trace import TRACE_RULES, ExchangeRecord, audit_backend, audit_operator
from .verify import partner_table, verify_partition, verify_plan

__all__ = [
    "Diagnostic", "PlanVerificationError", "Report", "validate_requested",
    "verify_plan", "verify_partition", "partner_table",
    "lint_paths", "LINT_RULES",
    "audit_operator", "audit_backend", "ExchangeRecord", "TRACE_RULES",
]
