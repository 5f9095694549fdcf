"""CLI for the port's analysis passes.

  python -m repro_torch.analysis lint src/repro_torch   # AST lint (TORCH0xx)
  python -m repro_torch.analysis verify                 # plan verifier sweep
  python -m repro_torch.analysis verify --fanouts 2,2,2 --generator rgg_2d
  python -m repro_torch.analysis partners --fanouts 2,2  # partner table
  python -m repro_torch.analysis trace                  # exchange audit
  python -m repro_torch.analysis trace --backend dist_hier --fanouts 2,2,2

``verify`` builds port plans (flat, and tree at each requested fanouts)
over the port's generators with a seeded random partition and runs every
PLAN0xx pass on their host arrays; ``trace`` builds each backend's
operator on a small fixture and audits one matvec and one CG chunk
(TRACE0xx).  ``verify`` checks host arrays, so it builds on the CPU
unless ``--device`` names another device; ``partners`` and ``trace``
build on the card, as every entry point of the port does, and raise
without one unless given ``--device cpu``.

Every subcommand exits 0 iff no pass reported a diagnostic and 1
otherwise.  ``--format=json`` dumps the full report list;
``--format=github`` emits GitHub Actions ``::error`` annotations (inline
for lint findings, which carry file:line).
"""
from __future__ import annotations

import argparse
import json
import re
import sys

import numpy as np

from .diagnostics import Report


def _parse_fanouts(s: str) -> tuple[int, ...]:
    return tuple(int(x) for x in s.replace("x", ",").split(",") if x)


def _build_subjects(gen_names, n, fanouts_list, seed, device):
    """Yield (label, plan) over the verify matrix."""
    from ..core.topology import canonical_ancestors
    from ..sparse.distributed import build_plan, build_plan_tree
    from ..sparse.generators import GENERATORS

    rng = np.random.default_rng(seed)
    for gname in gen_names:
        g = GENERATORS[gname](n, seed=seed)
        data = np.asarray(g.weights, dtype=np.float32)
        for fanouts in fanouts_list:
            k = int(np.prod(fanouts))
            part = rng.integers(0, k, size=g.n).astype(np.int64)
            yield (f"{gname}/flat k={k}",
                   build_plan(g.indptr, g.indices, data, part, k,
                              device=device, validate=False))
            if len(fanouts) > 1:
                yield (f"{gname}/tree {fanouts}",
                       build_plan_tree(g.indptr, g.indices, data, part,
                                       canonical_ancestors(fanouts), k,
                                       device=device, validate=False))


def _cmd_verify(args) -> list[Report]:
    from .verify import verify_plan

    fanouts_list = ([_parse_fanouts(s) for s in args.fanouts]
                    or [(4,), (2, 2), (2, 2, 2)])
    reports = []
    for label, plan in _build_subjects(args.generator, args.n, fanouts_list,
                                       args.seed, args.device):
        rep = verify_plan(plan)
        rep.subject = f"{label}: {rep.subject}"
        reports.append(rep)
    return reports


def _cmd_partners(args) -> list[Report]:
    from .verify import partner_table
    return [Report(subject=label, info={"partners": partner_table(plan)})
            for label, plan in _build_subjects(
                args.generator[:1], args.n, [_parse_fanouts(args.fanouts)],
                args.seed, args.device)]


def _cmd_lint(args) -> list[Report]:
    from .lint import lint_paths
    return [lint_paths(args.paths)]


def _cmd_trace(args) -> list[Report]:
    from ..sparse.operator import _HIER_BACKENDS, BACKENDS
    from .trace import audit_backend

    backends = args.backend or list(BACKENDS)
    fanouts_list = [_parse_fanouts(s) for s in args.fanouts] or [(2, 2)]
    reports = []
    for fanouts in fanouts_list:
        for backend in backends:
            if backend in _HIER_BACKENDS and len(fanouts) < 2:
                continue
            if backend not in _HIER_BACKENDS and fanouts != fanouts_list[0]:
                continue        # flat backends only vary with k, not shape
            reports.append(audit_backend(
                backend, n=args.n, fanouts=fanouts,
                generator=args.generator[0], seed=args.seed, nb=args.nb,
                device=args.device))
    return reports


# --------------------------------------------------------------------------
# output formatting
# --------------------------------------------------------------------------

def _print_text(reports: list[Report]) -> None:
    for rep in reports:
        print(f"[{'OK' if rep.ok else 'FAIL'}] {rep.subject}")
        for d in rep.diagnostics:
            print(f"    {d}")
        ex = rep.info.get("exchange")
        if ex is not None:
            print(f"    exchange {ex.comm}: payload bytes per level "
                  f"{list(ex.payload_bytes_lvl)}")
        partners = rep.info.get("partners")
        if partners is not None:
            for lvl, rounds in partners.items():
                for c, pairs in enumerate(rounds):
                    print(f"    level {lvl} round {c}: "
                          + " ".join(f"{a}->{b}" for a, b in pairs))
    bad = sum(not r.ok for r in reports)
    print(f"{len(reports)} subject(s), {bad} failing")


_WHERE_RE = re.compile(r"^(?:\w+: )?([\w./-]+\.py):(\d+)$")


def _print_github(reports: list[Report]) -> None:
    """GitHub Actions annotations: findings that carry a file:line (the
    lint) annotate inline; everything else is a plain error."""
    for rep in reports:
        for d in rep.diagnostics:
            msg = f"{d.code}: {d.message}"
            m = _WHERE_RE.match(d.where)
            if m:
                print(f"::error file={m.group(1)},line={m.group(2)}::{msg}")
            else:
                loc = f" [{d.where}]" if d.where else ""
                print(f"::error::{rep.subject}{loc}: {msg}")


def _emit(reports: list[Report], fmt: str) -> None:
    if fmt == "json":
        print(json.dumps([r.to_dict() for r in reports], indent=1))
    elif fmt == "github":
        _print_github(reports)
    else:
        _print_text(reports)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def _common(p, device: str | None = "card"):
        p.add_argument("--format", choices=("text", "json", "github"),
                       default="text",
                       help="console output: human text, a JSON report "
                            "list, or GitHub Actions ::error annotations")
        if device == "cpu":
            p.add_argument("--device", default="cpu",
                           help="device the plans are built on (default "
                                "cpu; the verifier reads host arrays)")
        elif device == "card":
            p.add_argument("--device", default=None,
                           help="device the plans and operators are built "
                                "on (default the card; cpu to run here)")

    p_lint = sub.add_parser("lint", help="AST lint (TORCH0xx rules)")
    p_lint.add_argument("paths", nargs="+",
                        help="files or directories to lint")
    _common(p_lint, device=None)
    p_lint.set_defaults(fn=_cmd_lint)

    p_ver = sub.add_parser("verify", help="build + verify plans (PLAN0xx)")
    p_ver.add_argument("--generator", action="append", default=None,
                       help="generator name(s); default grid_2d + rgg_2d")
    p_ver.add_argument("--n", type=int, default=196,
                       help="approximate vertex count (default 196)")
    p_ver.add_argument("--fanouts", action="append", default=[],
                       help="fanouts like 2,2,2 (repeatable); default "
                            "4 / 2,2 / 2,2,2")
    p_ver.add_argument("--seed", type=int, default=0)
    _common(p_ver, device="cpu")
    p_ver.set_defaults(fn=_cmd_verify)

    p_par = sub.add_parser("partners",
                           help="print the per-level partner table of a "
                                "built plan")
    p_par.add_argument("--generator", action="append", default=None)
    p_par.add_argument("--n", type=int, default=64)
    p_par.add_argument("--fanouts", default="2,2")
    p_par.add_argument("--seed", type=int, default=0)
    _common(p_par)
    p_par.set_defaults(fn=_cmd_partners)

    p_tr = sub.add_parser("trace",
                          help="exchange and dtype audit (TRACE0xx) of "
                               "one matvec and one CG chunk per backend")
    p_tr.add_argument("--backend", action="append", default=None,
                      help="backend name(s) (operator.BACKENDS); "
                           "default: all")
    p_tr.add_argument("--generator", action="append", default=None)
    p_tr.add_argument("--n", type=int, default=144,
                      help="approximate vertex count (default 144)")
    p_tr.add_argument("--fanouts", action="append", default=[],
                      help="tree shapes like 2,2 (repeatable; hier "
                           "backends re-audit per shape); default 2,2")
    p_tr.add_argument("--nb", type=int, default=None,
                      help="audit the batched (multi-RHS) programs")
    p_tr.add_argument("--seed", type=int, default=0)
    _common(p_tr)
    p_tr.set_defaults(fn=_cmd_trace)

    args = ap.parse_args(argv)
    if getattr(args, "generator", None) is None and args.cmd != "lint":
        args.generator = (["grid_2d"] if args.cmd == "trace"
                          else ["grid_2d", "rgg_2d"])
    reports = args.fn(args)
    _emit(reports, args.format)
    # nonzero iff any pass reported anything, as the reference's CLI
    return 1 if any(r.diagnostics for r in reports) else 0


if __name__ == "__main__":
    sys.exit(main())
