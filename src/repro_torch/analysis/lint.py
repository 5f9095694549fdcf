"""Custom AST lint for the port's bug classes — the torch counterpart of
``src/repro/analysis/lint.py``: the same ``ast`` machinery, the same
:class:`~.diagnostics.Report`, and its four rule classes in torch terms.

  ========  ==============================================================
  rule      what / why
  ========  ==============================================================
  TORCH001  ``torch.distributed`` imported or referenced outside a
            sanctioned comm module.  The multi-process mode (ROADMAP.md
            queue 1 item 9) will get one such module and its
            ``ALLOWLIST`` entry; until then every use is flagged, as the
            reference flags ``jax.sharding`` outside ``compat.py``.
  TORCH002  blanket ``except Exception: pass`` (or bare ``except:``).
            Swallowing everything hides the fault; catch the concrete
            types and record or re-raise.
  TORCH003  unseeded global RNG in ``core/`` + ``sparse/``: numpy's
            global functions (``np.random.rand`` etc., ``from numpy.random
            import shuffle``) and torch's (``torch.rand*``, ``randperm``,
            ``normal``, ``bernoulli``, ``multinomial``, ``poisson`` and the
            in-place ``.uniform_()`` family) called without a
            ``generator=``.  Plans and partitions must be deterministic —
            use ``np.random.default_rng(seed)`` or a seeded
            ``torch.Generator``.
  TORCH004  host syncs in solver paths of ``core/`` + ``sparse/``: every
            ``.item()`` there (as the reference), and on a solver path
            ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``.tolist()`` of a
            tensor, and ``float()`` / ``int()`` / ``bool()`` of a tensor.
            Each one stalls the host until the card drains its queue, so
            inside the CG loop it costs a round trip per iteration.
  ========  ==============================================================

A *solver path* is code that runs once per solver iteration or chunk: the
test and body of a ``while`` loop (the CG runs its chunks in one), every
closure (the runtime builds its matvec, exchange, dot, preconditioner and
solve callables as closures of ``make_*`` factories), and every
module-level function that such code calls by name, transitively.  Set-up
and result code (a plan copied to the host once, a gathered solution) is
outside it.  Whether an expression is a tensor is decided statically: a
``torch.*`` call, a parameter annotated ``torch.Tensor``, a name assigned
from a tensor expression, a closure that returns one, or arithmetic,
indexing and method calls on any of these.

Pure ``ast`` — no imports of the linted code.  ``ALLOWLIST`` maps path
suffixes to the rule codes permitted there, each with its reason.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable

from .diagnostics import Report

LINT_RULES: dict[str, str] = {
    "TORCH001": "torch.distributed used outside a sanctioned comm module",
    "TORCH002": "blanket 'except Exception: pass' swallows errors",
    "TORCH003": "unseeded global RNG in schedule-building code",
    "TORCH004": "host sync (.item()/.cpu()/.numpy()/.to('cpu')/.tolist()/"
                "float()/int()/bool() of a tensor) in a solver path",
}

# path-suffix -> codes sanctioned there, each with the reason beside it
ALLOWLIST: dict[str, frozenset[str]] = {
    # the chunked CG reads its 0-d stop flag once per CHUNK iterations
    # (cg._host_flag): the one deliberate host sync of the solver loop,
    # which an eager loop cannot avoid (the reference's while_loop tests
    # its flag on the device)
    "repro_torch/sparse/cg.py": frozenset({"TORCH004"}),
}

_SEEDED_RNG = {"default_rng", "Generator", "SeedSequence", "RandomState",
               "Philox", "PCG64", "MT19937", "bit_generator"}
# torch's global-RNG functions, and the in-place samplers of a tensor
_TORCH_RNG = {"rand", "randn", "randint", "randperm", "rand_like",
              "randn_like", "randint_like", "normal", "bernoulli",
              "multinomial", "poisson"}
_TORCH_RNG_INPLACE = {"uniform_", "normal_", "random_", "bernoulli_",
                      "exponential_", "geometric_", "log_normal_",
                      "cauchy_"}
_HOST_COERCE = {"float", "int", "bool"}
# torch.* calls that return no tensor
_TORCH_NOT_TENSOR = {"finfo", "iinfo", "device", "is_tensor",
                     "is_floating_point", "get_default_dtype", "Size",
                     "Generator", "dtype", "cuda", "backends"}
# tensor attributes and methods that give Python values, not tensors
_NOT_TENSOR_ATTR = {"shape", "dtype", "device", "ndim", "dim", "numel",
                    "size", "element_size", "is_cuda", "data_ptr",
                    "stride", "is_contiguous", "layout"}


def _dotted(node: ast.AST) -> str:
    """'torch.distributed.all_reduce' for an Attribute/Name chain, ''
    otherwise."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_distributed_module(mod: str) -> bool:
    return mod == "torch.distributed" or mod.startswith("torch.distributed.")


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")`` as a ``.to()`` argument."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and _dotted(node.func) == "torch.device":
        return any(_is_cpu(a) for a in node.args)
    return False


def _has_generator(node: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in node.keywords)


class _Scopes(ast.NodeVisitor):
    """Pre-pass over one module: which functions are solver paths.

    Seeds: every closure (a function or lambda defined inside a function)
    and every function whose body has a ``while`` loop contributes the
    module-level names it calls from inside the loop or closure; those
    functions are solver paths too, transitively."""

    def __init__(self, tree: ast.Module):
        self.top = {n.name: n for n in tree.body
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))}
        self.solver: set[int] = set()        # ids of solver function nodes
        self.calls: dict[str, set[str]] = {}   # top fn -> names it calls
        self.seed_names: set[str] = set()
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                self._scan(node, depth=0)
        todo = list(self.seed_names & set(self.top))
        seen = set(todo)
        while todo:
            name = todo.pop()
            self.solver.add(id(self.top[name]))
            for callee in self.calls.get(name, ()):
                if callee in self.top and callee not in seen:
                    seen.add(callee)
                    todo.append(callee)

    @staticmethod
    def _called_names(node: ast.AST) -> set[str]:
        return {c.func.id for c in ast.walk(node)
                if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)}

    def _scan(self, node: ast.AST, depth: int) -> None:
        is_fn = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda))
        if is_fn and depth >= 1:                # a closure
            self.solver.add(id(node))
            self.seed_names |= self._called_names(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in self.top and self.top[node.name] is node:
            self.calls[node.name] = self._called_names(node)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.While):
                self.seed_names |= self._called_names(child)
            self._scan(child, depth + is_fn)


class _Linter(ast.NodeVisitor):
    def __init__(self, rel: str, rep: Report, allowed: frozenset[str],
                 solver_fns: set[int]):
        self.rel, self.rep, self.allowed = rel, rep, allowed
        parts = Path(rel).parts
        self.solver_scope = "core" in parts or "sparse" in parts
        self.solver_fns = solver_fns
        self.solver_depth = 0
        # per function scope: names bound to tensors, closures returning one
        self.tensors: list[set[str]] = [set()]
        self.returns: list[list[ast.AST]] = []

    def _add(self, code: str, node: ast.AST, message: str) -> None:
        if code in self.allowed:
            return
        self.rep.add(code, message,
                     where=f"{self.rel}:{getattr(node, 'lineno', 0)}")

    # -- is this expression a tensor? ------------------------------------
    def _tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tensors[-1]
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name.startswith("torch."):
                return name.split(".")[1] not in _TORCH_NOT_TENSOR
            if isinstance(node.func, ast.Name):
                return f"{node.func.id}()" in self.tensors[-1]
            if isinstance(node.func, ast.Attribute):
                return (node.func.attr not in _NOT_TENSOR_ATTR
                        and self._tensor(node.func.value))
            return False
        if isinstance(node, ast.Attribute):
            return (node.attr not in _NOT_TENSOR_ATTR
                    and self._tensor(node.value))
        if isinstance(node, ast.Subscript):
            return self._tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self._tensor(node.left) or self._tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._tensor(node.operand)
        if isinstance(node, ast.Compare):
            return any(self._tensor(x) for x in [node.left,
                                                 *node.comparators])
        if isinstance(node, ast.IfExp):
            return self._tensor(node.body) or self._tensor(node.orelse)
        return False

    # -- scopes -----------------------------------------------------------
    def _visit_func(self, node) -> None:
        solver = id(node) in self.solver_fns
        scope = set(self.tensors[-1])
        args = node.args
        for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
            ann = _dotted(a.annotation) if a.annotation is not None else ""
            if ann in ("torch.Tensor", "Tensor"):
                scope.add(a.arg)
            else:
                scope.discard(a.arg)
        self.tensors.append(scope)
        self.returns.append([])
        self.solver_depth += solver
        if isinstance(node, ast.Lambda):
            self.returns[-1].append(node.body)
        self.generic_visit(node)
        self.solver_depth -= solver
        rets = self.returns.pop()
        returns_tensor = any(self._tensor(r) for r in rets)
        self.tensors.pop()
        if returns_tensor and not isinstance(node, ast.Lambda):
            self.tensors[-1].add(f"{node.name}()")

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func
    visit_Lambda = _visit_func

    def visit_Return(self, node: ast.Return) -> None:
        if node.value is not None and self.returns:
            self.returns[-1].append(node.value)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        tensor = self._tensor(node.value)
        for t in node.targets:
            if isinstance(t, ast.Name):
                (self.tensors[-1].add if tensor
                 else self.tensors[-1].discard)(t.id)

    def visit_While(self, node: ast.While) -> None:
        self.solver_depth += 1
        self.generic_visit(node)
        self.solver_depth -= 1

    # -- TORCH001 -----------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if _is_distributed_module(alias.name):
                self._add("TORCH001", node,
                          f"import {alias.name}: torch.distributed belongs "
                          "in a sanctioned comm module")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        if _is_distributed_module(mod) or (
                mod == "torch"
                and any(a.name == "distributed" for a in node.names)):
            self._add("TORCH001", node,
                      f"from {mod} import "
                      f"{', '.join(a.name for a in node.names)}: "
                      "torch.distributed belongs in a sanctioned comm "
                      "module")
        if self.solver_scope:
            if mod == "numpy.random" or mod.startswith("numpy.random."):
                bad = [a.name for a in node.names
                       if a.name not in _SEEDED_RNG]
                if bad:
                    self._add("TORCH003", node,
                              f"from numpy.random import {', '.join(bad)}: "
                              "global-RNG functions are unseeded; use "
                              "np.random.default_rng(seed)")
            if mod == "torch":
                bad = [a.name for a in node.names if a.name in _TORCH_RNG]
                if bad:
                    self._add("TORCH003", node,
                              f"from torch import {', '.join(bad)}: call "
                              "them with a seeded generator=")
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        name = _dotted(node)
        if name == "torch.distributed" or name.startswith(
                "torch.distributed."):
            self._add("TORCH001", node,
                      f"{name}: torch.distributed belongs in a sanctioned "
                      "comm module")
            return          # don't re-flag the nested chain
        self.generic_visit(node)

    # -- TORCH002 -----------------------------------------------------------
    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        broad = node.type is None or (
            isinstance(node.type, ast.Name)
            and node.type.id in ("Exception", "BaseException"))

        def _noop(s: ast.stmt) -> bool:   # `pass` or a bare `...`
            return isinstance(s, ast.Pass) or (
                isinstance(s, ast.Expr)
                and isinstance(s.value, ast.Constant)
                and s.value.value is Ellipsis)

        if broad and all(_noop(s) for s in node.body):
            what = ("bare except" if node.type is None
                    else f"except {node.type.id}")
            self._add("TORCH002", node,
                      f"{what}: pass — swallows every error; catch the "
                      "concrete exception types and record or re-raise")
        self.generic_visit(node)

    # -- TORCH003 / TORCH004 ------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        if self.solver_scope:
            parts = name.split(".")
            if len(parts) >= 3 and parts[-2] == "random" \
                    and parts[0] in ("np", "numpy") \
                    and parts[-1] not in _SEEDED_RNG:
                self._add("TORCH003", node,
                          f"{name}(): unseeded global RNG makes plan "
                          "construction nondeterministic; use "
                          "np.random.default_rng(seed)")
            rng = ((len(parts) == 2 and parts[0] == "torch"
                    and parts[1] in _TORCH_RNG)
                   or attr in _TORCH_RNG_INPLACE)
            if rng and not _has_generator(node):
                self._add("TORCH003", node,
                          f"{name or attr}() without generator=: torch's "
                          "global RNG is unseeded here; pass a seeded "
                          "torch.Generator")
            if attr == "item" and not node.args:
                self._add("TORCH004", node,
                          ".item(): host sync — forces a device round-trip "
                          "in the solver path; keep reductions on device")
            if self.solver_depth:
                self._host_sync(node, attr)
        self.generic_visit(node)

    def _host_sync(self, node: ast.Call, attr: str | None) -> None:
        recv = node.func.value if attr is not None else None
        what = None
        if attr in ("cpu", "numpy") and not node.args:
            what = f".{attr}()"
        elif attr == "to" and (any(_is_cpu(a) for a in node.args) or any(
                kw.arg == "device" and _is_cpu(kw.value)
                for kw in node.keywords)):
            what = '.to("cpu")'
        elif attr == "tolist" and self._tensor(recv):
            what = ".tolist() of a tensor"
        elif isinstance(node.func, ast.Name) \
                and node.func.id in _HOST_COERCE and node.args \
                and self._tensor(node.args[0]):
            what = f"{node.func.id}() of a tensor"
        if what is not None:
            self._add("TORCH004", node,
                      f"{what} in a solver path: host sync — the host "
                      "waits for the card once per call; keep the value "
                      "on the device")


def _iter_py(paths: Iterable[str | Path]):
    for p in paths:
        p = Path(p)
        if p.is_dir():
            yield from sorted(q for q in p.rglob("*.py")
                              if not any(part.startswith(".")
                                         for part in q.parts))
        elif p.suffix == ".py":
            yield p


def lint_paths(paths: Iterable[str | Path], *,
               allowlist: dict[str, frozenset[str]] | None = None,
               root: str | Path | None = None) -> Report:
    """Lint every ``.py`` file under ``paths``; returns a :class:`Report`
    whose diagnostics carry ``rule [path:line]: message``."""
    allow = ALLOWLIST if allowlist is None else allowlist
    root = Path(root) if root is not None else Path.cwd()
    rep = Report(subject="lint")
    n = 0
    for path in _iter_py(paths):
        n += 1
        try:
            rel = str(path.resolve().relative_to(root.resolve()))
        except ValueError:
            rel = str(path)
        rel = rel.replace("\\", "/")
        allowed = frozenset().union(
            *(codes for suffix, codes in allow.items()
              if rel.endswith(suffix)))
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except SyntaxError as e:
            rep.add("TORCH000", f"syntax error: {e.msg}",
                    where=f"{rel}:{e.lineno}")
            continue
        _Linter(rel, rep, allowed, _Scopes(tree).solver).visit(tree)
    rep.info["files"] = n
    return rep
