"""The port's AST lint (``repro_torch.analysis.lint``, TORCH001-004).

Each rule gets an offender file in ``tmp_path`` that must be flagged with
the right rule and line, and a negative twin that must stay clean.  The
real ``src/repro_torch`` tree lints clean, with one allowlist entry (the
CG's stop-flag read), and so does the JAX package's lint over it."""
import textwrap
from pathlib import Path

import pytest

from repro.analysis.lint import lint_paths as reference_lint
from repro_torch.analysis.lint import ALLOWLIST, LINT_RULES, lint_paths

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _lint(tmp_path, code, rel):
    f = tmp_path / rel
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(code))
    return lint_paths([f], root=tmp_path)


def _codes_lines(rep):
    return {(d.code, int(d.where.rpartition(":")[2]))
            for d in rep.diagnostics}


SOLVER = "repro_torch/sparse/mod.py"
CASES = {
    # name: (file, offender, {(code, line)}, negative twin)
    "torch001_import": ("repro_torch/launch/mod.py", """\
        import torch.distributed as dist
        """, {("TORCH001", 1)}, """\
        import torch
        """),
    "torch001_from_import": ("repro_torch/core/mod.py", """\
        from torch import distributed
        from torch.distributed import all_reduce
        """, {("TORCH001", 1), ("TORCH001", 2)}, """\
        from torch import nn
        """),
    "torch001_attribute": ("repro_torch/models/mod.py", """\
        import torch

        def f(x):
            torch.distributed.all_reduce(x)
        """, {("TORCH001", 4)}, """\
        import torch

        def f(x):
            return torch.cuda.is_available()
        """),
    "torch002_bare": ("repro_torch/kernels/mod.py", """\
        try:
            import triton
        except:
            pass
        """, {("TORCH002", 3)}, """\
        try:
            import triton
        except ImportError:
            pass
        """),
    "torch002_exception": ("repro_torch/launch/mod.py", """\
        def f(g):
            try:
                g()
            except Exception:
                ...
        """, {("TORCH002", 4)}, """\
        def f(g):
            try:
                g()
            except Exception as e:
                raise RuntimeError("g failed") from e
        """),
    "torch003_numpy": ("repro_torch/core/mod.py", """\
        import numpy as np
        from numpy.random import shuffle

        def f(n):
            return np.random.rand(n)
        """, {("TORCH003", 2), ("TORCH003", 5)}, """\
        import numpy as np

        def f(n, seed):
            return np.random.default_rng(seed).random(n)
        """),
    "torch003_torch": ("repro_torch/sparse/mod.py", """\
        import torch

        def f(n, x):
            a = torch.randn(n)
            x.uniform_()
            return a, torch.randperm(n)
        """, {("TORCH003", 4), ("TORCH003", 5), ("TORCH003", 6)}, """\
        import torch

        def f(n, x, gen):
            a = torch.randn(n, generator=gen)
            x.uniform_(generator=gen)
            return a, torch.randperm(n, generator=gen)
        """),
    "torch003_outside_core_sparse": ("repro_torch/launch/mod.py", """\
        import torch

        def f(n):
            return torch.rand(n)
        """, set(), """\
        import torch
        """),
    "torch004_item": ("repro_torch/core/mod.py", """\
        def f(x):
            return x.sum().item()
        """, {("TORCH004", 2)}, """\
        def f(x):
            return x.sum()
        """),
    "torch004_while_loop": (SOLVER, """\
        import torch

        def solve(x):
            r = torch.ones(3)
            while float(r.sum()) > 1e-6:
                r = r * 0.5
                print(r.tolist(), x.cpu(), r.numpy())
            return r
        """, {("TORCH004", 5), ("TORCH004", 7)}, """\
        import torch

        def solve(x, n):
            r = torch.ones(3)
            for _ in range(n):
                r = r * 0.5
            return r.cpu().numpy()
        """),
    "torch004_closure": (SOLVER, """\
        import torch

        def make(plan):
            w = torch.ones(plan.k)

            def matvec(x):
                return x * int(w.sum().to("cpu"))
            return matvec
        """, {("TORCH004", 7)}, """\
        import torch

        def make(plan):
            w = torch.ones(plan.k)
            n = int(plan.k)

            def matvec(x):
                return x * w * n
            return matvec
        """),
    "torch004_called_from_loop": (SOLVER, """\
        import torch

        def _flag(flag: torch.Tensor) -> bool:
            return bool(flag.to(device="cpu"))

        def solve(r):
            while _flag(r.sum() > 0):
                r = r * 0.5
        """, {("TORCH004", 4)}, """\
        import torch

        def _flag(flag: torch.Tensor) -> bool:
            return bool(flag.to(device="cpu"))

        def solve(r):
            if _flag(r.sum() > 0):
                r = r * 0.5
        """),
    "torch004_host_values_in_loop": (SOLVER, """\
        import torch

        def schedule(a, t):
            active = torch.ones(1)

            def done():
                return active < 0

            while bool(done()):
                pass
        """, {("TORCH004", 9)}, """\
        import numpy as np

        def schedule(a):
            while int(a.sum()) > 0:
                a = a[1:]
            return a.tolist()
        """),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_offender_is_flagged(tmp_path, name):
    rel, code, want, _ = CASES[name]
    rep = _lint(tmp_path, code, rel)
    assert _codes_lines(rep) == want, str(rep)
    for d in rep.diagnostics:
        assert d.where.startswith(rel)


@pytest.mark.parametrize("name", sorted(CASES))
def test_negative_twin_is_clean(tmp_path, name):
    rel, _, _, twin = CASES[name]
    rep = _lint(tmp_path, twin, rel)
    assert rep.ok, str(rep)


def test_allowlist_sanctions_by_file_and_rule(tmp_path):
    code = """\
        import torch

        def f(x: torch.Tensor):
            while bool(x.to("cpu")):
                x = x - 1
            return torch.rand(3)
        """
    rep = _lint(tmp_path, code, "repro_torch/sparse/cg.py")
    # the cg.py entry sanctions TORCH004 there, and no other rule
    assert _codes_lines(rep) == {("TORCH003", 6)}, str(rep)
    rep = _lint(tmp_path, code, "repro_torch/sparse/other.py")
    assert {c for c, _ in _codes_lines(rep)} == {"TORCH003", "TORCH004"}


def test_syntax_error_reported_not_raised(tmp_path):
    rep = _lint(tmp_path, "def broken(:\n", "mod.py")
    assert rep.codes() == {"TORCH000"}


def test_rule_table_is_complete():
    assert set(LINT_RULES) == {"TORCH001", "TORCH002", "TORCH003",
                               "TORCH004"}
    assert all(len(desc) > 10 for desc in LINT_RULES.values())


def test_real_port_tree_is_clean():
    rep = lint_paths([PORT], root=PORT.parents[1])
    assert rep.ok, "the port must lint clean:\n" + str(rep)
    assert rep.info["files"] > 50


def test_only_the_stop_flag_read_is_allowlisted():
    """Without the allowlist the tree has exactly one finding site: the
    chunked CG's stop-flag read in ``sparse/cg.py``."""
    assert set(ALLOWLIST) == {"repro_torch/sparse/cg.py"}
    rep = lint_paths([PORT], root=PORT.parents[1], allowlist={})
    sites = {d.where for d in rep.diagnostics}
    assert rep.codes() == {"TORCH004"}
    assert len(sites) == 1
    line = int(sites.pop().rpartition(":")[2])
    src = (PORT / "sparse" / "cg.py").read_text().splitlines()
    assert 'flag.to("cpu")' in src[line - 1]


def test_reference_lint_is_clean_on_the_port():
    rep = reference_lint([PORT], root=PORT.parents[1])
    assert rep.ok, str(rep)
