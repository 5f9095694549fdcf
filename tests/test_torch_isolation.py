"""The PyTorch port stands alone: it imports neither ``jax`` nor the JAX
package ``repro``, and its entry points run on the card unless asked for
the CPU — without a card they raise instead of falling back."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in _imported_modules(path)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_fresh_import_pulls_in_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.sparse.operator, "
            "repro_torch.core.api; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'repro')))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]", proc.stdout


def _tiny():
    from repro_torch.sparse.generators import grid
    from repro_torch.sparse.graph import laplacian_csr
    g = grid((6, 6))
    return g, laplacian_csr(g, shift=0.1)


@pytest.mark.parametrize("entry", ["partition", "make_operator",
                                   "build_plan", "cg_solve_global"])
def test_entry_points_raise_without_a_card(monkeypatch, entry):
    from repro_torch.core.api import partition
    from repro_torch.core.topology import Topology, scale_to_load
    from repro_torch.sparse.distributed import build_plan
    from repro_torch.sparse.operator import cg_solve_global, make_operator
    g, (indptr, indices, data) = _tiny()
    part = np.arange(g.n) % 2
    op = make_operator(indptr, indices, data, "coo", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "partition": lambda: partition(g, scale_to_load(
            Topology.homogeneous(2), g.n), "geoKM"),
        "make_operator": lambda: make_operator(indptr, indices, data, "coo"),
        "build_plan": lambda: build_plan(indptr, indices, data, part, 2),
        "cg_solve_global": lambda: cg_solve_global(op, np.ones(g.n)),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_kernel_wrappers_refuse_tensors_off_cpu_and_cuda():
    from repro_torch.kernels.pdist import pairwise_sqdist
    from repro_torch.kernels.spmv_bell import spmv_block_ell
    x = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_sqdist(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        spmv_block_ell(torch.zeros(1, 1, 8, 128, device="meta"),
                       torch.zeros(1, 1, dtype=torch.int32, device="meta"),
                       torch.zeros(8, device="meta"))
