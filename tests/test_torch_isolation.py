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
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
    + sorted((ROOT / "examples").glob("*_torch.py"))


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
            "repro_torch.core.api, repro_torch.launch.serve, "
            "repro_torch.models.convert, repro_torch.launch.train; "
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


@pytest.mark.parametrize("entry", ["partition", "partition_tree",
                                   "evaluate", "make_operator",
                                   "build_plan", "cg_solve_global",
                                   "models.transformer.init_model",
                                   "launch.serve.serve_tokens",
                                   "launch.serve.SolverService",
                                   "launch.serve.main --solver",
                                   "train.trainer.Trainer",
                                   "launch.train.main"])
def test_entry_points_raise_without_a_card(monkeypatch, entry):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import evaluate, partition, partition_tree
    from repro_torch.core.topology import Topology, scale_to_load
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.serve import SolverService, main, serve_tokens
    from repro_torch.models.transformer import init_model
    from repro_torch.sparse.distributed import build_plan
    from repro_torch.sparse.operator import cg_solve_global, make_operator
    from repro_torch.train.trainer import Trainer, TrainerConfig
    g, (indptr, indices, data) = _tiny()
    part = np.arange(g.n) % 2
    op = make_operator(indptr, indices, data, "coo", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = scale_to_load(Topology.homogeneous(2), g.n)
    calls = {
        "partition": lambda: partition(g, topo, "geoKM"),
        "partition_tree": lambda: partition_tree(g, topo, "greedyRef",
                                                 fanouts=(2,)),
        "evaluate": lambda: evaluate(g, topo, ("rcb",), verbose=False),
        "make_operator": lambda: make_operator(indptr, indices, data, "coo"),
        "build_plan": lambda: build_plan(indptr, indices, data, part, 2),
        "cg_solve_global": lambda: cg_solve_global(op, np.ones(g.n)),
        "models.transformer.init_model": lambda: init_model(
            get_config("qwen1.5-0.5b", smoke=True)),
        "launch.serve.serve_tokens": lambda: serve_tokens(
            get_config("qwen1.5-0.5b", smoke=True), gen=1),
        "launch.serve.SolverService": lambda: SolverService(
            backend="dist_halo", part=part, k=2),
        "launch.serve.main --solver": lambda: main(
            ["--solver", "--requests", "1"]),
        "train.trainer.Trainer": lambda: Trainer(
            get_config("qwen1.5-0.5b", smoke=True), TrainerConfig()),
        "launch.train.main": lambda: launch_train.main(
            ["--smoke", "--steps", "1"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_kernel_wrappers_refuse_tensors_off_cpu_and_cuda():
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.kernels.pdist import pairwise_sqdist
    from repro_torch.kernels.spmv_bell import spmv_block_ell
    x = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_sqdist(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        spmv_block_ell(torch.zeros(1, 1, 8, 128, device="meta"),
                       torch.zeros(1, 1, dtype=torch.int32, device="meta"),
                       torch.zeros(8, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(*(torch.zeros(1, 2, 64, 16, device="meta"),) * 3)
