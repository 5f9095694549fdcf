"""Registers, shared memory and spills of the port's CUDA kernels, as ptxas
reports them.

    python3 benchmarks/ptxas_torch_kernels.py [flash_sm90 pdist ...]

Compiles the device code of each named source of
``src/repro_torch/kernels/csrc`` (every source by default) to a cubin under
``build/torch_ext/``, with the flags the port builds its libraries with
plus ``-Xptxas=-v``, and prints ptxas's lines for each kernel.  Needs the
CUDA toolkit, not a GPU.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build  # noqa: E402

# the library flags without those that only a shared library needs
DEVICE_FLAGS = [f for f in _build.NVCC_FLAGS
                if f not in ("-shared", "-Xcompiler", "-fPIC")]


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or list(
        _build.SOURCES)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in names:
        src = _build.CSRC / _build.SOURCES[name]
        proc = subprocess.run(
            [_build.nvcc(), *DEVICE_FLAGS, "-cubin", "-Xptxas=-v", "-o",
             str(_build.BUILD_DIR / f"{name}.cubin"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        print(f"== {_build.SOURCES[name]}")
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            print(proc.stdout, file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
