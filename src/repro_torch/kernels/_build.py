"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` holds ``extern "C"`` launchers.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/torch_ext/`` at the repository root, named by a hash of the source
and the flags, and loaded with ``ctypes``.  A library that is already there
is loaded as it is, so only a changed source is rebuilt.  :func:`build_all`
starts one ``nvcc`` per source at once, so a cold build takes as long as the
slowest file.

Nothing is compiled or loaded at import: the CPU tests import every module
and never reach a kernel.

Launch counts: every wrapper calls :func:`count` once per kernel launch and
nowhere else, so a run can prove that its main path went through the
kernels (:func:`reset_launches` before it, :func:`launches` after).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
SOURCES = {"pdist": "pdist.cu", "spmv_bell": "spmv_bell.cu",
           "flash": "flash_attn.cu", "flash_sm90": "flash_attn_sm90.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_LP = ctypes.POINTER(ctypes.c_longlong)
_FLASH = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LP, _I, _P)
_SELL = (_P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _I, _I,
         _P)
# library -> launcher name -> argtypes; every launcher returns a
# cudaError_t as int
SIGNATURES = {
    "pdist": {"pdist_f32": (_P, _P, _P, _L, _I, _I, _P),
              "pdist_bf16": (_P, _P, _P, _L, _I, _I, _P)},
    "spmv_bell": {
        "spmv_sell_f32": _SELL, "spmv_sell_f64": _SELL,
        "bell_nonfinite": (_P, _L, _I, _P, _P)},
    "flash": {"flash_attn_f32": _FLASH, "flash_attn_bf16": _FLASH},
    "flash_sm90": {"flash_sm90_bf16": _FLASH},
}

_LIBS: dict[str, ctypes.CDLL] = {}
# one count per kernel and form: spmv_bell.cu's sliced-ELL kernel counts as
# spmv_bell:sell for an (n,) or (K, n) operand and as spmv_bell_multi:sell
# for an (n, nb) batch
KERNELS = ("pdist", "spmv_bell:sell", "spmv_bell_multi:sell", "flash",
           "flash_sm90")
_LAUNCHES = {name: 0 for name in KERNELS}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            f"nvcc not found under {home}/bin or on PATH: the CUDA kernels "
            "need the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def build_all(names=None) -> dict[str, float]:
    """Compile (where needed) and load the named kernels, all ``nvcc``
    processes started together.  Returns the seconds each build took (0.0
    for a library found already built)."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [name for name in names
            if name not in _LIBS and not library_path(name).exists()]

    def compile_one(name):
        path = library_path(name)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(CSRC / SOURCES[name])],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode == 0:
            os.replace(tmp, path)       # atomic: a reader never sees half
        return proc, time.perf_counter() - t0

    seconds = {name: 0.0 for name in names}
    errors = []
    with ThreadPoolExecutor(max_workers=max(len(todo), 1)) as pool:
        done = dict(zip(todo, pool.map(compile_one, todo)))
    for name, (proc, secs) in done.items():
        seconds[name] = secs
        if proc.returncode != 0:
            errors.append(f"{SOURCES[name]}:\n{proc.stdout}")
    if errors:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(errors))
    for name in names:
        if name not in _LIBS:
            _load(name, library_path(name))
    return seconds


def launcher(name: str, fn: str):
    """The ctypes function ``fn`` of kernel library ``name``, built at
    first use."""
    if name not in _LIBS:
        build_all([name])
    return getattr(_LIBS[name], fn)


def check(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {fn} failed with cudaError_t "
                           f"{err}")


def count(name: str) -> None:
    _LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launches() -> dict[str, int]:
    return dict(_LAUNCHES)
