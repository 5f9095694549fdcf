"""Time the port's ``flash`` route at its two path shapes for one or more
source trees, in turns, on one card.

    python3 benchmarks/flash_torch_turns.py SRC [SRC ...]

Each SRC is a directory that holds ``repro_torch`` (``src`` of a checkout;
an older commit unpacked with ``git archive`` works as it is).  Each runs in
a process of its own, in the order given, so ``OLD NEW NEW OLD`` times two
versions in turns.  The process builds that tree's ``flash`` kernel (into
that checkout's ``build/torch_ext/``) and prints one JSON line per shape:
the kernel's time through ``flash_attention`` and SDPA's
(``F.scaled_dot_product_attention(is_causal=True)``) on the same tensors,
both CUDA-event medians, with the card's name and power limit.  Shapes,
causal: bf16 ``(8, 32, 2048, 80)`` (stablelm-3b's prefill) and f32 ``(4,
16, 2048, 64)`` (the float32 consistency check of ``chip_smoke.py``).  The
inputs are (B, S, H, D) buffers seen as (B, H, S, D), as the LM hands them
over.  Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SHAPES = (((8, 32, 2048, 80), "bfloat16"), ((4, 16, 2048, 64), "float32"))

CHILD = r"""
import json, statistics, subprocess, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.nn.functional as F
from repro_torch.kernels import _build
from repro_torch.kernels.flash import flash_attention

def event_ms(fn, reps=10, inner=5):
    fn()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)

smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip().splitlines()[0]
_build.build_all(["flash"])
gen = torch.Generator(device="cuda").manual_seed(0)
for shape, dt in json.loads(sys.argv[2]):
    b, h, s, d = shape
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda")
               .to(getattr(torch, dt)).transpose(1, 2) for _ in range(3))
    n0 = _build.launches()["flash"]
    flash_attention(q, k, v)
    assert _build.launches()["flash"] == n0 + 1, "not on the flash route"
    print(json.dumps(dict(
        src=sys.argv[1], shape=shape, dtype=dt, causal=True,
        flash_ms=event_ms(lambda: flash_attention(q, k, v)),
        sdpa_ms=event_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        nvidia_smi=smi)), flush=True)
"""


def main(argv=None) -> int:
    srcs = argv if argv is not None else sys.argv[1:]
    if not srcs:
        print(__doc__)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("flash_torch_turns: no CUDA device", file=sys.stderr)
        return 2
    for src in srcs:
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, str(Path(src).resolve()),
             json.dumps(SHAPES)], timeout=900)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
