"""Where the time of the port's LM token serving goes, on one GPU.

    python3 benchmarks/profile_torch_serve.py [--arch qwen1.5-0.5b]
        [--batch 8] [--prompt-len 2048] [--decode-steps 32] [--seed 0]

Builds a dense config (qwen1.5-0.5b by default, or stablelm-3b), the VLM
internvl2-76b (the prompt's first 256 positions image embeddings) or the
encoder-decoder whisper-tiny (1,500 frames; ``--prompt-len 224``) at full
width and depth (random weights, embeddings and frames from a seed), but
internvl2-76b at ``chip_smoke.VLM_LAYERS`` of its 80 layers, the cut that
fits one card and that ``chip_smoke.py`` serves; warms up,
then traces one prefill and ``--decode-steps`` decode steps with
``torch.profiler`` (CPU and CUDA activities), each phase in its own
session.  For each phase it prints one JSON line: wall time (CUDA events,
with and without the profiler), the summed device time of every kernel,
the device's idle share (1 - device time / wall time, unprofiled wall,
negative when the summed kernel time exceeds the wall, which flags double
counting; the script then exits non-zero after printing) and
the device time by kernel class (flash, GEMM, elementwise and copies,
softmax, reductions, other) with the top kernels by name.  Lines are tagged
with the card's name and power limit.  Needs a CUDA device; imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CLASSES = (                      # first match wins
    ("flash", re.compile(r"flash_fwd|flash_sm90")),
    ("gemm", re.compile(r"gemm|gemv|nvjet|sm90_xmma|cutlass|cublas",
                        re.I)),
    ("softmax", re.compile(r"softmax", re.I)),
    ("reduce", re.compile(r"reduce", re.I)),
    ("elementwise_copy", re.compile(r"elementwise|copy|cat|index|fill|"
                                    r"CatArray|scatter|gather", re.I)),
)


def classify(name: str) -> str:
    for label, pat in CLASSES:
        if pat.search(name):
            return label
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=("qwen1.5-0.5b", "stablelm-3b", "internvl2-76b",
                             "whisper-tiny"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import VLM_LAYERS
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.models.steps import (make_decode_step, make_prefill,
                                          model_module)

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    tag = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    cfg = get_config(args.arch)
    if cfg.name == "internvl2-76b":
        cfg = dataclasses.replace(cfg, n_layers=VLM_LAYERS)
    B, S, n_dec = args.batch, args.prompt_len, args.decode_steps
    _build.build_all(["flash", "flash_sm90"])
    model = model_module(cfg).init_model(cfg, seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(B, S + n_dec), dtype=np.int32)).to(dev)
    batch = {"tokens": toks[:, :S], **stub_inputs(cfg, rng, B, dev)}
    cache_len = S + n_dec
    step = make_decode_step(cfg)

    def prefill():
        return make_prefill(cfg, cache_len=cache_len)(model, batch)

    def decode(cache):
        for t in range(S, S + n_dec):
            _, cache = step(model, cache, toks[:, t:t + 1], t)
        return cache

    def timed(fn, *a):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    decode(prefill()[1])                     # warm-up
    torch.cuda.synchronize()
    _, cache = prefill()
    phases = {"prefill": (prefill, ()), "decode": (decode, (cache,))}
    overcounted = []
    for label, (fn, fargs) in phases.items():
        _, wall_ms = timed(fn, *fargs)       # unprofiled
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, prof_wall_ms = timed(fn, *fargs)
        by_class: dict[str, float] = {}
        kernels = []
        for e in prof.key_averages():
            # kernels only: the CPU op that launched a kernel reports the
            # same device time again
            if e.device_type != DeviceType.CUDA:
                continue
            dev_us = e.self_device_time_total
            if dev_us <= 0:
                continue
            cls = classify(e.key)
            by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3
            kernels.append((dev_us / 1e3, e.count, cls, e.key[:90]))
        busy_ms = sum(by_class.values())
        kernels.sort(reverse=True)
        if busy_ms > wall_ms:
            overcounted.append(label)
        steps = n_dec if label == "decode" else 1
        print(json.dumps({
            "profile": label, "arch": cfg.name, "layers": cfg.n_layers,
            "batch": B,
            "prompt_len": S, "steps": steps, "wall_ms": wall_ms,
            "wall_ms_per_step": wall_ms / steps,
            "wall_ms_profiled": prof_wall_ms, "device_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "device_exceeds_wall": busy_ms > wall_ms,
            "device_ms_by_class": by_class,
            "kernel_launches": sum(k[1] for k in kernels),
            "top_kernels": [dict(ms=k[0], count=k[1], cls=k[2], name=k[3])
                            for k in kernels[:10]],
            **tag}), flush=True)
    print(smi)
    if overcounted:
        print(f"profile_torch_serve: summed kernel time exceeds the wall in "
              f"{overcounted}: device time is double counted",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
