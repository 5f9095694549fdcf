"""Where the time of one training step of the port goes, on one GPU.

    python3 benchmarks/profile_torch_train.py [--batch 8] [--seq 2048]
        [--seed 0]

Builds the trainer of ``chip_smoke.py`` phase 10a
(``repro_torch.train.trainer.Trainer``: qwen1.5-0.5b at full width and
depth, random weights from ``--seed``, bf16, ``remat="full"``, the
default AdamW, ``SyntheticLM``), runs two warm-up steps, then prints JSON
lines tagged with the card's name and power limit:

* ``step``: the median of three steps (CUDA events around the train step),
  then one step under ``torch.profiler`` (CPU and CUDA activities): the
  summed device time of every kernel by class (GEMM, elementwise and
  copies, softmax, reductions, other), the idle share (1 - device time /
  unprofiled wall) and the top kernels by name;
* ``stages``: each part of a step timed alone at the step's shapes with
  CUDA events (median of five): one layer's attention core
  (``gqa_attend`` under grad, forward and forward + backward), one whole
  layer, the final norm, head and cross entropy with their backward, and
  AdamW's update.  Under remat a layer costs its forward once in the
  forward pass and forward + backward again in the backward, so the step's
  share of each is ``n_layers * (fwd + fwd_bwd)``; the line sums the
  shares against the step.

Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "benchmarks"))
    from profile_torch_serve import classify
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    from repro_torch.models.attention import gqa_attend
    from repro_torch.models.common import apply_norm, cross_entropy
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.trainer import Trainer, TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.py
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    tag = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    cfg = get_config("qwen1.5-0.5b")
    B, S = args.batch, args.seq
    tr = Trainer(cfg, TrainerConfig(steps=10, seq_len=S, global_batch=B,
                                    seed=args.seed), device=dev)
    batch = tr._batch(0)

    def step():
        tr.state, m = tr.train_step(tr.state, batch)
        return m

    def timed(fn, reps=1):
        samples = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        return statistics.median(samples)

    for _ in range(2):                           # warm-up
        step()
    wall_ms = timed(step, reps=3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall_ms = timed(step)
    by_class: dict[str, float] = {}
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        cls = classify(e.key)
        ms = e.self_device_time_total / 1e3
        by_class[cls] = by_class.get(cls, 0.0) + ms
        kernels.append((ms, e.count, cls, e.key[:90]))
    kernels.sort(reverse=True)
    busy = sum(by_class.values())
    print(json.dumps({
        "profile": "train_step", "arch": cfg.name, "batch": B, "seq": S,
        "wall_ms": wall_ms, "wall_ms_profiled": prof_wall_ms,
        "device_ms": busy, "idle_share": 1.0 - busy / wall_ms,
        "device_ms_by_class": by_class,
        "kernel_launches": sum(k[1] for k in kernels),
        "top_kernels": [dict(ms=k[0], count=k[1], cls=k[2], name=k[3])
                        for k in kernels[:12]], **tag}), flush=True)

    # ---- stages at the step's shapes ------------------------------------
    model = tr.state["params"]
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = rand(B, S, H, D), rand(B, S, Hkv, D), rand(B, S, Hkv, D)
    for t in (q, k, v):
        t.requires_grad_(True)
    g_out = rand(B, S, H, D)
    x = rand(B, S, cfg.d_model).requires_grad_(True)
    g_x = rand(B, S, cfg.d_model)
    layer, kind = model.layers[0], model.kinds[0]
    head = transformer._head(model, cfg)

    # a remat'd layer's first forward runs in grad mode with its saved
    # tensors dropped (non-reentrant checkpoint), so it takes the same
    # plain attention path as a forward that builds a graph
    def attn_fwd():
        return gqa_attend(q, k, v)

    def attn_fwd_bwd():
        attn_fwd().backward(g_out)

    def layer_fwd():
        return transformer._forward_layer(kind, layer, x, cfg)

    def layer_fwd_bwd():
        layer_fwd()[0].backward(g_x)

    labels = batch["labels"]

    def head_ce():
        h = apply_norm(cfg.norm, x, model.final_norm)
        cross_entropy(h @ head.to(h.dtype), labels).backward()

    grads = {n: torch.randn(p.shape, generator=gen, device=dev).to(p.dtype)
             for n, p in model.named_parameters()}
    opt = tr.opt

    def adamw():
        adamw_update(opt, model, grads, tr.state["opt"])

    reps = 5
    t_attn_fwd = timed(attn_fwd, reps)
    t_attn_fb = timed(attn_fwd_bwd, reps)
    t_layer_fwd = timed(layer_fwd, reps)
    t_layer_fb = timed(layer_fwd_bwd, reps)
    t_head = timed(head_ce, reps)
    t_adamw = timed(adamw, reps)
    L = cfg.n_layers
    shares = {"attention_core": L * (t_attn_fwd + t_attn_fb),
              "layers_other": L * (t_layer_fwd + t_layer_fb
                                   - t_attn_fwd - t_attn_fb),
              "head_cross_entropy": t_head, "adamw": t_adamw}
    print(json.dumps({
        "profile": "train_stages", "arch": cfg.name, "batch": B, "seq": S,
        "layers": L, "attention_fwd_ms": t_attn_fwd,
        "attention_fwd_bwd_ms": t_attn_fb, "layer_fwd_ms": t_layer_fwd,
        "layer_fwd_bwd_ms": t_layer_fb, "head_cross_entropy_ms": t_head,
        "adamw_ms": t_adamw, "step_share_ms": shares,
        "sum_of_shares_ms": sum(shares.values()), "step_ms": wall_ms,
        **tag}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
