"""Token serving: batched prefill, then KV-cache decode with sampling,
ported from the token mode of ``src/repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --batch 8 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Weights are random, drawn from a seeded ``torch.Generator``; prompts come
from ``np.random.default_rng(0)`` as in the reference.  The sampled tokens
stay on the device and are copied to the host once, at the end.  Sampling
is Gumbel-max over the padded vocabulary at ``--temperature``, then clamped
to ``vocab - 1``, as the reference's ``jax.random.categorical`` step is;
the two generators draw different tokens.

The reference's solver mode (``--solver``, ``SolverService``) is not
ported yet (ROADMAP.md queue 1 item 7).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.registry import ARCHS, get_config
from ..device import resolve_device
from ..kernels import _build
from ..models import transformer
from ..models.config import ModelConfig
from ..models.steps import make_decode_step


class _Timer:
    """Milliseconds of the work between enter and exit: CUDA events on
    the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.ms = 0.0

    def __enter__(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            self.ms = self.start.elapsed_time(self.end)
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3
        return False


def sample(logits: torch.Tensor, temperature: float,
           gen: torch.Generator) -> torch.Tensor:
    """Categorical draw per row of (B, V) logits (Gumbel-max, float32)."""
    u = torch.rand(logits.shape, generator=gen, dtype=torch.float32,
                   device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() / temperature + gumbel, dim=-1)


def serve_tokens(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 32,
                 gen: int = 32, temperature: float = 0.8, seed: int = 0,
                 device=None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode ``gen`` tokens each.  ``device=None`` is the card (raises
    without one).

    Returns the numbers: ``prefill_ms``, ``decode_ms_per_token`` and
    ``tok_per_s`` (None for ``gen == 0``), ``tokens`` (host int array of
    prompts and generated ids), ``logits`` (the last step's, on the
    device) and the kernel launches of the prefill and of the decode loop
    (``launches_prefill``, ``launches_decode``).
    """
    dev = resolve_device(device)
    model = transformer.init_model(cfg, seed=seed, device=dev)
    decode = make_decode_step(cfg)
    rng = np.random.default_rng(0)
    cache_len = prompt_len + max(gen, 1)
    prompts = rng.integers(0, cfg.vocab, size=(batch, prompt_len),
                           dtype=np.int32)
    tokens = torch.from_numpy(prompts).to(dev)
    if dev.type == "cuda":
        _build.build_all(["flash", "flash_sm90"])  # set-up, not prefill

    before = _build.launches()
    with _Timer(dev) as t_prefill:
        logits, cache = transformer.prefill_forward(model, cfg, tokens,
                                                    cache_len=cache_len)
    mid = _build.launches()

    sampler = torch.Generator(device=dev).manual_seed(seed + 1)
    out = torch.empty((batch, gen), dtype=torch.int64, device=dev)
    with _Timer(dev) as t_decode:
        for t in range(gen):
            tok = sample(logits[:, -1], temperature, sampler)
            tok = torch.clamp_max(tok, cfg.vocab - 1)[:, None]
            out[:, t:t + 1] = tok
            logits, cache = decode(model, cache, tok, prompt_len + t)
    after = _build.launches()
    decode_ms = t_decode.ms / gen if gen else None
    return dict(
        arch=cfg.name, device=str(dev), batch=batch, prompt_len=prompt_len,
        gen=gen, prefill_ms=t_prefill.ms, decode_ms_per_token=decode_ms,
        tok_per_s=batch * gen / (t_decode.ms / 1e3) if gen else None,
        tokens=np.concatenate([prompts, out.cpu().numpy()], axis=1),
        logits=logits,
        launches_prefill={k: mid[k] - before[k] for k in mid},
        launches_decode={k: after[k] - mid[k] for k in after})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--solver", action="store_true",
                    help="serve CG solves instead of tokens (not ported)")
    ap.add_argument("--arch", choices=ARCHS, default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.solver:
        raise NotImplementedError(
            "--solver (SolverService) is not ported yet (ROADMAP.md queue 1 "
            "item 7)")
    cfg = get_config(args.arch, smoke=args.smoke)
    r = serve_tokens(cfg, batch=args.batch, prompt_len=args.prompt_len,
                     gen=args.gen, temperature=args.temperature,
                     device=args.device)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} device={r['device']}")
    if args.gen:        # --gen 0 is prefill-only: no per-token rate exists
        print(f"prefill {r['prefill_ms']:.1f} ms; decode "
              f"{r['decode_ms_per_token']:.2f} ms/token "
              f"({r['tok_per_s']:.1f} tok/s)")
    else:
        print(f"prefill {r['prefill_ms']:.1f} ms; decode skipped (--gen 0)")
    print("sample token ids:",
          r["tokens"][0, :args.prompt_len + min(args.gen, 8)].tolist())


if __name__ == "__main__":
    main()
