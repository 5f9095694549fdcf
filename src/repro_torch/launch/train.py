"""Training launcher, the port of ``src/repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \
      [--device cpu]

Fault tolerance demo: run with --fail-at-step N, re-run the same command —
the trainer resumes from the last checkpoint.  Heterogeneous topologies
(--hetero fast_frac,fast_speed,fast_mem) route the global batch with
Algorithm 1 (core.block_sizes.hetero_batch_split).  Without ``--device``
it trains on the card.
"""
from __future__ import annotations

import argparse

from ..configs.registry import ARCHS, get_config
from ..core.topology import Topology
from ..train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--hetero", default="",
                    help="fast_frac,fast_speed,fast_mem e.g. 0.25,4,5.2")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    topo = None
    if args.hetero:
        frac, spd, mem = (float(x) for x in args.hetero.split(","))
        topo = Topology.topo1(max(args.batch, 4), frac, spd, mem)
    tcfg = TrainerConfig(steps=args.steps, seq_len=args.seq,
                         global_batch=args.batch, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, lr=args.lr,
                         fail_at_step=args.fail_at_step)
    tr = Trainer(cfg, tcfg, topo=topo, device=args.device)
    if not args.no_resume and tr.maybe_resume():
        print(f"resumed from step {tr.step}")
    if topo is not None:
        print(f"Algorithm-1 batch shares: {tr.shares.tolist()}")
    losses = tr.run()
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")


if __name__ == "__main__":
    main()
