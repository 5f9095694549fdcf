"""End-to-end training example on the PyTorch port: mamba2-130m (a full
assigned architecture, ~129M params) on the synthetic pipeline with
checkpointing; the port of ``examples/train_lm.py``.

  PYTHONPATH=src python examples/train_lm_torch.py --steps 300 --seq 256 --batch 4
  PYTHONPATH=src python examples/train_lm_torch.py --smoke --steps 50 --device cpu

Without ``--device`` it trains on the card.
"""
import argparse

from repro_torch.configs.registry import get_config
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm_torch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    print(f"training {cfg.name}: {cfg.param_count / 1e6:.0f}M params")
    tcfg = TrainerConfig(steps=args.steps, seq_len=args.seq,
                         global_batch=args.batch, ckpt_every=50,
                         ckpt_dir=args.ckpt_dir, log_every=10)
    tr = Trainer(cfg, tcfg, device=args.device)
    if tr.maybe_resume():
        print(f"resumed from step {tr.step}")
    losses = tr.run()
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"over {len(losses)} steps")
    return losses


if __name__ == "__main__":
    main()
