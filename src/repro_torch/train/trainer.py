"""Fault-tolerant training loop, ported from ``src/repro/train/trainer.py``.

  * one process runs the whole global batch through
    ``models.steps.make_train_step`` on one device;
  * a checkpoint every ``ckpt_every`` steps and at the last (atomic, GC'd),
    and ``maybe_resume`` from the latest: crash and restart is the
    fault-tolerance primitive (``fail_at_step`` injects the crash);
  * elastic re-balancing: on a topology change the per-PU batch shares
    are recomputed with Algorithm 1 (``core.block_sizes.
    hetero_batch_split``), the paper's LDHT technique applied to
    heterogeneous data parallelism.  As in the reference, the shares are
    computed and reported; the one process still runs the whole batch;
  * a straggler hook (``measured_speeds_rebalance``) where measured step
    times would replace the speeds; one process has uniform speeds, so it
    returns the shares.

The model is made by the family's ``init_model`` from ``tcfg.seed`` and is
the one module of the port whose parameters require grad.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..core.block_sizes import hetero_batch_split
from ..core.topology import Topology, scale_to_load
from ..data.pipeline import DataConfig, SyntheticLM
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.steps import make_train_step, model_module
from .checkpoint import latest_checkpoint, restore_checkpoint, \
    save_checkpoint
from .optimizer import AdamWConfig, init_opt_state


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    lr: float = 3e-4
    fail_at_step: int = -1      # fault injection for tests and demos


class Trainer:
    """``Trainer(cfg, tcfg, topo=None, device=None)``; ``device=None`` is
    the card (raises without one)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 topo: Topology | None = None, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.topo = topo or Topology.homogeneous(1, memory=1e9)
        self.device = resolve_device(device)
        params = model_module(cfg).init_model(cfg, seed=tcfg.seed,
                                              device=self.device)
        params.requires_grad_(True)
        self.state = {"params": params, "opt": init_opt_state(params)}
        self.opt = AdamWConfig(lr=tcfg.lr, total_steps=tcfg.steps,
                               warmup_steps=max(tcfg.steps // 20, 5))
        self.train_step = make_train_step(cfg, self.opt)
        self.data = SyntheticLM(DataConfig(
            vocab=cfg.vocab, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed))
        self.step = 0
        self.step_times: list[float] = []
        # Algorithm 1: per-PU batch shares (heterogeneous data parallelism)
        self.shares = hetero_batch_split(tcfg.global_batch, self._scaled())

    def _scaled(self) -> Topology:
        """The topology with memory rescaled to the batch 'load'."""
        return scale_to_load(self.topo, self.tcfg.global_batch, 1.5)

    # -- fault tolerance ----------------------------------------------------
    def maybe_resume(self) -> bool:
        """Restore the latest checkpoint of ``tcfg.ckpt_dir`` into the
        state, in place; False if there is none."""
        path = latest_checkpoint(self.tcfg.ckpt_dir)
        if path is None:
            return False
        self.state, manifest = restore_checkpoint(path, self.state)
        self.step = int(manifest["step"])
        return True

    def rebalance(self, surviving: Topology):
        """Elastic scaling: recompute the per-PU shares after a topology
        change.  O(k log k), negligible next to a step."""
        self.topo = surviving
        self.shares = hetero_batch_split(self.tcfg.global_batch,
                                         self._scaled())
        return self.shares

    def measured_speeds_rebalance(self):
        """Straggler mitigation: observed step times as 1 / speed.  One
        process has uniform speeds; the hook is for multi-host runs where
        the per-host times differ."""
        return self.shares

    # -- loop -----------------------------------------------------------------
    def _batch(self, step: int) -> dict:
        """``SyntheticLM``'s batch of ``step``, and a VLM's ``img_embeds`` or
        the audio family's ``frames`` drawn from ``default_rng(step)`` as
        the reference draws them, as tensors on the trainer's device."""
        b = self.data.batch(step)
        if self.cfg.family == "vlm":
            rng = np.random.default_rng(step)
            b["img_embeds"] = rng.normal(scale=0.02, size=(
                self.tcfg.global_batch, self.cfg.n_img_tokens,
                self.cfg.d_model)).astype(np.float32)
        if self.cfg.family == "audio":
            rng = np.random.default_rng(step)
            b["frames"] = rng.normal(scale=0.02, size=(
                self.tcfg.global_batch, self.cfg.n_frames,
                self.cfg.d_model)).astype(np.float32)
        return {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}

    def run(self, on_metrics: Callable[[int, dict], None] | None = None):
        """Train from ``self.step`` to ``tcfg.steps``; returns the losses."""
        losses = []
        while self.step < self.tcfg.steps:
            if self.step == self.tcfg.fail_at_step:
                raise RuntimeError(
                    f"injected fault at step {self.step}")  # demo / testing
            t0 = time.perf_counter()
            batch = self._batch(self.step)
            self.state, metrics = self.train_step(self.state, batch)
            self.step += 1
            loss = float(metrics["loss"])
            losses.append(loss)
            self.step_times.append(time.perf_counter() - t0)
            if on_metrics:
                on_metrics(self.step, metrics)
            if self.step % self.tcfg.log_every == 0:
                print(f"step {self.step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({self.step_times[-1]*1e3:.0f} ms)", flush=True)
            if self.step % self.tcfg.ckpt_every == 0 \
                    or self.step == self.tcfg.steps:
                save_checkpoint(self.tcfg.ckpt_dir, self.state, self.step,
                                extra={"arch": self.cfg.name},
                                keep=self.tcfg.keep)
        return losses
