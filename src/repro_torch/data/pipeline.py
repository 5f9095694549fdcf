"""Deterministic synthetic token pipeline, copied from
``src/repro/data/pipeline.py`` (host NumPy; the same draws, bit-equal).

Serves the role of the input pipeline substrate: deterministic given (seed,
step) — so a restarted job resumes mid-epoch at the exact batch — and
shard-aware (each data-parallel rank can materialize only its slice).

The token stream is a mixture of Zipf-distributed unigrams with short
Markov motifs, which gives a learnable (loss goes down) yet stationary
distribution — adequate for throughput/convergence smoke tests.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3


class SyntheticLM:
    """batch(step) -> {'tokens','labels'} with labels = next-token."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        # motif table: each token deterministically prefers a successor
        self._succ = rng.integers(0, v, size=v, dtype=np.int64)

    def batch(self, step: int, rank: int = 0, world: int = 1):
        cfg = self.cfg
        per = cfg.global_batch // world
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + rank)
        base = rng.zipf(cfg.zipf_a, size=(per, cfg.seq_len + 1))
        base = (base - 1) % cfg.vocab
        # 50% of positions follow the motif successor of the previous token
        follow = rng.random((per, cfg.seq_len)) < 0.5
        seq = base.copy()
        for t in range(1, cfg.seq_len + 1):
            f = follow[:, t - 1]
            seq[f, t] = self._succ[seq[f, t - 1]]
        tokens = seq[:, :-1].astype(np.int32)
        labels = seq[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}
