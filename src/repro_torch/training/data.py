"""Deterministic synthetic data pipeline (a copy of
``repro/training/data.py``: numpy only, so ``batch(step)`` is bitwise the
reference's for every ``(seed, step, shape)``).

Fault-tolerance contract: batch(step) is a pure function of (seed, step,
shape) — a restarted or re-scheduled host regenerates exactly the batch it
would have consumed, so checkpoint-restart and straggler re-execution are
bit-exact (no data-loader state to snapshot). Mirrors the
deterministic-replay design of production loaders at the cost of a synthetic
corpus: token sequences are Zipf-distributed with a Markov bigram structure so
the LM loss actually decreases.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.1


class SyntheticLMData:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = rng.permutation(v)
        w = 1.0 / np.power(ranks + 1.0, cfg.zipf_a)
        self.unigram = w / w.sum()
        # sparse bigram structure: each token prefers a few successors
        self.succ = rng.integers(0, v, size=(v, 4))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for ``step`` (independent of history)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        toks = np.empty((B, S + 1), dtype=np.int32)
        toks[:, 0] = rng.choice(cfg.vocab_size, size=B, p=self.unigram)
        follow = rng.random(size=(B, S)) < 0.7
        succ_pick = rng.integers(0, self.succ.shape[1], size=(B, S))
        rand_tok = rng.choice(cfg.vocab_size, size=(B, S), p=self.unigram)
        for t in range(S):
            nxt = np.where(follow[:, t],
                           self.succ[toks[:, t], succ_pick[:, t]],
                           rand_tok[:, t])
            toks[:, t + 1] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def batches(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
