"""Deterministic synthetic token pipeline: the counterpart of
``repro.data.pipeline``.

Stateless: ``batch_for_step(step)`` is a pure function of (seed, step),
drawn from a CPU ``torch.Generator`` seeded from both, so a restart
resumes the same data order with nothing to checkpoint.  The tokens
have the reference's structure (Zipfian unigrams; with probability
``repeat_p`` a position copies the token 8 back, cyclically) but not its
numbers: ``jax.random`` draws other bits than torch.  Tests that hold
the port against the reference hand it the reference's batches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    repeat_p: float = 0.3     # probability of copying an earlier token


def _zipf_probs(vocab: int, a: float) -> torch.Tensor:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-a)
    return torch.from_numpy(p / p.sum())


class SyntheticLM:
    """step -> {"tokens", "labels"} (int64 (B, S) on the CPU) with
    tokens[:, t+1] == labels[:, t]."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._probs = _zipf_probs(cfg.vocab, cfg.zipf_a)

    def _sample(self, gen: torch.Generator, batch: int) -> torch.Tensor:
        c = self.cfg
        n = batch * (c.seq_len + 1)
        base = torch.multinomial(self._probs, n, replacement=True,
                                 generator=gen).reshape(batch, -1)
        rep = torch.rand((batch, c.seq_len + 1), generator=gen,
                         dtype=torch.float64) < c.repeat_p
        return torch.where(rep, torch.roll(base, 8, dims=1), base)

    def batch_for_step(self, step: int, mesh=None) -> dict:
        if mesh is not None:
            raise NotImplementedError(
                "sharded batches: ROADMAP queue 1 item 13 (distributed)")
        c = self.cfg
        gen = torch.Generator().manual_seed(
            (c.seed * 1_000_003 + step) % 2 ** 63)
        toks = self._sample(gen, c.global_batch)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
