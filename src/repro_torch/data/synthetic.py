"""Deterministic synthetic token pipeline, host-sharded (port of
`repro.data.synthetic`, a copy: the module is pure numpy, so the
batches equal the reference's bit for bit at every (seed, step, host)).

A reproducible stream of (B, S+1) token batches: a Zipfian unigram
mixture plus a fixed successor "grammar" that half the positions
follow, so calibration sees realistic activation ranges.  Each host
draws only its data-parallel slice, keyed by (seed, step, host).
`launch.serve.deploy_model` calibrates on `batch(0)`.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 17
    zipf_a: float = 1.2


class SyntheticStream:
    def __init__(
        self, cfg: SyntheticConfig, *, host_index: int = 0, n_hosts: int = 1
    ):
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.host_index = host_index
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        # fixed unigram distribution (shared across hosts)
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.probs = p / p.sum()
        # a fixed "grammar": each token has a preferred successor
        self.successor = rng.integers(0, cfg.vocab, size=cfg.vocab)

    def batch(self, step: int) -> np.ndarray:
        """(local_batch, seq_len + 1) int32, deterministic in (step, host)."""
        c = self.cfg
        rng = np.random.default_rng((c.seed, step, self.host_index))
        toks = rng.choice(
            c.vocab, size=(self.local_batch, c.seq_len + 1), p=self.probs
        ).astype(np.int32)
        # 50% of positions follow the grammar
        follow = rng.random((self.local_batch, c.seq_len)) < 0.5
        nxt = self.successor[toks[:, :-1]]
        toks[:, 1:] = np.where(follow, nxt, toks[:, 1:])
        return toks

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
