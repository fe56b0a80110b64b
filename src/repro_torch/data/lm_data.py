"""Deterministic synthetic token stream (a copy of ``repro/data/lm_data.py``).

Zipf-distributed tokens with local n-gram structure so the loss actually
falls during the example runs (pure-uniform streams have no learnable
signal). Stateless: batch(step) is a pure function of (seed, step), which
makes checkpoint-resume exact — the restored run consumes the identical
stream. The port draws its serving prompts from it.
"""
from __future__ import annotations

import numpy as np

__all__ = ["TokenStream"]


class TokenStream:
    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed

    def batch_at(self, step: int):
        rng = np.random.default_rng((self.seed, step))
        B, S, V = self.batch, self.seq_len, self.vocab
        # zipf-ish marginals
        base = rng.zipf(1.5, size=(B, S + 1)) % V
        # inject learnable bigram structure: x[t+1] = (x[t]*7+3) % V half the time
        follow = (base * 7 + 3) % V
        use = rng.random((B, S + 1)) < 0.5
        seq = np.where(use, np.roll(follow, 1, axis=1), base)
        seq = seq.astype(np.int32)
        return seq[:, :S], seq[:, 1:S + 1]
