"""Synthetic recsys interaction stream (Zipf item popularity).

A numpy copy of ``repro/data/recsys_data.py``: the same batches for the
same seed and step."""
from __future__ import annotations

import numpy as np

from ..config import RecsysConfig

__all__ = ["InteractionStream"]


class InteractionStream:
    def __init__(self, cfg: RecsysConfig, batch: int, seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        B, H = self.batch, self.cfg.n_user_hist
        items = (rng.zipf(1.3, size=(B,)) - 1) % self.cfg.n_items
        hist = (rng.zipf(1.3, size=(B, H)) - 1) % self.cfg.n_items
        # pad short histories with -1
        lens = rng.integers(1, H + 1, size=(B,))
        mask = np.arange(H)[None, :] < lens[:, None]
        hist = np.where(mask, hist, -1)
        # uniform-sampler logQ correction (Zipf popularity estimate)
        freq = 1.0 / (1.0 + items.astype(np.float64)) ** 1.3
        logq = np.log(freq / freq.sum() * B).astype(np.float32)
        return {"hist_ids": hist.astype(np.int32),
                "item_ids": items.astype(np.int32),
                "sampling_logq": logq}
