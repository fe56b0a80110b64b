"""Query similarity (Def 4.4/4.5) from hop-constrained neighborhoods.

Counterpart of the kernel route of ``repro/core/similarity.py``. Γ(q) /
Γ_r(q) are by-products of the index BFS: a vertex is in Γ(q) iff
dist(q.s, v) <= q.k. They are materialized as boolean rows, packed into
words, and the all-pairs intersection sizes come from the
``pairwise_popcount`` kernel (two launches per batch: Γ and Γ_r).

μ is the arithmetic mean of the two directional overlap coefficients
i = |Γ_A ∩ Γ_B| / min(|Γ_A|, |Γ_B|), computed on the host in float64 from
the exact integer intersections, so it equals the reference exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from .index import QueryIndex
from ..kernels.pairwise_popcount.ops import pairwise_intersections

__all__ = ["gamma_matrix", "similarity_matrix"]


def gamma_matrix(index: QueryIndex, reverse: bool = False) -> torch.Tensor:
    """(Q, n) bool -- Γ_r if reverse else Γ."""
    dist = index.dist_t if reverse else index.dist_s
    col = index.tgt_col if reverse else index.src_col
    ks = torch.as_tensor(np.array([q[2] for q in index.queries], np.int8),
                         device=dist.device)
    cols = dist[:-1, torch.as_tensor(col, dtype=torch.int64,
                                     device=dist.device)]    # (n, Q)
    return (cols <= ks[None, :]).T


def similarity_matrix(index: QueryIndex) -> np.ndarray:
    """(Q, Q) float64 μ matrix on host (diagonal = 1)."""
    gf = gamma_matrix(index, reverse=False)
    gr = gamma_matrix(index, reverse=True)
    inter_f = pairwise_intersections(gf).cpu().numpy()
    inter_r = pairwise_intersections(gr).cpu().numpy()
    size_f = gf.sum(1).cpu().numpy().astype(np.int64)
    size_r = gr.sum(1).cpu().numpy().astype(np.int64)

    def overlap(inter, size):
        mins = np.minimum(size[:, None], size[None, :]).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            i = np.where(mins > 0, inter / np.maximum(mins, 1), 0.0)
        return np.where(inter > 0, i, 0.0)

    mu = 0.5 * (overlap(inter_f, size_f) + overlap(inter_r, size_r))
    np.fill_diagonal(mu, 1.0)
    return mu
