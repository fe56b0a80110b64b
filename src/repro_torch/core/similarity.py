"""Query similarity (Def 4.4/4.5) from hop-constrained neighborhoods.

Counterpart of the kernel route of ``repro/core/similarity.py``. Γ(q) /
Γ_r(q) are by-products of the index BFS: a vertex is in Γ(q) iff
dist(q.s, v) <= q.k. On the card they go straight from the index's int8
distances to packed words (``gamma_pack``) and the all-pairs intersection
sizes come from ``pairwise_popcount`` (one launch of each per direction,
two per batch); on the CPU the plain composition builds the boolean rows
and packs them. The Γ sizes are the diagonal of the intersections
(|Γ ∩ Γ| = |Γ|), and both (Q, Q) matrices reach the host in one copy.

μ is the arithmetic mean of the two directional overlap coefficients
i = |Γ_A ∩ Γ_B| / min(|Γ_A|, |Γ_B|), computed on the host in float64 from
the exact integer intersections, so it equals the reference exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from .index import QueryIndex
from ..kernels.pairwise_popcount.ops import gamma_intersections

__all__ = ["gamma_inputs", "similarity_matrix"]


def gamma_inputs(index: QueryIndex, reverse: bool = False):
    """``(dist, col, ks)`` of Γ_r if reverse else Γ, on the index's device:
    the (n+1, Su) int8 distances, each query's (Q,) int32 column in them
    and its (Q,) int8 hop budget."""
    dist = index.dist_t if reverse else index.dist_s
    col = torch.as_tensor(index.tgt_col if reverse else index.src_col,
                          dtype=torch.int32, device=dist.device)
    ks = torch.as_tensor(np.array([q[2] for q in index.queries], np.int8),
                         device=dist.device)
    return dist, col, ks


def similarity_matrix(index: QueryIndex) -> np.ndarray:
    """(Q, Q) float64 μ matrix on host (diagonal = 1)."""
    n = index.dist_s.shape[0] - 1
    inter_f, inter_r = torch.stack([
        gamma_intersections(*gamma_inputs(index, reverse), n)
        for reverse in (False, True)]).cpu().numpy()
    size_f = np.diagonal(inter_f).astype(np.int64)
    size_r = np.diagonal(inter_r).astype(np.int64)

    def overlap(inter, size):
        mins = np.minimum(size[:, None], size[None, :]).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            i = np.where(mins > 0, inter / np.maximum(mins, 1), 0.0)
        return np.where(inter > 0, i, 0.0)

    mu = 0.5 * (overlap(inter_f, size_f) + overlap(inter_r, size_r))
    np.fill_diagonal(mu, 1.0)
    return mu
