"""ClusterQuery (Algorithm 2): threshold-stopped agglomerative clustering.

A numpy copy of ``repro/core/clustering.py`` (host code).

Group similarity δ (Def 4.6) is the all-pairs average of μ, so merging is
exactly average-linkage; we keep the O(|C|^2) merge scan of the paper
(|Q| is "medium in size") with the standard Lance–Williams update instead
of recomputing δ from scratch each round.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["cluster_queries"]


def cluster_queries(mu: np.ndarray, gamma: float,
                    bias: Optional[np.ndarray] = None,
                    min_clusters: int = 1) -> list[list[int]]:
    """Cluster query ids 0..Q-1 on the μ matrix; stop when max δ <= γ.

    bias : optional (Q, Q) symmetric additive bonus applied to μ before
           linkage — the streaming server uses it to pull queries into
           clusters whose shared HC-s path results are already warm in the
           cross-batch cache (cache-aware admission). The biased similarity
           is clipped back to [0, 1] so γ keeps its meaning.

    min_clusters : stop merging once this many clusters remain (before the
           γ threshold would). Sharded engines pass their replica count
           (``EngineConfig.balance_clusters``) so a highly similar batch
           cannot collapse below one data-parallel work unit per device;
           the default 1 keeps the paper's pure γ-threshold stop.

    Returns a partition (list of clusters, each a list of query indices).
    """
    Q = mu.shape[0]
    clusters: dict[int, list[int]] = {i: [i] for i in range(Q)}
    delta = mu.astype(np.float64).copy()
    if bias is not None:
        delta = np.clip(delta + np.asarray(bias, np.float64), 0.0, 1.0)
    np.fill_diagonal(delta, -np.inf)
    alive = list(range(Q))
    while len(alive) > max(int(min_clusters), 1):
        sub = delta[np.ix_(alive, alive)]
        flat = np.argmax(sub)
        i_, j_ = divmod(flat, len(alive))
        best = sub[i_, j_]
        if best <= gamma:
            break
        a, b = alive[i_], alive[j_]
        na, nb = len(clusters[a]), len(clusters[b])
        # Lance–Williams average-linkage update of δ(a∪b, c)
        for c in alive:
            if c in (a, b):
                continue
            delta[a, c] = delta[c, a] = (na * delta[a, c] + nb * delta[b, c]) / (na + nb)
        clusters[a] = clusters[a] + clusters[b]
        del clusters[b]
        delta[b, :] = -np.inf
        delta[:, b] = -np.inf
        alive.remove(b)
    return [sorted(v) for v in clusters.values()]
