"""The per-query cost term of cluster placement and AUTO routing.

Counterpart of ``repro/core/distributed.py``, of which only
:func:`query_ball_cost` is ported: ``Planner.AUTO`` routes by it. The
sharded executor (``ShardedExecutor``, LPT ``plan_clusters``) is not
ported, so ``EngineConfig.mesh`` and ``n_devices > 1`` are refused.
"""
from __future__ import annotations

from .query import midpoint_split

__all__ = ["query_ball_cost"]


def query_ball_cost(index, qi: int, dists: tuple) -> float:
    """Estimated enumeration cost of one query:
    ``k × (|ball_a(s)| + |ball_b(t)|)``, where the balls count vertices
    within the midpoint-split hop budgets of each endpoint -- a
    frontier-size estimate read straight from the index distance
    matrices (``dists`` = host ``(dist_s, dist_t)``, sentinel row
    included; sliced off here). The per-query term of GREEN/YELLOW/RED
    routing (:class:`repro_torch.core.planner.CostRouter`). Deliberately
    cheap: callers need relative weight, not the exact DP bound.
    """
    ds, dt = dists[0][:-1], dists[1][:-1]
    _, _, k = index.queries[qi]
    a, b = midpoint_split(k)
    ball = int((ds[:, index.src_col[qi]] <= a).sum()) \
        + int((dt[:, index.tgt_col[qi]] <= b).sum())
    return float(k) * float(ball)
