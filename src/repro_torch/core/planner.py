"""Cost-routed adaptive planning: GREEN / YELLOW / RED query tiers.

A copy of ``repro/core/planner.py`` (host code), but for the ball costs:
the router reads them for the whole batch at once, counted on the index's
device (:func:`repro_torch.core.distributed.query_ball_costs`, the same
floats as the reference's per-query ``query_ball_cost``).

One global ``Planner`` flag leaves time on the table for mixed batches:
trivial queries (short hop budget, tiny frontier ball, exists-only) pay
the full similarity + detection + cache machinery whose overhead dwarfs
their enumeration, while genuinely heavy clusters are exactly where that
machinery — and sharded placement — earns its keep. This module routes
each query by a cost estimate read straight off the index distance
matrices (the same per-query term LPT placement already uses, see
:func:`repro_torch.core.distributed.query_ball_costs`):

  * **GREEN**  -- direct bidirectional sweep off the shared index; skips
                  similarity, clustering, detection and the cross-batch
                  cache entirely. exists-only and index-unreachable
                  queries are answered by the index build itself (one
                  fused MS-BFS pass): ``dist_G(s, t) <= k`` iff a
                  ``<= k``-hop simple path exists, because shortest walks
                  are simple.
  * **YELLOW** -- the cached batch engine as today (cluster -> detect ->
                  shared enumeration -> ⊕ assembly).
  * **RED**    -- heavy clusters on a sharded engine: cost-balanced LPT
                  placement across the per-device replicas of
                  ``ShardedExecutor``.
                  Without a mesh the tier degrades to YELLOW (there is
                  nothing to place on).

The router also makes the *per-cluster* planner choice inside the batch
path: a cluster with nothing to share and no cache to consult runs the
direct per-query plan (:meth:`BatchPathEngine._cluster_basic`) instead of
paying Ψ detection — decided from the same cost model, not a global
``EngineConfig.planner`` flag. Every choice is exact either way; routing
may only change wall time, never results (the AUTO-vs-forced parity
tests pin this).

Estimation reads the already-memoized host distances
(``BatchPathEngine._dists_host``) for reachability and counts the balls
with one reduction per hop budget on the index's device; the
``route.estimate`` span and the ``routed_green|yellow|red`` counters make
it observable.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

from .distributed import query_ball_costs
from .query import Output, PathQuery

__all__ = ["Route", "CostEstimate", "RouterConfig", "CostRouter",
           "admission_fast_path"]


class Route(enum.Enum):
    """Execution tier a query/cluster is routed to under ``Planner.AUTO``."""

    GREEN = "green"      # direct sweep: no clustering/detection/cache
    YELLOW = "yellow"    # cached batch engine (the default machinery)
    RED = "red"          # sharded fan-out via ShardedExecutor


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Per-query routing decision + the numbers that produced it.

    ``raw_cost`` is the unweighted enumeration estimate
    ``k × (|ball_a(s)| + |ball_b(t)|)`` shared with LPT placement;
    ``cost`` weights it by what the query actually asks for (exists-only
    is free — the index already holds the answer — count skips assembly,
    a ``limit`` caps the useful work). ``reachable`` is the index verdict
    ``dist_G(s, t) <= k``; unreachable queries cost nothing regardless of
    output kind because every planner would return an empty result.
    """

    qi: int
    cost: float
    raw_cost: float
    reachable: bool
    route: Route


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Routing thresholds and output-kind weights (engine-level knob:
    ``EngineConfig.router``). Defaults are deliberately coarse — the
    tiers only need to separate "overhead-dominated" from "enumeration-
    dominated" queries, not rank them precisely."""

    green_max_cost: float = 4096.0       # cost at or below: GREEN
    red_min_cost: float = float(1 << 22)  # cluster cost at or above: RED
    # (RED applies per *cluster*, post-clustering, and only on a mesh)
    count_weight: float = 0.5            # count-only: no ⊕ assembly rows
    limit_unit: float = 64.0             # est. cost per row a limit allows


class CostRouter:
    """Per-query cost estimation + tier routing + per-cluster planner
    choice, all from the index distance matrices."""

    def __init__(self, config: Optional[RouterConfig] = None):
        self.cfg = config or RouterConfig()

    def estimate(self, index, queries: Sequence[PathQuery],
                 dists: tuple) -> list[CostEstimate]:
        """One :class:`CostEstimate` per query.

        ``dists`` is the engine's host-dist memo ``(dist_s, dist_t)``,
        read for each query's reachability; the ball costs are counted
        on the index's device, and only the counts come back.
        """
        ds = dists[0]
        cfg = self.cfg
        raws = query_ball_costs(index, range(len(queries)))
        ests = []
        for qi, q in enumerate(queries):
            raw = raws[qi]
            reachable = int(ds[q.t, index.src_col[qi]]) <= q.k
            if not reachable or q.output is Output.EXISTS:
                # the index build already decided these: nothing to route
                cost = 0.0
            else:
                cost = raw * (cfg.count_weight
                              if q.output is Output.COUNT else 1.0)
                if q.limit is not None:
                    # early termination caps the useful work at ~limit rows
                    cost = min(cost, float(q.k) * q.limit * cfg.limit_unit)
            route = Route.GREEN if cost <= cfg.green_max_cost else Route.YELLOW
            ests.append(CostEstimate(qi=qi, cost=cost, raw_cost=raw,
                                     reachable=reachable, route=route))
        return ests

    def cluster_route(self, cluster: Sequence[int],
                      est_of: dict, sharded: bool) -> Route:
        """Tier of one post-clustering cluster: RED when its summed cost
        clears ``red_min_cost`` *and* a mesh exists to place it on;
        YELLOW otherwise (RED degrades to YELLOW on a single device)."""
        if sharded and sum(est_of[qi].cost for qi in cluster) \
                >= self.cfg.red_min_cost:
            return Route.RED
        return Route.YELLOW

    def cluster_planner(self, cluster: Sequence[int], est_of: dict,
                        has_cache: bool) -> str:
        """Per-cluster planner choice: ``"batch"`` (Ψ detection + shared
        enumeration + cache) or ``"basic"`` (direct per-query plan).

        A singleton cluster has nothing to share, so detection is pure
        bookkeeping — but with a cross-batch cache configured the batch
        plan still pays for itself through half-query hits, so only a
        cache-less singleton takes the direct plan. Both plans are exact;
        this choice can only move wall time.
        """
        if len(cluster) > 1 or has_cache:
            return "batch"
        return "basic"


def admission_fast_path(q: PathQuery) -> bool:
    """Pre-index GREEN predicate for streaming admission.

    True when the query is certain to route GREEN on *any* graph, so the
    server may answer it immediately instead of coalescing it into a
    micro-batch: exists-only queries always qualify (the index build
    answers them outright — estimation weights them to zero cost).
    Everything else depends on ball sizes admission cannot know without
    an index, so it waits for its micro-batch.
    """
    return q.output is Output.EXISTS
