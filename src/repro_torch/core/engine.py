"""BatchPathEngine: BasicEnum (Alg 1), BatchEnum (Alg 4), the "+" variants,
the PathEnum baseline and cost-routed AUTO, on one device or fanned out
over engine replicas.

Counterpart of ``repro/core/engine.py``. The host planner (clustering +
detection) emits per-cluster DirectionPlans; this module materializes HC-s
path queries level by level (expand supersteps + splice joins), caches
them across batches when a ``SharedPathCache`` is configured (the paper's
R), and assembles per-query HC-s-t results with the exact-split ⊕ join.
Every buffer has a capacity planned from walk counts (``plan_caps``, the
default) with overflow-retry (x4, up to ``hard_cap``).

The engine runs on one device (``"cuda"`` unless the caller passes
``device="cpu"``), and each kernel takes the arm of that device: the CUDA
kernels on the card, their plain versions on the CPU. With a mesh
(``EngineConfig.mesh``, a device list, or ``n_devices``) its executor
(:class:`~repro_torch.core.distributed.ShardedExecutor`) places the
batch's clusters on engine replicas, each on its own CUDA stream.

Incremental edge deltas (:meth:`BatchPathEngine.apply_delta`) patch the
device tables and invalidate the cache hop-scoped, pricing the damage on
the host (``delta_backend="host"``) or with the set-seeded MS-BFS on the
``msbfs_step`` kernel (any other value, as in the reference).

Every stage is a span of the process-wide tracer (``self.obs``, under the
reference's span names); the spans behind the ``t_*`` stats (``stage``)
end in a device synchronize, so each stat measures completed work. The
finer spans (a node, a level, a join, a cache access) add no
synchronize: each level and join already reads its count back, and a
level's span fences its frontier when the tracer runs with
``fence=True``. ``EngineConfig.trace`` turns recording on, and
``trace_annotations`` also enters a ``torch.profiler.record_function`` of
the span's name for each span's lifetime, so a profiler window
(``repro_torch.obs.torchprof``) shows every stage on its timeline and
can charge each device kernel to the stage that launched it.
``EngineConfig.log_compiles`` writes each run's and each delta's compile
window (``n_compiles``, ``n_retraces``, ``compiled_kernels``;
``repro_torch.core.compilelog``) into its report.

Not in this port yet, and refused with ``NotImplementedError`` instead of
silently degrading: the knob of the segment arm (``edge_chunk``) when
set away from its default.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from . import compilelog
from .cache import SharedPathCache
from .clustering import cluster_queries
from .delta import (AppliedDelta, GraphDelta, apply_delta as _merge_delta,
                    host_set_dist, pow2_ceil as _pow2, update_device_graph)
from .detect import DirectionPlan, PlanNode, detect_common_queries
from .distributed import ShardedExecutor, resolve_mesh
from .enumerate import (count_ending_at, expand_level, extract_rows,
                        prune_table, select_ending_at)
from .graph import DeviceGraph, Graph
from .index import QueryIndex, build_index, slack_from_dists, walk_counts_ell
from .msbfs import K_MAX_INT8, msbfs_set_dist_ell
from .join import cross_join, keyed_join, keyed_join_count, sort_by_last
from .pathset import PathSet, concat, empty, read_status, singleton
from .planner import CostRouter, Route, RouterConfig
from .query import (BatchReport, Output, PathQuery, PathsStore, Planner,
                    QueryLike, QueryResult, midpoint_split)
from .similarity import similarity_matrix
from ..kernels.registry import resolve_arm, resolve_device
from ..obs import metrics as obsmetrics
from ..obs import trace as obstrace

__all__ = ["EngineConfig", "BatchPathEngine", "EngineOverflow",
           "BatchResult", "resolve_device"]

Query = tuple[int, int, int]

# backward levels are produced lazily: basic planners skip the whole
# backward enumeration when a forward level already answers exists-only
Levels = Callable[[], list]


class EngineOverflow(RuntimeError):
    """A query exceeded hard capacity limits (the paper's OT analogue)."""


@dataclasses.dataclass
class EngineConfig:
    """The reference's field names and defaults; fields of parts that are
    not ported yet are refused at engine construction when set."""

    gamma: float = 0.5              # clustering threshold (paper default)
    kernel_backend: Optional[str] = None  # "torch" | "cuda"; None follows
    # the engine's device. A choice that contradicts the device raises.
    min_cap: int = 256
    max_cap: int = 1 << 20          # planned per-level frontier cap clamp
    hard_cap: int = 1 << 22         # absolute limit before EngineOverflow
    join_cap: int = 1 << 21
    min_shared_budget: int = 2      # don't materialize trivially small shares
    plus: bool = False              # cost-based fwd/bwd split (the "+" variants)
    edge_chunk: int = 1 << 22       # segment-arm knob (not ported)
    plan_caps: bool = True          # DP-based capacity planning
    paper_faithful_shares: bool = False  # min_shared_budget -> 0
    cache_bytes: int = 0            # >0: cross-batch SharedPathCache budget
    delta_max_sources: int = 1024   # wider touched sets: full invalidation
    delta_backend: str = "host"     # "host" CSR walk, else the MS-BFS sweep
    log_compiles: bool = False      # compile telemetry: per-library compile
    # and retrace counts in each run/apply_delta report (core/compilelog)
    mesh: Optional[Sequence] = None  # devices of the cluster replicas
    # (entry 0 the engine's own, repeats allowed); None + n_devices -> the
    # first N local devices of the engine's type (1 = identity mesh)
    n_devices: Optional[int] = None
    balance_clusters: bool = False  # sharded runs stop cluster merging at
    # n_replicas clusters so no replica idles on an over-merged batch
    trace: bool = False             # record stage spans into the process
    # tracer (Chrome-trace exportable); off = spans still time every stage
    trace_fence: bool = False       # synchronize fenced tensors' devices
    trace_annotations: bool = False  # wrap spans in torch.profiler
    # record_function (obs/torchprof), so profiles show the stages
    router: Optional[RouterConfig] = None  # Planner.AUTO routing thresholds
    # and output-kind weights (None = planner.RouterConfig defaults)


@dataclasses.dataclass
class BatchResult:
    """Legacy aggregate (eager host matrices); produced only by the
    deprecated :meth:`BatchPathEngine.process` shim. New code gets a
    :class:`~repro_torch.core.query.BatchReport` from
    :meth:`BatchPathEngine.run`.
    """

    paths: dict[int, np.ndarray]    # query idx -> (n_paths, k+1) int32 (pad -1)
    stats: dict


def _check_config(cfg: EngineConfig) -> None:
    """Refuse every option whose code is not ported yet."""
    if cfg.edge_chunk != 1 << 22:
        raise NotImplementedError(
            "EngineConfig edge_chunk (the segment arm) is not ported yet; "
            "it comes with ROADMAP.md queue 1, 'the mesh-parallel index'")


def _bucket(x: int, min_cap: int = 256) -> int:
    """Quantize capacities to powers of four (fewer shape buckets)."""
    b = min_cap
    while b < x:
        b *= 4
    return b


class BatchPathEngine:
    def __init__(self, graph: Graph, config: Optional[EngineConfig] = None,
                 cache: Optional[SharedPathCache] = None, *,
                 device: Union[torch.device, str, None] = None):
        self.device = resolve_device(device)
        self.g = graph
        self.cfg = config or EngineConfig()
        _check_config(self.cfg)
        # the arm follows the device; an explicit contradicting arm raises
        self.kernel_arm = resolve_arm(self.device, self.cfg.kernel_backend)
        self.dg = DeviceGraph.build(graph, self.device)
        self._host_dists: Optional[tuple] = None   # (index, (dist_s, dist_t))
        # plan -> place -> gather layer; identity on a single device (the
        # executor IS the cluster-execution loop for every engine)
        self.executor: Optional[ShardedExecutor] = ShardedExecutor(
            self, resolve_mesh(self.cfg.mesh, self.cfg.n_devices,
                               self.device))
        if cache is None and self.cfg.cache_bytes > 0:
            cache = SharedPathCache(self.cfg.cache_bytes)
        self.cache = cache
        # Planner.AUTO tier routing + per-cluster planner choice
        self.router = CostRouter(self.cfg.router)
        # process-wide recorder (the library cache is process-global);
        # None when telemetry is off -- every run()/apply_delta() report
        # then carries n_compiles / n_retraces / compiled_kernels
        self.compile_log = compilelog.enable() if self.cfg.log_compiles \
            else None
        # stage spans: the recorder is process-wide -- any engine with
        # cfg.trace turns recording on; the handle is always present
        # because every t_* stat is a span's duration (recorded or not)
        self.obs = obstrace.enable(
            fence=self.cfg.trace_fence,
            annotate=self.cfg.trace_annotations) if self.cfg.trace \
            else obstrace.tracer()

    @contextlib.contextmanager
    def stage(self, name: str, **attrs):
        """One stage: a span of the engine's tracer that ends in a fence
        (:meth:`_fence`), so asynchronous kernels are charged to the stage
        that launched them."""
        with self.obs.span(name, **attrs) as sp:
            try:
                yield sp
            finally:
                self._fence()

    def _fence(self) -> None:
        """Wait for this engine's launched work: the whole device, except
        inside a cluster fan-out, where a replica waits for its own stream
        only (a device-wide synchronize would charge every replica's
        stage with the others' work)."""
        if self.device.type != "cuda":
            return
        if self.executor is None or self.executor.in_fanout:
            torch.cuda.current_stream(self.device).synchronize()
        else:
            torch.cuda.synchronize(self.device)

    def set_graph(self, graph: Graph) -> None:
        """Swap the graph wholesale: rebuild the device views and drop
        every piece of graph-derived state (the host-dist memo, the
        cross-batch cache). For incremental edge churn prefer
        :meth:`apply_delta`, which keeps the warm state whose hop-locality
        a small delta cannot reach."""
        self.g = graph
        self.dg = DeviceGraph.build(graph, self.device)
        self._host_dists = None
        # replica caches invalidate BEFORE the replicas are dropped so a
        # swap bumps every epoch in lockstep with the primary
        for cache in self._all_caches():
            cache.invalidate()
        self.executor.reset()

    def apply_delta(self, delta: GraphDelta) -> dict:
        """Apply an incremental edge delta; returns an application report.

        The successor graph comes from a CSR merge (``Graph.apply_delta``
        semantics: ``new = (old - remove) | add``), the device tables are
        patched rather than rebuilt (only touched ELL rows change), and
        the cross-batch cache is invalidated *hop-scoped*: a set-seeded
        BFS from the delta's touched vertices prices each entry's distance
        to the damage, and only entries whose enumeration ball or consumer
        prune radius the damage can reach are evicted
        (``SharedPathCache.invalidate_delta``). A no-op delta (every edge
        already present/absent) leaves all state -- including the host
        distance memo -- untouched; an effective delta drops only that
        memo, which the next batch's index rebuilds anyway.

        ``t_apply_s`` ends in a device synchronize, so it measures
        completed work. With ``EngineConfig.log_compiles`` the report
        carries the window's ``n_compiles`` / ``n_retraces`` (0 once the
        delta path's libraries are loaded: no delta selects another).
        """
        if self.compile_log is None:
            return self._apply_delta_impl(delta)
        snap = self.compile_log.snapshot()
        report = self._apply_delta_impl(delta)
        self.compile_log.annotate(report, snap)
        return report

    def _apply_delta_impl(self, delta: GraphDelta) -> dict:
        with self.stage("engine.apply_delta") as sp:
            applied = _merge_delta(self.g, delta)
            sp.set(n_added=int(applied.added_src.size),
                   n_removed=int(applied.removed_src.size))
            report = {
                "n_added": int(applied.added_src.size),
                "n_removed": int(applied.removed_src.size),
                "n_touched": int(applied.touched.size),
                "cache_mode": "none", "device_update": "none",
            }
            if applied.n_changed:
                if self.cache is not None:
                    with self.obs.span("cache.invalidate"):
                        report.update(self._invalidate_for(applied))
                self.dg, incremental = update_device_graph(self.dg, applied)
                report["device_update"] = ("incremental" if incremental
                                           else "rebuild")
                self.g = applied.graph
                self._host_dists = None
                # replica tables patch in lockstep; their caches were
                # already invalidated above with the same distance sweep
                self.executor.propagate_delta(applied)
        report["t_apply_s"] = sp.duration
        return report

    def _all_caches(self) -> list[SharedPathCache]:
        """Primary cache + every materialized replica's cache. All of
        them receive each invalidation event (same dists, same order), so
        their epochs advance in lockstep; replicas created later sync the
        epoch at birth (see ``distributed.ShardedExecutor._clone``)."""
        caches = [] if self.cache is None else [self.cache]
        if self.executor is not None:
            caches += self.executor.replica_caches()
        return caches

    def _invalidate_for(self, applied: AppliedDelta) -> dict:
        """Cache invalidation for one merged delta (the cache must
        exist)."""
        caches = self._all_caches()
        if all(len(c) == 0 for c in caches):
            empty = {"to": np.empty(0, np.int8),
                     "from": np.empty(0, np.int8)}
            info = {}
            for c in caches:
                info = c.invalidate_delta(applied.touched, empty)
            return {"cache_mode": "delta", "cache_evicted": 0,
                    "cache_kept": 0, "cache_epoch": info["epoch"],
                    "cache_epochs": [c.epoch for c in caches]}
        if applied.touched.size > self.cfg.delta_max_sources:
            dropped = sum(len(c) for c in caches)
            for c in caches:
                c.invalidate()   # frontier too wide: hop-scoping won't pay
            return {"cache_mode": "full", "cache_evicted": dropped,
                    "cache_kept": 0, "cache_epoch": self.cache.epoch,
                    "cache_epochs": [c.epoch for c in caches]}
        # one distance sweep prices the damage: the radius must cover the
        # widest live entry
        k_max = max(max(c.max_radius() for c in caches), 1)
        dists = self._delta_dists(applied, k_max)
        info = {}
        for c in caches:
            got = c.invalidate_delta(applied.touched, dists)
            if c is self.cache:
                info = got
        return {"cache_mode": "delta", "cache_evicted": info["evicted"],
                "cache_kept": info["kept"], "cache_epoch": info["epoch"],
                "cache_epochs": [c.epoch for c in caches]}

    def _delta_dists(self, applied: AppliedDelta, k_max: int) -> dict:
        """Min hop distances to/from the touched frontier.

        Both endpoints of every changed edge are seeds, so these distances
        agree on the old, new, and union graphs (see ``host_set_dist``):
        the sweep runs on the *old* graph, which for the MS-BFS backend
        means the still-resident old ELL tables (``self.dg`` is patched
        only after invalidation). Backend ``"host"`` (the default) walks
        only the touched balls' edges over the CSR; any other value runs
        ``msbfs_set_dist_ell`` on the device, in both directions: "from"
        relaxes over G's in-neighbours (``r_ell_idx``), "to" over G_r's
        (``ell_idx``). (The reference's jnp engine takes its segment sweep
        here, which it documents as bit-equal.)
        """
        if self.cfg.delta_backend == "host":
            return {"from": host_set_dist(self.g, applied, k_max,
                                          reverse=False),
                    "to": host_set_dist(self.g, applied, k_max,
                                        reverse=True)}
        # distances beyond every live radius are never compared, so the
        # reference's pow2-bucketed (larger) k_max is slack that keeps the
        # distance arrays equal to its own. A radius beyond the int8
        # sweep's ceiling would silently lose distances, so it raises.
        if k_max > K_MAX_INT8:
            raise ValueError(
                f"live cache radius k_max={k_max} exceeds the int8 MS-BFS "
                f"ceiling K_MAX_INT8={K_MAX_INT8}; shrink the hop budgets "
                f"or drop delta_backend='msbfs'")
        k_max = min(_pow2(k_max), K_MAX_INT8)
        seed = torch.zeros(self.g.n + 1, dtype=torch.int8)
        seed[torch.from_numpy(applied.touched)] = 1
        seed = seed.to(self.device)
        return {name: msbfs_set_dist_ell(ell, seed, n=self.g.n,
                                         k_max=k_max).cpu().numpy()
                for name, ell in (("from", self.dg.r_ell_idx),
                                  ("to", self.dg.ell_idx))}

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def run(self, queries: Sequence[QueryLike],
            planner: Planner | str = Planner.BATCH,
            clusters: Optional[list[list[int]]] = None) -> BatchReport:
        """Execute a batch of :class:`PathQuery` (tuples are coerced).

        planner : execution strategy (:class:`Planner` or its string value).
        clusters : optional precomputed partition of query indices (batch
        planners and AUTO only).

        With ``EngineConfig.log_compiles`` the report stats carry this
        run's compile-telemetry window: ``n_compiles`` (kernel libraries
        made ready), ``n_retraces`` (libraries that were already ready --
        zero on a warm path) and ``compiled_kernels``.
        """
        if self.compile_log is None:
            return self._run_impl(queries, planner, clusters)
        snap = self.compile_log.snapshot()
        report = self._run_impl(queries, planner, clusters)
        self.compile_log.annotate(report.stats, snap)
        return report

    def _run_impl(self, queries: Sequence[QueryLike],
                  planner: Planner | str,
                  clusters: Optional[list[list[int]]]) -> BatchReport:
        qs = tuple(PathQuery.coerce(q).check_bounds(self.g.n)
                   for q in queries)
        planner = Planner.coerce(planner)
        plus = planner.plus or self.cfg.plus
        stats: dict = {"planner": planner.value, "mode": planner.value,
                       "kernel_backend": self.kernel_arm.value,
                       "n_queries": len(qs), "n_rows_assembled": 0}
        if not qs:   # degenerate but legal (e.g. a filter left nothing)
            stats["t_build_index"] = stats["t_enumerate"] = 0.0
            return BatchReport(queries=qs, results=(), stats=stats)
        with self.stage("engine.run", planner=planner.value,
                        n_queries=len(qs)) as root:
            if planner is Planner.PATHENUM:
                report = self._run_pathenum(qs, stats)
            else:
                with self.stage("index.build", n_queries=len(qs)) as sidx:
                    index = build_index(self.dg, [q.key for q in qs])
                stats["t_build_index"] = sidx.duration
                if planner is Planner.AUTO:
                    report = self._run_auto(qs, index, plus, stats,
                                            clusters)
                elif planner.batched:
                    report = self._run_batch(qs, index, plus, stats,
                                             clusters)
                else:
                    report = self._run_basic(qs, index, plus, stats)
        stats["t_wall_s"] = root.duration
        reg = obsmetrics.registry()
        arm = self.kernel_arm.value
        reg.histogram("engine_batch_wall_s", planner=planner.value,
                      backend=arm).record(root.duration)
        lat = reg.histogram("query_latency_s", planner=planner.value,
                            backend=arm)
        for r in report.results:
            if r.time_s is not None:
                lat.record(r.time_s)
        return report

    def process(self, queries: Sequence[Query], mode: str = "batch",
                clusters: Optional[list[list[int]]] = None) -> BatchResult:
        """Deprecated tuple-in / dict-out API; thin shim over :meth:`run`."""
        warnings.warn(
            "BatchPathEngine.process(queries, mode=...) is deprecated; use "
            "run(queries, planner=...) or the PathSession facade",
            DeprecationWarning, stacklevel=2)
        report = self.run(queries, planner=mode, clusters=clusters)
        return BatchResult(paths=report.paths, stats=report.stats)

    # ------------------------------------------------------------------
    # BasicEnum (Alg 1): shared index, per-query bidirectional enumeration
    # ------------------------------------------------------------------
    def _direct_query(self, q: PathQuery, qi: int, index: QueryIndex,
                      plus: bool, stats: dict) -> QueryResult:
        """One query through the Alg-1 direct plan: bidirectional
        enumeration off the shared index, backward half lazy. Shared by
        the basic planners, AUTO's GREEN tier and basic-routed clusters."""
        a, b = self._split(qi, index, plus)
        fs = self._dedicated_slack(index, qi, forward=True)
        fl = self._run_node(False, q.s, a, fs, [], stop_vertex=q.t)

        def bwd(qi=qi, q=q, b=b):
            bs = self._dedicated_slack(index, qi, forward=False)
            return self._run_node(True, q.t, b, bs, [], stop_vertex=q.s)

        return self._wrap(q, self._payload(q, fl, a, bwd, b, stats))

    def _run_basic(self, queries, index: QueryIndex, plus: bool,
                   stats) -> BatchReport:
        with self.stage("enumerate.batch", n_queries=len(queries)) as senum:
            results = []
            for qi, q in enumerate(queries):
                with self.stage("assemble.query", qi=qi) as sq:
                    r = self._direct_query(q, qi, index, plus, stats)
                r.time_s = sq.duration
                results.append(r)
        stats["t_enumerate"] = senum.duration
        return BatchReport(queries=tuple(queries), results=tuple(results),
                           stats=stats)

    def _cluster_basic(self, queries, index: QueryIndex, plus: bool,
                       min_sb: int, cluster: list[int]):
        """Direct per-query plan for one routed cluster (AUTO's
        ``"basic"`` per-cluster choice, see ``CostRouter.cluster_planner``).
        Same ``({qi: QueryResult}, cstats)`` contract as
        :meth:`_cluster_work`, but no Ψ detection, no sharing, no cache:
        a cluster with nothing to share skips that machinery's overhead.
        """
        del min_sb   # no shares to budget on the direct plan
        cstats = {"n_psi_nodes": 0, "n_materialized": 0,
                  "n_cache_hits": 0, "n_cache_misses": 0,
                  "n_rows_assembled": 0, "n_shared": 0, "n_dedup": 0,
                  "n_share_edges": 0, "t_detect": 0.0}
        with self.stage("enumerate.cluster", size=len(cluster),
                        direct=True) as se:
            results: dict[int, QueryResult] = {}
            for qi in cluster:
                q = queries[qi]
                with self.stage("assemble.query", qi=qi) as sq:
                    results[qi] = self._direct_query(q, qi, index, plus,
                                                     cstats)
                results[qi].time_s = sq.duration
        cstats["t_enumerate"] = se.duration
        return results, cstats

    def _run_pathenum(self, queries, stats) -> BatchReport:
        """Per-query index construction + enumeration (the PathEnum
        baseline)."""
        results = []
        t_idx = t_enum = 0.0
        for q in queries:
            with self.stage("index.build", pathenum=True) as sidx:
                index = build_index(self.dg, [q.key])
            t_idx += sidx.duration
            with self.stage("assemble.query") as sq:
                a, b = self._split(0, index, False)
                fs = self._dedicated_slack(index, 0, forward=True)
                fl = self._run_node(False, q.s, a, fs, [], stop_vertex=q.t)

                def bwd(q=q, b=b, index=index):
                    bs = self._dedicated_slack(index, 0, forward=False)
                    return self._run_node(True, q.t, b, bs, [],
                                          stop_vertex=q.s)

                r = self._wrap(q, self._payload(q, fl, a, bwd, b, stats))
            t_enum += sq.duration
            r.time_s = sidx.duration + sq.duration
            results.append(r)
        stats["t_build_index"] = t_idx
        stats["t_enumerate"] = t_enum
        return BatchReport(queries=tuple(queries), results=tuple(results),
                           stats=stats)

    # ------------------------------------------------------------------
    # BatchEnum (Alg 4): cluster -> detect -> shared enumeration
    # ------------------------------------------------------------------
    def _run_batch(self, queries, index: QueryIndex, plus: bool, stats,
                   clusters: Optional[list[list[int]]] = None) -> BatchReport:
        results = self._run_clustered(queries, index, plus, stats, clusters)
        return BatchReport(queries=tuple(queries),
                           results=tuple(results[qi]
                                         for qi in range(len(queries))),
                           stats=stats)

    def _run_clustered(self, queries, index: QueryIndex, plus: bool, stats,
                       clusters: Optional[list[list[int]]] = None, *,
                       subset: Optional[list[int]] = None,
                       ests: Optional[dict] = None,
                       routes: Optional[dict] = None) -> dict:
        """Cluster → (route) → execute; returns ``{qi: QueryResult}``.

        The shared body of the batch planners and the AUTO YELLOW/RED
        tier. ``subset`` restricts clustering to those query indices
        (AUTO runs it on the non-GREEN remainder; similarity rows are
        sliced, cluster members stay *global* indices). With ``ests``
        (qi → :class:`~repro_torch.core.planner.CostEstimate`) the router
        picks each cluster's planner (basic vs. batch) and tier -- RED
        only on a mesh; ``routes`` entries are upgraded in place for RED
        members.
        """
        qis = list(range(len(queries))) if subset is None else list(subset)
        with self.stage("cluster.queries",
                        precomputed=clusters is not None) as sc:
            if clusters is None:
                mu = similarity_matrix(index)
                if subset is None:
                    stats["mu_mean"] = float(
                        (mu.sum() - len(queries)) /
                        max(len(queries) * (len(queries) - 1), 1))
                else:
                    mu = mu[np.ix_(qis, qis)]
                min_clusters = 1
                if self.cfg.balance_clusters:
                    min_clusters = self.executor.n_replicas
                local = cluster_queries(mu, self.cfg.gamma,
                                        min_clusters=min_clusters)
                clusters = [[qis[i] for i in cl] for cl in local]
            else:
                seen = [qi for cl in clusters for qi in cl]
                if sorted(seen) != sorted(qis):
                    raise ValueError(
                        "clusters must partition the query indices")
            sc.set(n_clusters=len(clusters))
        stats["t_cluster"] = sc.duration
        stats["n_clusters"] = len(clusters)

        min_sb = 0 if self.cfg.paper_faithful_shares else self.cfg.min_shared_budget
        for key in ("n_psi_nodes", "n_materialized",
                    "n_cache_hits", "n_cache_misses",
                    "t_detect", "t_enumerate",
                    "n_shared", "n_dedup", "n_share_edges"):
            stats.setdefault(key, 0)

        planners = None
        if ests is not None:
            planners = [self.router.cluster_planner(cl, ests,
                                                    self.cache is not None)
                        for cl in clusters]
            stats["cluster_planners"] = list(planners)
            croutes = [self.router.cluster_route(cl, ests,
                                                 self.executor.sharded)
                       for cl in clusters]
            stats["cluster_routes"] = [r.value for r in croutes]
            if routes is not None:
                for cl, r in zip(clusters, croutes):
                    if r is Route.RED:
                        for qi in cl:
                            routes[qi] = Route.RED
        # plan -> place -> gather: the executor runs every cluster --
        # inline on one device, fanned across the replicas on a mesh
        return self.executor.run_clusters(queries, index, plus, min_sb,
                                          clusters, stats, planners=planners)

    # ------------------------------------------------------------------
    # AUTO: cost-routed GREEN/YELLOW/RED tiers (core.planner)
    # ------------------------------------------------------------------
    def _run_auto(self, queries, index: QueryIndex, plus: bool, stats,
                  clusters: Optional[list[list[int]]] = None) -> BatchReport:
        """Route each query by its index-derived cost estimate: GREEN
        queries take the direct sweep (no clustering/detection/cache);
        the remainder runs through :meth:`_run_clustered`, which also
        picks each cluster's planner and tier. Exactness is
        planner-independent, so routing can only move wall time."""
        with self.stage("route.estimate", n_queries=len(queries)) as sr:
            dists = self._dists_host(index)
            ests = self.router.estimate(index, queries, dists)
            routes = {e.qi: e.route for e in ests}
            green = [e.qi for e in ests if e.route is Route.GREEN]
            rest = [e.qi for e in ests if e.route is not Route.GREEN]
            sr.set(n_green=len(green))
        stats["t_route"] = sr.duration

        # AUTO answers may skip whole stages; pre-zero the batch counters
        # so report consumers see one stable schema across routes
        for key in ("n_psi_nodes", "n_materialized",
                    "n_cache_hits", "n_cache_misses",
                    "t_detect", "t_enumerate", "t_cluster",
                    "n_shared", "n_dedup", "n_share_edges"):
            stats[key] = 0
        stats["n_clusters"] = 0

        results: dict[int, QueryResult] = {}
        if green:
            results.update(self._run_green(queries, index, plus, green,
                                           stats))
        if rest:
            if clusters is not None:
                # the caller's grouping covered every query; keep only the
                # non-GREEN members (GREEN ones were just answered)
                keep = set(rest)
                clusters = [[qi for qi in cl if qi in keep]
                            for cl in clusters]
                clusters = [cl for cl in clusters if cl]
            results.update(self._run_clustered(
                queries, index, plus, stats, clusters,
                subset=rest, ests={e.qi: e for e in ests}, routes=routes))

        reg = obsmetrics.registry()
        for route in Route:
            n = sum(1 for r in routes.values() if r is route)
            stats[f"routed_{route.value}"] = n
            if n:
                reg.counter(f"routed_{route.value}").inc(n)
        return BatchReport(
            queries=tuple(queries),
            results=tuple(results[qi] for qi in range(len(queries))),
            stats=stats,
            routes=tuple(routes[qi].value for qi in range(len(queries))))

    def _run_green(self, queries, index: QueryIndex, plus: bool,
                   green: list[int], stats) -> dict:
        """The GREEN tier: answer routed queries straight off the shared
        index. exists-only and index-unreachable queries are decided by
        the MS-BFS distances alone (``dist_G(s,t) <= k`` iff a ≤k-hop
        simple path exists -- shortest walks are simple); the rest run the
        direct per-query plan with no detection/clustering/cache."""
        ds, _ = self._dists_host(index)
        results: dict[int, QueryResult] = {}
        with self.stage("route.green", n_queries=len(green)) as sg:
            for qi in green:
                q = queries[qi]
                with self.stage("assemble.query", qi=qi,
                                route="green") as sq:
                    if int(ds[q.t, index.src_col[qi]]) > q.k:
                        r = self._empty_result(q)
                    elif q.output is Output.EXISTS:
                        r = QueryResult(q, _exists=True)
                    else:
                        r = self._direct_query(q, qi, index, plus, stats)
                r.time_s = sq.duration
                results[qi] = r
        stats["t_green"] = sg.duration
        return results

    def _empty_result(self, q: PathQuery) -> QueryResult:
        """The (exact) empty answer, shaped like the enumerators': an
        empty ``(0, k+1)`` path matrix / zero count / False."""
        if q.output is Output.PATHS:
            return QueryResult(q, _store=PathsStore(
                empty(1, q.k + 1, self.device)))
        if q.output is Output.EXISTS:
            return QueryResult(q, _exists=False)
        return QueryResult(q, _count=0, _exists=False)

    def _cluster_work(self, queries, index: QueryIndex, plus: bool,
                      min_sb: int, cluster: list[int]):
        """One sharing cluster end-to-end: detect → plan execution →
        per-query ⊕ assembly. Returns ``({qi: QueryResult}, cstats)``."""
        cstats = {"n_psi_nodes": 0, "n_materialized": 0,
                  "n_cache_hits": 0, "n_cache_misses": 0,
                  "n_rows_assembled": 0}
        with self.stage("detect.cluster", size=len(cluster)) as sd:
            halves_f = {}
            halves_b = {}
            ends_f = {}
            ends_b = {}
            for qi in cluster:
                s, t, k = queries[qi]
                a, b = self._split(qi, index, plus)
                halves_f[qi] = (s, a)
                halves_b[qi] = (t, b)
                ends_f[qi] = (t, k)
                ends_b[qi] = (s, k)
            hop_f = self._hop_ok(index, cluster, forward=True)
            hop_b = self._hop_ok(index, cluster, forward=False)
            plan_f = detect_common_queries(self.g, cluster, halves_f, hop_f,
                                           reverse=False,
                                           min_shared_budget=min_sb,
                                           endpoints=ends_f)
            plan_b = detect_common_queries(self.g, cluster, halves_b, hop_b,
                                           reverse=True,
                                           min_shared_budget=min_sb,
                                           endpoints=ends_b)
            cstats["n_shared"] = plan_f.n_shared + plan_b.n_shared
            # deduped half-queries: halves mapped onto an existing node,
            # counted per direction (identical queries collapse entirely)
            cstats["n_dedup"] = (
                len(cluster) - len(set(plan_f.half_of_query.values()))
                + len(cluster) - len(set(plan_b.half_of_query.values())))
            cstats["n_share_edges"] = (
                sum(len(n.in_edges) for n in plan_f.nodes)
                + sum(len(n.in_edges) for n in plan_b.nodes))
        cstats["t_detect"] = sd.duration

        with self.stage("enumerate.cluster", size=len(cluster)) as se:
            cache_f = self._run_plan(plan_f, index, forward=True,
                                     stats=cstats)
            cache_b = self._run_plan(plan_b, index, forward=False,
                                     stats=cstats)
            # identical (halves, k, output, limit) -> identical payloads
            assembled: dict = {}
            results: dict[int, QueryResult] = {}
            for qi in cluster:
                q = queries[qi]
                with self.stage("assemble.query", qi=qi) as sq:
                    a = halves_f[qi][1]
                    b = halves_b[qi][1]
                    fid = plan_f.half_of_query[qi]
                    bid = plan_b.half_of_query[qi]
                    key = (fid, bid, a, b, q.k, q.t, q.output, q.limit)
                    if key not in assembled:
                        fl = cache_f[fid]
                        assembled[key] = self._payload(
                            q, fl, a, lambda bid=bid: cache_b[bid], b,
                            cstats)
                    results[qi] = self._wrap(q, assembled[key])
                results[qi].time_s = sq.duration
        cstats["t_enumerate"] = se.duration
        return results, cstats

    # ------------------------------------------------------------------
    # plan execution: materialize needed Ψ nodes in topological order,
    # consulting the cross-batch SharedPathCache first
    # ------------------------------------------------------------------
    @staticmethod
    def _plan_children(plan: DirectionPlan, node: PlanNode) -> list[int]:
        """Splice children after dedupe (same root vertex: keep max budget)."""
        seen_src: dict[int, int] = {}
        for cid in node.in_edges:
            c = plan.nodes[cid]
            if c.src in seen_src and plan.nodes[seen_src[c.src]].budget >= c.budget:
                continue
            seen_src[c.src] = cid
        return list(seen_src.values())

    def _node_stop(self, plan: DirectionPlan, node: PlanNode,
                   index: QueryIndex, forward: bool) -> int:
        # dedicated-node optimization: a half used by exactly one query
        # and spliced by nobody may stop at its own endpoint (Alg 1)
        if (node.query is not None and len(node.consumers) == 1
                and not node.out_edges):
            qi = node.consumers[0][0]
            s_, t_, _ = index.queries[qi]
            return t_ if forward else s_
        return -2

    def _run_plan(self, plan: DirectionPlan, index: QueryIndex, forward: bool,
                  stats: Optional[dict] = None):
        cache: dict[int, list[PathSet]] = {}
        children_of = {n.nid: self._plan_children(plan, n) for n in plan.nodes}
        stops = {n.nid: self._node_stop(plan, n, index, forward)
                 for n in plan.nodes}
        keys: dict[int, tuple] = {}
        if self.cache is not None:
            keys = {n.nid: n.signature + (stops[n.nid],)
                    for n in plan.nodes if n.signature is not None}
        # a node must be present iff it is a query half or spliced by a
        # materialized (cache-miss) node; children of hits are never touched.
        # Cache fetches all happen here -- before any put -- so entries
        # taken as device copies stay valid for this plan even if evicted
        # later.
        need: set[int] = set()
        mat: list[int] = []
        stack = sorted(set(plan.half_of_query.values()))
        while stack:
            nid = stack.pop()
            if nid in need:
                continue
            need.add(nid)
            if nid in keys:
                with self.obs.span("cache.get") as sg:
                    got = self.cache.get(keys[nid], self.device)
                    sg.set(hit=got is not None)
            else:
                got = None
            if got is not None:
                cache[nid] = got
            else:
                mat.append(nid)
                stack.extend(children_of[nid])
        for nid in plan.topo:
            if nid not in need or nid in cache:
                continue
            node = plan.nodes[nid]
            slack = self._node_slack(index, node.consumers, forward)
            children = [(plan.nodes[cid].src, plan.nodes[cid].budget, cache[cid])
                        for cid in children_of[nid]]
            cache[nid] = self._run_node(not forward, node.src, node.budget,
                                        slack, children, stop_vertex=stops[nid])
            if self.cache is not None and nid in keys:
                with self.obs.span("cache.put"):
                    self.cache.put(keys[nid], cache[nid])
        if stats is not None:
            stats["n_psi_nodes"] += len(plan.nodes)
            stats["n_materialized"] += len(mat)
            if self.cache is not None:
                stats["n_cache_hits"] += len(need) - len(mat)
                stats["n_cache_misses"] += len(mat)
        return cache

    # ------------------------------------------------------------------
    # node enumeration with overflow retry
    # ------------------------------------------------------------------
    def _run_node(self, reverse: bool, source: int, budget: int, slack,
                  children, stop_vertex: int = -2):
        with self.obs.span("enumerate.node", src=source, budget=budget,
                           reverse=reverse):
            caps = self._plan_caps(reverse, source, budget, slack)
            for _ in range(8):
                out = self._run_node_once(reverse, source, budget, slack,
                                          children, stop_vertex, caps)
                if out is not None:
                    return out
                caps = [min(c * 4, self.cfg.hard_cap) for c in caps]
                if all(c >= self.cfg.hard_cap for c in caps[1:]):
                    raise EngineOverflow(
                        f"node (src={source}, budget={budget}) exceeds "
                        f"hard_cap")
            raise EngineOverflow("retry limit reached")

    def _run_node_once(self, reverse, source, budget, slack, children,
                       stop_vertex, caps):
        ell_idx = self.dg.direction(reverse)
        width = budget + 1
        n = self.dg.n
        splice_np = np.full(n + 1, -1, np.int8)
        for (csrc, cb, _) in children:
            splice_np[csrc] = cb
        # slack + splice stacked once per node; every expand level then
        # pays a single prune gather (see enumerate.prune_table)
        prune_tbl = prune_table(slack,
                                torch.from_numpy(splice_np).to(self.device))

        pools: list[list[PathSet]] = [[] for _ in range(budget + 1)]
        frontier = singleton(source, width, self.device)
        pools[0].append(frontier)
        n_frontier = 1
        for lvl in range(budget):
            if n_frontier == 0:
                break
            with self.obs.span("msbfs.level", level=lvl,
                               reverse=reverse) as sl:
                out = expand_level(frontier.verts, frontier.count, ell_idx,
                                   prune_tbl, stop_vertex,
                                   level=lvl, budget=budget,
                                   out_cap=caps[lvl + 1])
                sl.fence(out.frontier.verts)
                # the level's one host sync: the new frontier's count and
                # overflow in one device-to-host copy
                n_frontier, overflow = read_status(out.frontier.count,
                                                   out.frontier.overflow)
            if overflow:
                return None
            for (csrc, cb, clevels) in children:
                with self.obs.span("join.splice", level=lvl):
                    rmask = (out.splice_hit & (out.nbrs == csrc)).any(dim=1)
                    prefixes = extract_rows(frontier.verts, rmask,
                                            out_cap=frontier.cap)
                    if int(prefixes.count) == 0:
                        continue
                    for lam in range(0, min(cb, budget - lvl - 1) + 1):
                        cl = clevels[lam]
                        if int(cl.count) == 0:
                            continue
                        res, _ = self._retry_join(
                            lambda cap: cross_join(
                                prefixes.verts, prefixes.count,
                                cl.verts, cl.count,
                                p_col=lvl, c_col=lam, out_cap=cap,
                                out_width=width),
                            est=int(prefixes.count) * int(cl.count))
                        pools[lvl + 1 + lam].append(res)
            frontier = out.frontier
            pools[lvl + 1].append(out.frontier)
        merged = [concat(p) if p else empty(1, width, self.device)
                  for p in pools]
        return [self._shrink(ps) for ps in merged]

    def _shrink(self, ps: PathSet) -> PathSet:
        """Slice a packed PathSet down to a tight capacity bucket."""
        tight = _bucket(int(ps.count), self.cfg.min_cap)
        if tight >= ps.cap:
            return ps
        return PathSet(ps.verts[:tight], ps.count, ps.overflow)

    def _retry_capacity(self, fn, est: int):
        """Run ``fn(cap) -> (result, count, overflow)`` with cap-growing
        retry; returns ``(result, int(count))``, count and overflow read
        with one device-to-host copy."""
        cap = _bucket(min(max(est, self.cfg.min_cap), self.cfg.join_cap),
                      self.cfg.min_cap)
        while True:
            res, count, overflow = fn(cap)
            n, overflow = read_status(count, overflow)
            if not overflow:
                return res, n
            if cap >= self.cfg.hard_cap:
                raise EngineOverflow("join exceeds hard_cap")
            cap = min(cap * 4, self.cfg.hard_cap)

    def _retry_join(self, fn, est: int) -> tuple[PathSet, int]:
        def attempt(cap):
            ps = fn(cap)
            return ps, ps.count, ps.overflow
        return self._retry_capacity(attempt, est)

    # ------------------------------------------------------------------
    # final ⊕ assembly (exact split, each result exactly once), dispatched
    # per query output kind: paths are materialized (lazily host-visible),
    # counts/existence use counting joins and never assemble a path row
    # ------------------------------------------------------------------
    def _payload(self, q: PathQuery, fwd_levels, a: int, bwd: Levels,
                 b: int, stats: dict):
        """The (shareable) answer payload for one query: a PathsStore for
        output=paths, an int for count/exists. ``bwd`` is a thunk --
        count/exists/limit queries answered by the forward levels alone
        never enumerate the backward half (basic planner)."""
        if q.output is Output.PATHS:
            ps = self._assemble(fwd_levels, a, bwd, b, q.t, q.k,
                                limit=q.limit)
            stats["n_rows_assembled"] += int(ps.count)
            return PathsStore(ps)
        limit = 1 if q.output is Output.EXISTS else q.limit
        return self._assemble_count(fwd_levels, a, bwd, b, q.t, q.k,
                                    limit=limit)

    @staticmethod
    def _wrap(q: PathQuery, payload) -> QueryResult:
        if q.output is Output.PATHS:
            return QueryResult(q, _store=payload)
        if q.output is Output.EXISTS:
            return QueryResult(q, _exists=payload > 0)
        return QueryResult(q, _count=payload, _exists=payload > 0)

    def _assemble(self, fwd_levels, a: int, bwd: Levels, b: int, t: int,
                  k: int, limit: Optional[int] = None):
        """``bwd`` is a thunk, only forced when the bidirectional stage is
        reached -- a limit already met by forward completions skips the
        backward enumeration entirely (basic planner)."""
        width = k + 1
        outs = []
        found = 0
        for lvl in range(1, min(a, len(fwd_levels) - 1) + 1):
            if limit is not None and found >= limit:
                break
            ps = fwd_levels[lvl]
            if int(ps.count) == 0:
                continue
            sel = select_ending_at(ps.verts, ps.count, t,
                                   col=lvl, out_cap=ps.cap)
            if int(sel.count):
                outs.append(_pad_width(sel, width))
                found += int(sel.count)
        if (not (limit is not None and found >= limit) and b >= 1
                and len(fwd_levels) > a and int(fwd_levels[a].count) > 0):
            bwd_levels = bwd()
            fa = fwd_levels[a]
            sa = sort_by_last(fa.verts, fa.count, col=a)
            for lam in range(1, min(b, len(bwd_levels) - 1) + 1):
                if limit is not None and found >= limit:
                    break
                bs = bwd_levels[lam]
                if int(bs.count) == 0:
                    continue
                with self.obs.span("join.keyed", lam=lam):
                    res, n = self._retry_join(
                        lambda cap: keyed_join(sa, bs.verts, bs.count,
                                               a_col=a, b_col=lam,
                                               out_cap=cap, out_width=width),
                        est=max(int(fa.count), int(bs.count)))
                if n:
                    outs.append(res)
                    found += n
        if not outs:
            return empty(1, width, self.device)
        out = concat(outs)
        if limit is not None:
            out = PathSet(out.verts, torch.clamp(out.count, max=limit),
                          out.overflow)
        return out

    def _assemble_count(self, fwd_levels, a: int, bwd: Levels, b: int,
                        t: int, k: int, limit: Optional[int] = None) -> int:
        """Exact ⊕ count without assembling paths: forward completions are
        mask reductions, the bidirectional part a counting join. ``limit``
        early-terminates (1 for exists-only) and clamps the total."""
        total = 0
        for lvl in range(1, min(a, len(fwd_levels) - 1) + 1):
            ps = fwd_levels[lvl]
            if int(ps.count) == 0:
                continue
            total += int(count_ending_at(ps.verts, ps.count, t, col=lvl))
            if limit is not None and total >= limit:
                return limit
        if b >= 1 and len(fwd_levels) > a and int(fwd_levels[a].count) > 0:
            bwd_levels = bwd()
            fa = fwd_levels[a]
            sa = sort_by_last(fa.verts, fa.count, col=a)
            for lam in range(1, min(b, len(bwd_levels) - 1) + 1):
                bs = bwd_levels[lam]
                if int(bs.count) == 0:
                    continue
                with self.obs.span("join.keyed", lam=lam, count=True):
                    _, n = self._retry_capacity(
                        lambda cap: (None, *keyed_join_count(
                            sa, bs.verts, bs.count, a_col=a, b_col=lam,
                            pair_cap=cap)),
                        est=max(int(fa.count), int(bs.count)))
                total += n
                if limit is not None and total >= limit:
                    return limit
        return total if limit is None else min(total, limit)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _split(self, qi: int, index: QueryIndex,
               plus: bool) -> tuple[int, int]:
        s, t, k = index.queries[qi]
        a, b = midpoint_split(k)   # shared with cache.dedicated_keys
        if not plus or k <= 2:
            return a, b
        # "+" variants: pick the split minimizing estimated search cost
        # (float32 sums on the host, as in the reference: above 2**24 the
        # walk totals, and so the split, may depend on summation order)
        fs = self._dedicated_slack(index, qi, forward=True)
        bs = self._dedicated_slack(index, qi, forward=False)
        cf = self._walk_counts(False, s, fs, k - 1)
        cb = self._walk_counts(True, t, bs, k - 1)
        best, best_cost = a, None
        for cand in range(1, k):
            cost = cf[:cand + 1].sum() + cb[:k - cand + 1].sum()
            if best_cost is None or cost < best_cost:
                best, best_cost = cand, cost
        return best, k - best

    def _dedicated_slack(self, index: QueryIndex, qi: int,
                         forward: bool) -> torch.Tensor:
        k = index.queries[qi][2]
        col = index.tgt_col[qi] if forward else index.src_col[qi]
        dist = index.dist_t if forward else index.dist_s
        # the index lives on the primary's device; a replica on another
        # card takes its slack over (on the same device .to is a no-op)
        return slack_from_dists(dist[:, int(col)][:, None],
                                np.array([k], np.int32),
                                np.array([0], np.int32),
                                index.INF).to(self.device)

    def _node_slack(self, index: QueryIndex, consumers,
                    forward: bool) -> torch.Tensor:
        qs = [qi for qi, _ in consumers]
        offs = np.array([off for _, off in consumers], np.int32)
        ks = np.array([index.queries[qi][2] for qi in qs], np.int32)
        col = index.tgt_col[qs] if forward else index.src_col[qs]
        dist = index.dist_t if forward else index.dist_s
        cols = dist[:, torch.as_tensor(col, dtype=torch.int64,
                                       device=dist.device)]
        return slack_from_dists(cols, ks, offs, index.INF).to(self.device)

    def _dists_host(self, index: QueryIndex):
        """Host copies of the index distances, made once per index (the
        host planner's input)."""
        # memoized per index OBJECT: keep a strong reference so a freed
        # index's id can never be reused to serve stale distances
        if self._host_dists is None or self._host_dists[0] is not index:
            self._host_dists = (index, (index.dist_s.cpu().numpy(),
                                        index.dist_t.cpu().numpy()))
        return self._host_dists[1]

    def _hop_ok(self, index: QueryIndex, cluster, forward: bool) -> np.ndarray:
        k_max = max(index.queries[qi][2] for qi in cluster)
        ds, dt = self._dists_host(index)
        if forward:
            cols = dt[:-1, index.tgt_col[list(cluster)]]
        else:
            cols = ds[:-1, index.src_col[list(cluster)]]
        return (cols.min(axis=1) <= k_max)

    def _walk_counts(self, reverse: bool, source: int, slack: torch.Tensor,
                     budget: int) -> np.ndarray:
        """Per-level walk-count totals (``index.walk_counts_ell``: one
        ``ell_spmm`` launch per level), copied to the host once. Totals are
        integer-valued float32, exact below 2**24."""
        # in-neighbour table of the swept direction: forward counts on G
        # relax over r_ell (in-nbrs of G), reverse counts over ell
        ell = self.dg.ell_idx if reverse else self.dg.r_ell_idx
        return walk_counts_ell(ell, source, slack, n=self.dg.n,
                               budget=budget).cpu().numpy()

    def _plan_caps(self, reverse: bool, source: int, budget: int,
                   slack: torch.Tensor) -> list[int]:
        """Per-level capacities: the walk-count totals clamped to
        ``max_cap`` and bucketed (``plan_caps``), else ``min_cap``
        everywhere; either way grown by the overflow retry."""
        if not self.cfg.plan_caps:
            return [self.cfg.min_cap] * (budget + 1)
        tot = self._walk_counts(reverse, source, slack, budget)
        return [_bucket(min(int(min(t, 2**31)), self.cfg.max_cap),
                        self.cfg.min_cap) for t in tot]


def _pad_width(ps: PathSet, width: int) -> PathSet:
    pad = width - ps.verts.shape[1]
    if pad <= 0:
        return ps
    verts = torch.nn.functional.pad(ps.verts, (0, pad), value=-1)
    return PathSet(verts, ps.count, ps.overflow)

