"""Streaming batch query serving (the paper's deployment shape, made
continuous).

Counterpart of ``repro/launch/serve.py``::

    PYTHONPATH=src python -m repro_torch.launch.serve --n 20000 \
        --queries 64 --similarity 0.6 --groups 2 --rounds 3 --cache-mb 256

runs on the card (``--device cpu`` runs the kernels' plain versions).

Queries arrive one at a time and are coalesced into micro-batches by a
deadline/size admission policy. Each micro-batch is clustered with a
*cache-aware* bias (queries whose half-query results are already warm in
the cross-batch ``SharedPathCache`` are pulled together), the clusters go
to replica groups through the work-stealing scheduler, and the engine
executes them consulting the cache before materializing any Ψ node.
Per-batch latency, sharing and cache hit/miss stats are logged; a result
sample is validated against the oracle.

The admission layer is SLO-aware (``docs/serving.md`` § SLO-aware
admission in the reference): per-query deadlines
(``PathQuery.deadline_s``) cut a
micro-batch early when the oldest waiter's slack is spent, admission
ordering is weighted-fair across tenants, and under pressure
(``AdmissionPolicy.max_queue``) exists/count queries are answered through
the cost-router fast path while path queries are shed with a typed
:class:`~repro_torch.core.query.ResultStatus.SHED` result. Replica-group
failures mid-batch are absorbed by the work-stealing scheduler's
checkpointable queue: the failed group's in-flight cluster is requeued
onto survivors (at-least-once; results land exactly once per query id).

On one device every micro-batch takes the reference's scheduler loop:
each cluster is one scheduler item and one ``engine.run``. On a sharded
engine (``EngineConfig.mesh`` / ``n_devices``, ``--devices`` here) the
executor's cost-balanced placement replaces that loop: one
``engine.run`` over every cluster of the micro-batch, fanned across the
replicas (``batch_log``'s ``per_device`` / ``n_devices``). The batch
wall (``serve.batch``) and the assembly time (``serve.assemble``) are
spans of the engine's tracer that end in a device synchronize, so they
include the kernels. Only :class:`GroupFailure` is treated as a replica
failure; any other error, a kernel that fails to build or launch among
them, propagates.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import math
import time
from typing import Callable, Optional, Sequence

import numpy as np

from ..core import BatchPathEngine, EngineConfig, build_index
from ..core import generators
from ..core.planner import admission_fast_path
from ..core.query import (Output, PathQuery, Planner, QueryLike, QueryResult)
from ..core.clustering import cluster_queries
from ..core.similarity import similarity_matrix
from ..ft.scheduler import WorkStealingScheduler
from ..obs import metrics as obsmetrics

__all__ = ["AdmissionPolicy", "StreamingServer", "GroupFailure",
           "VirtualClock", "ServiceModelClock", "serve_batch",
           "warm_cluster_bias"]


class GroupFailure(RuntimeError):
    """A replica group died while executing a scheduler item.

    Raised by a failure injector (tests, exp11's mid-stream kill) or by
    wrapping real executor errors; the serving loop catches it, marks the
    group dead, requeues the in-flight cluster via
    :meth:`WorkStealingScheduler.fail_group`, and carries on with the
    survivors.
    """

    def __init__(self, group: int, msg: str = ""):
        super().__init__(msg or f"replica group {group} failed")
        self.group = group


class VirtualClock:
    """A settable monotonic clock for open-loop replay (exp11).

    The streaming server reads its notion of "now" through a callable; a
    ``VirtualClock`` lets a benchmark drive arrivals in simulated time
    while still charging real execution walls — the server calls
    ``advance(wall_s)`` after each admitted batch, so queueing delay under
    load accumulates exactly as it would against a wall clock, without the
    replay having to sleep through idle gaps.
    """

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


class ServiceModelClock(VirtualClock):
    """Virtual clock charging a calibrated affine cost per dispatch.

    A copy of the reference benchmark's clock
    (``benchmarks/exp11_open_loop.py``). ``StreamingServer`` charges the
    clock through ``advance_batch(wall, n_queries)`` after every batch
    (and fast-path dispatch); ignoring the noisy real wall in favor of
    the calibrated ``c0 + c1*Q`` model keeps the admission timeline --
    batch cuts, sheds, deadline misses -- identical across replays of the
    same trace. ``c0``/``c1`` come from measured warm batch walls at two
    sizes, so the virtual timeline is still anchored to the machine's
    speed.
    """

    def __init__(self, c0_s: float, c1_s: float):
        super().__init__()
        self.c0_s, self.c1_s = float(c0_s), float(c1_s)
        self.dispatches = 0

    def advance_batch(self, dt: float, n_queries: int) -> None:
        del dt                              # model, not wall
        self.t += self.c0_s + self.c1_s * n_queries
        self.dispatches += 1


@dataclasses.dataclass
class AdmissionPolicy:
    """When to close the open micro-batch — and what to refuse.

    The first three fields are the classic size/delay cutoffs. The SLO
    layer on top of them:

    * ``max_queue`` — admission control: when this many queries already
      wait, a new exists/count submission is answered immediately through
      the cost-router fast path (cheap by construction) and a new paths
      submission is **shed** with a typed
      :class:`~repro_torch.core.query.ResultStatus.SHED` result instead of
      joining a queue it would time out of. ``None`` disables shedding.
    * ``shed_expired`` — a query whose deadline has already passed at
      admission time is shed (reason ``"deadline"``) rather than executed:
      the work is wasted either way, and skipping it protects the queries
      that can still meet their SLO.
    * ``tenant_weights`` — weighted-fair admission ordering: queries are
      admitted in decreasing ``wait × weight(tenant)`` order (unknown
      tenants weigh 1.0), with deadline urgency taking precedence — see
      :meth:`order_key`.

    Deadline slack additionally *cuts the batch early*: ``due`` fires as
    soon as the oldest waiter's remaining slack (deadline − now − expected
    service time) is spent, regardless of ``min_batch``/``max_delay_s`` —
    deadlines take precedence over coalescing.
    """

    max_batch: int = 32         # admit as soon as this many queries wait
    max_delay_s: float = 0.02   # ... or the oldest has waited this long
    min_batch: int = 1          # never admit fewer, unless the deadline
    # has passed (the deadline overrides min_batch: a lone query older
    # than max_delay_s must not starve until drain())
    max_queue: Optional[int] = None     # waiting cap; beyond it, shed
    shed_expired: bool = True           # shed already-expired deadlines
    tenant_weights: Optional[dict] = None   # tenant -> weight (default 1.0)

    def due(self, n_waiting: int, oldest_wait_s: float,
            min_slack_s: Optional[float] = None) -> bool:
        if n_waiting <= 0:
            return False
        if min_slack_s is not None and min_slack_s <= 0:
            return True     # a waiter's SLO slack is spent: cut the batch now
        if oldest_wait_s >= self.max_delay_s:
            return True
        if n_waiting < self.min_batch:
            return False
        return n_waiting >= self.max_batch

    def weight(self, tenant: str) -> float:
        return (self.tenant_weights or {}).get(tenant, 1.0)

    def order_key(self, query: PathQuery, wait_s: float,
                  deadline: Optional[float]):
        """Admission-order sort key (ascending = admitted first).

        Deadline queries come first, earliest absolute deadline first
        (EDF); within the no-deadline tail, decreasing weighted wait —
        so a tenant with weight 2 drains twice as fast as weight 1 under
        contention, and nobody starves (wait grows without bound).
        """
        return (deadline if deadline is not None else math.inf,
                -wait_s * self.weight(query.tenant))


def warm_cluster_bias(engine: BatchPathEngine, queries: Sequence[QueryLike],
                      eps: float = 0.08) -> Optional[np.ndarray]:
    """(Q, Q) additive clustering bonus from cross-batch cache warmth.

    Two queries get a bonus when they share a half-query root (same source
    or same target) and the cache holds results enumerated from that root —
    landing them in the same cluster makes the plan regenerate the cached
    node's signature so the hit actually fires. A root-warmth probe is a
    heuristic (the consumer-set part of the key may still differ); a wrong
    bonus costs nothing but a slightly different clustering.
    """
    cache = engine.cache
    if cache is None or len(queries) < 2:
        return None
    if any(not isinstance(q, PathQuery) for q in queries):
        # coerce only mixed/legacy inputs; the admission hot path hands
        # us already-validated PathQuery objects every micro-batch
        queries = [PathQuery.coerce(q) for q in queries]
    warm_f = [cache.has_root("f", q.s) for q in queries]
    warm_b = [cache.has_root("b", q.t) for q in queries]
    Q = len(queries)
    bias = np.zeros((Q, Q), np.float64)
    src = np.array([q.s for q in queries])
    tgt = np.array([q.t for q in queries])
    wf = np.array(warm_f)
    wb = np.array(warm_b)
    same_src = (src[:, None] == src[None, :]) & wf[:, None] & wf[None, :]
    same_tgt = (tgt[:, None] == tgt[None, :]) & wb[:, None] & wb[None, :]
    bias += eps * same_src + eps * same_tgt
    np.fill_diagonal(bias, 0.0)
    return bias if bias.any() else None


@dataclasses.dataclass
class _Waiting:
    """One enqueued query: id, query, arrival time, absolute deadline."""

    qid: int
    query: PathQuery
    arrival: float
    deadline: Optional[float]   # arrival + query.deadline_s, or None


def _tenant_counts(queries: Sequence[PathQuery]) -> dict[str, int]:
    out: dict[str, int] = {}
    for q in queries:
        out[q.tenant] = out.get(q.tenant, 0) + 1
    return out


class StreamingServer:
    """Continuous admission loop over a shared engine + scheduler.

    Usage::

        srv = StreamingServer(engine, n_groups=2)
        qid = srv.submit((s, t, k))     # returns a stable query id
        srv.apply_delta(delta)          # edge churn: applied at the next
                                        # micro-batch boundary (see delta_log)
        srv.pump()                      # admit due micro-batches (call often)
        srv.drain()                     # flush everything still waiting
        srv.results[qid]                # QueryResult (same type as batch runs)

    Submissions are validated eagerly (``PathQuery`` coercion + graph
    bounds), so one malformed query is rejected at submit time instead of
    failing an entire admitted micro-batch inside the engine. The engine's
    cross-batch cache (if configured) persists across micro-batches;
    per-batch cache hit/miss and materialization stats are appended to
    ``batch_log``.
    """

    def __init__(self, engine: BatchPathEngine, n_groups: int = 2,
                 gamma: Optional[float] = None,
                 policy: Optional[AdmissionPolicy] = None,
                 warm_bias_eps: float = 0.08,
                 planner: Planner | str = Planner.BATCH,
                 clock: Optional[Callable[[], float]] = None):
        self.engine = engine
        self.n_groups = n_groups
        self.gamma = engine.cfg.gamma if gamma is None else gamma
        self.policy = policy or AdmissionPolicy()
        self.warm_bias_eps = warm_bias_eps
        # planner for admitted micro-batches; AUTO additionally turns on
        # the submit-time fast path (certainly-GREEN queries answered
        # immediately instead of waiting out micro-batch coalescing)
        self.planner = Planner.coerce(planner)
        self.n_fast_path = 0
        self.n_shed = 0
        self.n_deadline_miss = 0
        # the serving notion of "now": a wall clock by default, or a
        # VirtualClock for open-loop replay (advanced by real batch walls)
        self.clock = clock or time.monotonic
        # failure injection + failover state: a GroupFailure raised while
        # a group executes its item marks the group dead and requeues the
        # item via the scheduler's checkpointable queue (at-least-once)
        self.fail_injector: Optional[Callable] = None   # (group, item) -> None
        self.dead_groups: set[int] = set()
        self.n_failovers = 0
        self.sched = WorkStealingScheduler(
            n_groups, cost_fn=lambda qs: float(len(qs)) ** 1.5)
        self.results: dict[int, QueryResult] = {}
        self.batch_log: list[dict] = []
        self.delta_log: list[dict] = []             # per-delta engine reports
        self._waiting: list[_Waiting] = []
        self._query_of: dict[int, PathQuery] = {}   # qid -> query
        self._pending_deltas: list = []             # applied at batch boundary
        self._delta_mark = 0       # delta_log watermark of the last batch
        self._shed_mark = 0        # n_shed watermark of the last batch
        self._next_qid = 0
        self._service_ewma = 0.0   # smoothed batch wall, for slack estimates

    def _now(self) -> float:
        return self.clock()

    def _advance(self, dt: float, n_queries: int = 1) -> None:
        """Charge execution to a virtual clock (no-op on a real clock,
        whose reading already includes it). A clock exposing
        ``advance_batch(dt, n_queries)`` gets the dispatch size too — how
        exp11's deterministic service-cost model charges ``c0 + c1*Q``
        instead of the (noisy) real wall; a plain :class:`VirtualClock`
        is charged the real wall via ``advance(dt)``."""
        advance_batch = getattr(self.clock, "advance_batch", None)
        if advance_batch is not None:
            advance_batch(dt, n_queries)
            return
        advance = getattr(self.clock, "advance", None)
        if advance is not None:
            advance(dt)

    # -- ingress -------------------------------------------------------
    def submit(self, query: QueryLike, now: Optional[float] = None) -> int:
        """Validate and enqueue one query; returns a stable query id.

        Raises ValueError immediately for malformed queries (bad arity,
        s == t, k < 1, vertices outside the graph) — admission never sees
        them, so they cannot poison a micro-batch.

        Under ``planner=AUTO``, certainly-GREEN queries (exists-only; see
        ``core.planner.admission_fast_path``) bypass coalescing entirely:
        they are answered here, against the graph as of the last flushed
        delta (the same boundary semantics an admitted batch would see —
        queued-but-unflushed deltas apply at the *next* batch boundary,
        which this fast path never waits for).

        Under pressure (``AdmissionPolicy.max_queue`` queries already
        waiting), load shedding kicks in: exists/count queries are
        answered immediately through the cost-router fast path (they
        never touch the queue), and paths queries are **shed** — the
        result is a typed ``ResultStatus.SHED`` ``QueryResult`` (reason
        ``"overload"``), delivered through ``results``/``take`` like any
        answer, and counted in ``serve_shed_total``.
        """
        q = PathQuery.coerce(query).check_bounds(self.engine.g.n)
        qid = self._next_qid
        self._next_qid += 1
        self._query_of[qid] = q
        reg = obsmetrics.registry()
        if self.planner is Planner.AUTO and admission_fast_path(q):
            reg.counter("serve_fast_path_total").inc()
            self.n_fast_path += 1
            return self._run_fast_path(qid, q)
        pol = self.policy
        if pol.max_queue is not None and len(self._waiting) >= pol.max_queue:
            if q.output in (Output.EXISTS, Output.COUNT):
                # pressure relief: cheap outputs take the direct routed
                # plan now instead of deepening the queue they'd time out of
                reg.counter("serve_pressure_fast_path_total").inc()
                return self._run_fast_path(qid, q)
            return self._shed(qid, q, "overload")
        arrival = self._now() if now is None else now
        deadline = None if q.deadline_s is None else arrival + q.deadline_s
        self._waiting.append(_Waiting(qid, q, arrival, deadline))
        return qid

    def _run_fast_path(self, qid: int, q: PathQuery) -> int:
        """Answer one query immediately (no coalescing) via Planner.AUTO
        routing; charges its wall to a virtual clock like a batch."""
        reg = obsmetrics.registry()
        with self.engine.stage("serve.fast_path") as sfp:
            r = self.engine.run([q], planner=Planner.AUTO)
        self.results[qid] = r[0].offload()
        self._advance(sfp.duration, 1)
        e2e = r.stats.get("t_wall_s", 0.0)
        reg.histogram("serve_admission_wait_s").record(0.0)
        reg.histogram("serve_admission_wait_s", tenant=q.tenant).record(0.0)
        reg.histogram("serve_query_e2e_s").record(e2e)
        if q.deadline_s is not None and e2e > q.deadline_s:
            self.n_deadline_miss += 1
            reg.counter("serve_deadline_miss_total").inc()
        return qid

    def _shed(self, qid: int, q: PathQuery, reason: str) -> int:
        self.results[qid] = QueryResult.shed(q, reason)
        self.n_shed += 1
        obsmetrics.registry().counter("serve_shed_total",
                                      reason=reason).inc()
        return qid

    def apply_delta(self, delta) -> None:
        """Queue a :class:`~repro_torch.core.delta.GraphDelta` for application at
        the next micro-batch boundary.

        Deltas never interleave with an admitted batch — queries already
        handed to the engine finish against the graph they were admitted
        under, and every later admission sees the mutated graph. Queued
        deltas are flushed (in submission order) by ``pump()`` / ``drain()``
        even when no query batch is due; per-delta engine reports (CSR
        merge sizes, hop-scoped cache eviction counts) append to
        ``delta_log``, and the next batch's ``batch_log`` entry carries the
        aggregated delta/invalidation counters.

        Validated eagerly, like ``submit``: deltas only mutate edges (the
        vertex set is fixed), so an out-of-range vertex id is rejected
        here — not mid-flush, where the failed delta would be lost from
        the queue while later deltas still applied.
        """
        n = self.engine.g.n
        if delta.max_vertex() >= n:
            raise ValueError(f"delta references vertices outside the graph "
                             f"(n={n}, max id {delta.max_vertex()})")
        self._pending_deltas.append(delta)

    def flush_deltas(self) -> None:
        """Apply every queued delta now (the caller asserts this is a
        batch boundary — pump/drain/admission call it automatically, and
        ``PathSession.run`` does before a one-shot batch). A delta is
        dequeued only after it applied: if the engine raises mid-flush, the
        failed delta stays at the head so a retry cannot silently skip it
        while later deltas apply."""
        while self._pending_deltas:
            self.delta_log.append(
                self.engine.apply_delta(self._pending_deltas[0]))
            self._pending_deltas.pop(0)

    def discard_pending_deltas(self) -> list:
        """Drop queued deltas unapplied; returns them. A full graph swap
        supersedes edge deltas expressed against the replaced graph —
        applying them to the new graph would corrupt it (or crash on
        out-of-range vertices)."""
        dropped, self._pending_deltas = self._pending_deltas, []
        return dropped

    def pump(self, now: Optional[float] = None) -> bool:
        """Admit every micro-batch the policy says is due (a burst can
        leave several deadline-expired batches queued at once). Queued
        graph deltas are applied first — a batch boundary by definition.

        "Now" is re-read from the clock every iteration (an admitted
        batch advances a virtual clock by its execution wall), so later
        batches in a burst see the time earlier ones consumed.
        """
        self.flush_deltas()
        admitted = False
        while self._waiting:
            t = self._now() if now is None else now
            now = None      # only the first iteration honors the override
            oldest = t - min(w.arrival for w in self._waiting)
            if not self.policy.due(len(self._waiting), oldest,
                                   self._min_slack(t)):
                break
            self._admit()
            admitted = True
        return admitted

    def _min_slack(self, now: float) -> Optional[float]:
        """Tightest remaining SLO slack over the waiting queue: absolute
        deadline minus now minus the expected service wall (EWMA of recent
        batch walls). None when nothing waiting carries a deadline."""
        deadlines = [w.deadline for w in self._waiting
                     if w.deadline is not None]
        if not deadlines:
            return None
        return min(deadlines) - now - self._service_ewma

    def drain(self) -> None:
        """Flush: admit everything still waiting, policy notwithstanding."""
        self.flush_deltas()
        while self._waiting:
            self._admit()

    def take(self, qid: int) -> QueryResult:
        """Pop a finished query's QueryResult (KeyError if not finished).

        A continuous server must drain ``results`` this way — entries are
        kept until taken, so an untaken backlog grows without bound.
        """
        out = self.results.pop(qid)   # KeyError first: keep pending intact
        self._query_of.pop(qid, None)
        return out

    # -- failover ------------------------------------------------------
    def _fail_group(self, group: int) -> None:
        self.dead_groups.add(group)
        self.n_failovers += 1
        # the scheduler requeues every cluster in flight on the failed
        # group onto the least-loaded survivor (checkpointable queue —
        # the same path WorkStealingScheduler.restore takes after a
        # process crash); items carry global qids, so a requeue from any
        # earlier micro-batch still resolves to the right queries
        self.sched.fail_group(group)
        obsmetrics.registry().counter("serve_failover_total").inc()

    def kill_group(self, group: int) -> None:
        """Declare a replica group dead between batches (exp11 uses the
        ``fail_injector`` hook to kill one *mid-batch* instead). Its
        queued/in-flight clusters are requeued onto the survivors."""
        if group in self.dead_groups:
            return
        self._fail_group(group)

    def revive_group(self, group: int) -> None:
        """Bring a dead group back (a replacement replica joined). The
        engine-side cache state was never lost — replicas share the
        engine, so a revived group starts warm."""
        self.dead_groups.discard(group)

    # -- one micro-batch -----------------------------------------------
    def _admit(self) -> None:
        self.flush_deltas()   # an admission IS a micro-batch boundary
        deltas = self.delta_log[self._delta_mark:]
        self._delta_mark = len(self.delta_log)
        t_admit = self._now()
        reg = obsmetrics.registry()
        # deadline-expired waiters are shed before ordering: executing
        # them cannot meet their SLO and only steals slack from queries
        # that still can (AdmissionPolicy.shed_expired disables this)
        if self.policy.shed_expired:
            keep = []
            for w in self._waiting:
                if w.deadline is not None and t_admit > w.deadline:
                    self._shed(w.qid, w.query, "deadline")
                else:
                    keep.append(w)
            self._waiting = keep
            if not self._waiting:
                return
        # weighted-fair, deadline-first admission order (policy.order_key)
        self._waiting.sort(key=lambda w: self.policy.order_key(
            w.query, t_admit - w.arrival, w.deadline))
        batch = self._waiting[:self.policy.max_batch]
        self._waiting = self._waiting[self.policy.max_batch:]
        qids = [w.qid for w in batch]
        queries = [w.query for w in batch]
        # admission wait: submit -> this batch boundary, per query
        waits = [t_admit - w.arrival for w in batch]
        h_wait = reg.histogram("serve_admission_wait_s")
        for w, entry in zip(waits, batch):
            h_wait.record(w)
            reg.histogram("serve_admission_wait_s",
                          tenant=entry.query.tenant).record(w)
        with self.engine.stage("serve.batch", n_queries=len(batch)) as sb:
            steals_before = self.sched.steals
            failovers_before = self.sched.failovers
            requeued_before = self.sched.requeued
            with self.engine.stage("serve.assemble",
                                   n_queries=len(batch)) as sasm:
                # the kernel arm follows the engine's device, the sweeps
                # its index route (over its own, unsharded lists)
                index = build_index(self.engine.dg,
                                    [q.key for q in queries],
                                    self.engine.cfg.edge_chunk,
                                    route=self.engine.cfg.index_route)
                mu = similarity_matrix(index)
                bias = warm_cluster_bias(self.engine, queries,
                                         self.warm_bias_eps)
                # balance_clusters must act HERE, not just inside
                # engine.run -- the engine keeps an explicitly passed
                # clustering verbatim, so a similar-traffic micro-batch
                # merged to one cluster would idle every replica but one
                executor = self.engine.executor
                min_clusters = executor.n_replicas \
                    if self.engine.cfg.balance_clusters else 1
                clusters = cluster_queries(mu, self.gamma, bias=bias,
                                           min_clusters=min_clusters)
            # scheduler items carry global qids so a requeued item from
            # any earlier micro-batch still resolves to the right queries
            # n_compiles / n_retraces stay 0 unless the engine runs with
            # EngineConfig.log_compiles -- then each batch_log entry shows
            # whether this micro-batch loaded a kernel library (a cold
            # start) or found every one ready (retraces == 0)
            agg = {"n_psi_nodes": 0, "n_materialized": 0,
                   "n_cache_hits": 0, "n_cache_misses": 0,
                   "n_compiles": 0, "n_retraces": 0,
                   "routed_green": 0, "routed_yellow": 0, "routed_red": 0}
            per_device = None
            if executor.sharded:
                # sharded serving: the executor's greedy cost-balanced
                # placement replaces the host work-stealing loop -- one
                # run carries every (cache-aware) cluster, fanned across
                # the replicas and gathered back
                r = self.engine.run(queries, planner=self.planner,
                                    clusters=clusters)
                for i, qid in enumerate(qids):
                    self.results[qid] = r[i].offload()
                for key in agg:
                    agg[key] += r.stats.get(key, 0)
                per_device = r.stats.get("per_device")
            else:
                cids = self.sched.submit([[qids[li] for li in cl]
                                          for cl in clusters])
                open_cids = set(cids)
                while open_cids:
                    progressed = False
                    for grp in range(self.n_groups):
                        if grp in self.dead_groups:
                            continue
                        item = self.sched.next_for(grp)
                        if item is None:
                            continue
                        progressed = True
                        try:
                            if self.fail_injector is not None:
                                self.fail_injector(grp, item)
                            sub = [self._query_of[qid]
                                   for qid in item.queries]
                            # the item IS one cluster — pass it through so
                            # the engine keeps our (cache-aware) grouping
                            # instead of re-clustering
                            r = self.engine.run(
                                sub, planner=self.planner,
                                clusters=[list(range(len(sub)))])
                        except GroupFailure:
                            # the group died mid-item: mark it dead and
                            # requeue its in-flight cluster onto the
                            # survivors (at-least-once — a result written
                            # before the crash would simply be overwritten
                            # by the re-run, idempotent by query id)
                            self._fail_group(grp)
                            continue
                        for i, qid in enumerate(item.queries):
                            # results may sit untaken indefinitely —
                            # offload so the backlog holds compact host
                            # rows, not padded device buffers (count/
                            # exists results hold none)
                            self.results[qid] = r[i].offload()
                        for key in agg:
                            agg[key] += r.stats.get(key, 0)
                        self.sched.complete(item.cluster_id, True)
                        open_cids.discard(item.cluster_id)
                    if not progressed:
                        if open_cids and len(self.dead_groups) \
                                >= self.n_groups:
                            raise RuntimeError(
                                f"all {self.n_groups} replica groups are "
                                f"dead with {len(open_cids)} cluster(s) "
                                f"unserved; revive_group() one first")
                        if not any(cid in self.sched.in_flight
                                   for cid in open_cids):
                            break   # nothing runnable (foreign in-flight)
        wall = sb.duration
        # a virtual clock is charged the real execution wall here, so the
        # e2e readout below sees queueing + service on one timeline
        self._advance(wall, len(batch))
        # end-to-end latency: submit -> results resident, per query
        t_done = self._now()
        # the slack estimator must live on the SAME clock deadlines do:
        # under a virtual clock the charged (model) time is the service
        # cost, and on a real clock t_done - t_admit is the batch wall
        svc = t_done - t_admit
        self._service_ewma = (svc if self._service_ewma == 0.0
                              else 0.7 * self._service_ewma + 0.3 * svc)
        e2e = [t_done - w.arrival for w in batch]
        h_e2e = reg.histogram("serve_query_e2e_s")
        n_miss = 0
        for v, entry in zip(e2e, batch):
            h_e2e.record(v)
            if entry.deadline is not None and t_done > entry.deadline:
                n_miss += 1
        if n_miss:
            self.n_deadline_miss += n_miss
            reg.counter("serve_deadline_miss_total").inc(n_miss)
        Q = len(queries)
        self.batch_log.append({
            "wall_s": wall, "n_queries": Q, "n_clusters": len(clusters),
            # the engine's kernel arm: "cuda" on the card, "torch" on the
            # CPU (the reference reports its kernel backend here)
            "kernel_backend": self.engine.kernel_arm.value,
            "steals": self.sched.steals - steals_before,
            "failovers": self.sched.failovers - failovers_before,
            "requeued": self.sched.requeued - requeued_before,
            "n_deadline_miss": n_miss,
            # sheds since the previous batch boundary (submit-time
            # overload sheds + this admission's deadline sheds)
            "n_shed": self.n_shed - self._shed_mark,
            "tenants": _tenant_counts(queries),
            "warm_biased": bias is not None,
            # micro-batch assembly (index + similarity + clustering) and
            # the per-query latency shape of this admission window
            "t_assemble_s": sasm.duration,
            "admission_wait_p50_s": float(np.percentile(waits, 50)),
            "admission_wait_max_s": float(max(waits)),
            "e2e_p50_s": float(np.percentile(e2e, 50)),
            "e2e_p99_s": float(np.percentile(e2e, 99)),
            "mu_mean": float((mu.sum() - Q) / max(Q * (Q - 1), 1)),
            # graph deltas applied since the previous micro-batch
            "n_deltas": len(deltas),
            "delta_edges": sum(d["n_added"] + d["n_removed"] for d in deltas),
            "delta_cache_evicted": sum(d.get("cache_evicted", 0)
                                       for d in deltas),
            # survivors after the last delta that actually touched the
            # cache (a trailing no-op delta reports nothing)
            "delta_cache_kept": next((d["cache_kept"] for d in
                                      reversed(deltas) if "cache_kept" in d),
                                     0),
            # retraces paid inside apply_delta itself (0 without
            # EngineConfig.log_compiles, and on any warm delta path)
            "delta_retraces": sum(d.get("n_retraces", 0) for d in deltas),
            **({"per_device": per_device,
                "n_devices": len(per_device)} if per_device else {}),
            **agg,
            **({"cache": self.engine.cache.info()}
               if self.engine.cache is not None else {}),
        })
        self._shed_mark = self.n_shed


def serve_batch(engine: BatchPathEngine, queries, n_groups: int = 2,
                gamma: float = 0.5):
    """One-shot batch serving (compat wrapper over the streaming loop).

    Cluster -> schedule -> process with stealing. Returns (results, info)
    where results maps query index -> QueryResult. New code should prefer
    ``PathSession`` (``repro_torch.core.session``), which fronts the same
    loop.
    """
    srv = StreamingServer(engine, n_groups=n_groups, gamma=gamma,
                          policy=AdmissionPolicy(max_batch=max(len(queries), 1),
                                                 max_delay_s=0.0))
    for q in queries:
        srv.submit(q)
    srv.drain()
    # deep copy: batch_log entries hold nested dicts (cache info, tenant
    # counts) that later batches/deltas keep mutating — a
    # shallow dict() would alias them into the returned snapshot
    info = copy.deepcopy(srv.batch_log[-1]) if srv.batch_log \
        else {"wall_s": 0.0}
    return srv.results, info


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--similarity", type=float, default=0.6)
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--k-min", type=int, default=4)
    ap.add_argument("--k-max", type=int, default=5)
    ap.add_argument("--validate", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeat the workload to exercise the warm cache")
    ap.add_argument("--cache-mb", type=int, default=256,
                    help="cross-batch cache budget in MiB (0 disables)")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--devices", type=int, default=0,
                    help="shard over the first N local devices of --device "
                         "(0 = plain single-device)")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="record stage spans and export a Chrome-trace "
                         "JSON here at exit (open in chrome://tracing or "
                         "ui.perfetto.dev)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="capture a torch.profiler trace of the serving "
                         "rounds (stage spans annotated) into this "
                         "directory as Chrome-trace JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default cuda; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.rounds < 1:
        ap.error("--rounds must be >= 1")

    g = generators.community(args.n, n_comm=max(4, args.n // 2500),
                             avg_deg=6.0, seed=0)
    engine = BatchPathEngine(g, EngineConfig(
        min_cap=128, cache_bytes=args.cache_mb << 20,
        n_devices=args.devices or None,
        trace=args.trace is not None or args.profile is not None,
        trace_annotations=args.profile is not None), device=args.device)
    queries = generators.similar_queries(g, args.queries, args.similarity,
                                         (args.k_min, args.k_max), seed=1)
    srv = StreamingServer(engine, n_groups=args.groups,
                          policy=AdmissionPolicy(max_batch=args.max_batch,
                                                 max_delay_s=0.0))
    from ..obs import torchprof
    qids_by_round = []
    with torchprof.profile_run(args.profile, device=engine.device):
        for _ in range(args.rounds):
            qids_by_round.append([srv.submit(q) for q in queries])
            srv.drain()
    for bi, b in enumerate(srv.batch_log):
        cache = b.get("cache", {})
        print(f"batch {bi}: {b['n_queries']} queries, "
              f"{b['n_clusters']} clusters, {b['wall_s']:.2f}s, "
              f"psi={b['n_psi_nodes']} materialized={b['n_materialized']} "
              f"hits={b['n_cache_hits']} "
              f"(cache: {cache.get('entries', 0)} entries, "
              f"{cache.get('nbytes', 0) >> 20} MiB)")
    n_paths = sum(srv.results[qid].count for qid in qids_by_round[0])
    print(f"served {args.rounds}x{len(queries)} queries -> "
          f"{n_paths} paths per round on {engine.device} "
          f"({engine.kernel_arm.value} kernels)")
    # oracle validation sample + cross-round consistency
    from ..core.oracle import enumerate_paths_bruteforce, path_set
    rng = np.random.default_rng(0)
    for qi in rng.choice(len(queries), size=min(args.validate, len(queries)),
                         replace=False):
        s, t, k = queries[qi]
        truth = path_set(enumerate_paths_bruteforce(g, s, t, k))
        for round_qids in qids_by_round:
            if path_set(srv.results[round_qids[qi]].paths) != truth:
                raise RuntimeError(f"query {(s, t, k)} disagrees with the "
                                   f"brute-force oracle")
    print(f"validated {args.validate} queries against the oracle "
          f"(all {args.rounds} rounds): OK")
    if args.profile:
        print(f"profile: torch.profiler Chrome trace of the serving rounds "
              f"in {args.profile} (stage spans annotated)")
    if args.trace:
        doc = engine.obs.export(args.trace)
        n_spans = sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
        e2e = obsmetrics.registry().histogram("serve_query_e2e_s")
        print(f"trace: {n_spans} spans -> {args.trace} "
              f"(python -m repro_torch.obs summarize {args.trace}); "
              f"e2e p50={e2e.quantile(0.5) * 1e3:.1f}ms "
              f"p99={e2e.quantile(0.99) * 1e3:.1f}ms")


if __name__ == "__main__":
    main()
