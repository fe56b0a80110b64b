"""PathSession: one facade over batch and streaming execution.

Counterpart of ``repro/core/session.py``. The session owns a
:class:`BatchPathEngine` (and, lazily, a
:class:`~repro_torch.launch.serve.StreamingServer`) so callers deal with
exactly one object and exactly one result type -- :class:`QueryResult` --
whether they run a one-shot batch or stream queries through micro-batch
admission::

    session = PathSession(graph, EngineConfig(cache_bytes=256 << 20))  # on "cuda"

    # one-shot batch
    report = session.run([PathQuery(s, t, k), (s2, t2, k2)])
    report[0].paths            # lazy host matrix
    report[1].count            # no matrix transfer

    # streaming (micro-batch admission over the same engine + cache)
    qid = session.submit(PathQuery(s, t, k, output="exists"))
    for qid, result in session.results().items():
        ...                    # the same QueryResult type as session.run

    # graph mutation: full swap (drops all graph-derived state) ...
    session.update_graph(new_graph)
    # ... or incremental edge deltas (CSR merge + hop-scoped cache
    # invalidation; queued to the next micro-batch boundary when streaming)
    session.apply_delta(GraphDelta.from_pairs(add=[(u, v)], remove=[(x, y)]))

The streaming machinery is imported lazily so ``repro_torch.core`` never
depends on ``repro_torch.launch`` at import time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from .cache import SharedPathCache
from .engine import BatchPathEngine, EngineConfig
from .graph import Graph
from .query import BatchReport, Planner, QueryLike, QueryResult

__all__ = ["PathSession"]


class PathSession:
    """Unified entry point for HC-s-t path query processing.

    Parameters
    ----------
    graph : the graph to query (or an existing :class:`BatchPathEngine`
        to wrap -- its config, cache and device are reused).
    config : engine configuration (ignored when wrapping an engine).
    planner : default execution strategy for :meth:`run` and for admitted
        micro-batches.
    cache : an explicit cross-batch :class:`SharedPathCache` (otherwise
        one is created when ``config.cache_bytes > 0``). Ignored when
        wrapping an engine.
    device : where the engine runs; ``None`` means ``"cuda"`` and raises
        when CUDA is absent -- pass ``"cpu"`` to run the plain kernel
        versions on the CPU.
    mesh / n_devices : sharded execution (``EngineConfig.mesh`` /
        ``n_devices`` overrides): ``mesh`` is a device list whose entry 0
        is ``device`` (repeats allowed: ``["cuda:0"] * 4`` is four
        replicas on one card); ``n_devices=N`` takes the first N local
        devices of ``device``'s type. Ignored when wrapping an engine.
    kernel_backend : ``"torch"`` | ``"cuda"``, overriding
        ``EngineConfig.kernel_backend``; it must agree with the device.
    trace : record stage spans into the process-wide
        :mod:`repro_torch.obs` tracer (``EngineConfig.trace`` override).
        ``session.tracer.export(path)`` writes the Chrome-trace JSON.
        Ignored when wrapping an engine; None defers to the config.
    n_groups / policy / gamma / warm_bias_eps : streaming-server knobs,
        applied when the first query is submitted. ``policy`` is an
        :class:`~repro_torch.launch.serve.AdmissionPolicy` (per-query
        deadlines via ``PathQuery.deadline_s``, ``max_queue`` load
        shedding, ``tenant_weights`` fairness).
    clock : the streaming server's notion of "now" (callable returning
        seconds) -- defaults to ``time.monotonic``; pass a
        :class:`~repro_torch.launch.serve.VirtualClock` for open-loop
        replay.
    """

    def __init__(self, graph: Union[Graph, BatchPathEngine],
                 config: Optional[EngineConfig] = None, *,
                 planner: Union[Planner, str] = Planner.BATCH,
                 cache: Optional[SharedPathCache] = None,
                 device: Union[torch.device, str, None] = None,
                 mesh=None, n_devices: Optional[int] = None,
                 kernel_backend: Optional[str] = None,
                 trace: Optional[bool] = None,
                 n_groups: int = 2, policy=None,
                 gamma: Optional[float] = None,
                 warm_bias_eps: float = 0.08,
                 clock=None):
        if isinstance(graph, BatchPathEngine):
            self.engine = graph
        else:
            if mesh is not None or n_devices is not None:
                config = dataclasses.replace(config or EngineConfig(),
                                             mesh=mesh, n_devices=n_devices)
            if kernel_backend is not None:
                config = dataclasses.replace(config or EngineConfig(),
                                             kernel_backend=kernel_backend)
            if trace is not None:
                config = dataclasses.replace(config or EngineConfig(),
                                             trace=trace)
            self.engine = BatchPathEngine(graph, config, cache=cache,
                                          device=device)
        self.planner = Planner.coerce(planner)
        self._server = None
        self._server_kw = dict(n_groups=n_groups, policy=policy,
                               gamma=gamma, warm_bias_eps=warm_bias_eps,
                               planner=self.planner, clock=clock)

    # -- one-shot batch ------------------------------------------------
    def run(self, queries: Sequence[QueryLike],
            planner: Optional[Union[Planner, str]] = None,
            clusters: Optional[list[list[int]]] = None) -> BatchReport:
        """Execute a batch now; returns a :class:`BatchReport`.

        A one-shot batch is a batch boundary: graph deltas still queued
        behind the streaming server are applied first, so batch and
        streaming consumers of one session never observe different graphs.
        """
        if self._server is not None:
            self._server.flush_deltas()
        return self.engine.run(queries,
                               self.planner if planner is None else planner,
                               clusters)

    # -- streaming -----------------------------------------------------
    @property
    def server(self):
        """The lazily created StreamingServer behind submit/results."""
        if self._server is None:
            from ..launch.serve import StreamingServer
            self._server = StreamingServer(self.engine, **self._server_kw)
        return self._server

    def submit(self, query: QueryLike, now: Optional[float] = None) -> int:
        """Enqueue one query (validated now; see StreamingServer.submit)."""
        return self.server.submit(query, now)

    def pump(self, now: Optional[float] = None) -> bool:
        """Admit every micro-batch the admission policy says is due."""
        return self.server.pump(now)

    def results(self, drain: bool = True) -> dict[int, QueryResult]:
        """Pop every finished query as ``{qid: QueryResult}`` -- the same
        result type :meth:`run` reports. ``drain=True`` (default) first
        flushes everything still waiting; ``drain=False`` returns only
        what already finished (a non-blocking poll)."""
        if self._server is None:
            return {}
        if drain:
            self._server.drain()
        return {qid: self._server.take(qid)
                for qid in list(self._server.results)}

    def result(self, qid: int) -> QueryResult:
        """Pop one finished query's result (KeyError if not finished)."""
        return self.server.take(qid)

    @property
    def batch_log(self) -> list[dict]:
        """Per-micro-batch latency/sharing/cache stats (streaming only)."""
        return [] if self._server is None else self._server.batch_log

    # -- graph mutation ------------------------------------------------
    def update_graph(self, graph: Graph) -> None:
        """Swap the graph wholesale: rebuilds device views and invalidates
        every piece of graph-derived state (host dists, cross-batch
        cache). Deltas still queued behind the streaming server are
        discarded -- they were expressed against the replaced graph. For
        incremental edge churn prefer :meth:`apply_delta`."""
        if self._server is not None:
            self._server.discard_pending_deltas()
        self.engine.set_graph(graph)

    def apply_delta(self, delta) -> Optional[dict]:
        """Apply a :class:`~repro_torch.core.delta.GraphDelta`
        incrementally.

        Batch mode (no streaming server yet): applied immediately via
        ``BatchPathEngine.apply_delta`` -- CSR merge, patched device
        tables, hop-scoped cache invalidation -- and the application
        report is returned. Streaming mode: the delta is queued and
        applied at the next micro-batch boundary so in-flight admission
        always sees a consistent graph snapshot; returns None (the report
        lands in ``batch_log`` / ``server.delta_log``).
        """
        if self._server is not None:
            self._server.apply_delta(delta)
            return None
        return self.engine.apply_delta(delta)

    @property
    def device(self) -> torch.device:
        return self.engine.device

    @property
    def kernel_backend(self) -> str:
        """The engine's kernel arm ("torch" | "cuda")."""
        return self.engine.kernel_arm.value

    @property
    def cache(self) -> Optional[SharedPathCache]:
        return self.engine.cache

    @property
    def tracer(self):
        """The engine's span tracer (:class:`repro_torch.obs.trace.Tracer`)
        -- recording only when the session or engine was built with
        tracing on. ``session.tracer.export(path)`` writes Chrome-trace
        JSON."""
        return self.engine.obs
