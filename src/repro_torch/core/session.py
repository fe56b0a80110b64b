"""PathSession: the one-object facade over the engine (batch runs).

Counterpart of ``repro/core/session.py`` for one-shot batches::

    session = PathSession(graph, EngineConfig(cache_bytes=256 << 20))  # on "cuda"
    report = session.run([PathQuery(s, t, k), (s2, t2, k2)])
    report[0].paths            # lazy host matrix
    report[1].count            # no matrix transfer
    session.apply_delta(GraphDelta.from_pairs(add=[(u, v)]))
                                      # patch + hop-scoped invalidation
    session.update_graph(new_graph)   # rebuild + invalidate the cache

Streaming (``server`` / ``submit`` / ``pump`` / ``results`` / ``result`` /
``batch_log``) is not part of this port yet: those members raise
``NotImplementedError``, and ``apply_delta`` applies every delta at once,
as the reference does before a streaming server exists.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from .cache import SharedPathCache
from .engine import BatchPathEngine, EngineConfig
from .graph import Graph
from .query import BatchReport, Planner, QueryLike

__all__ = ["PathSession"]

_STREAMING = ("streaming serving is not ported yet; it comes with a "
              "later slice of the PyTorch/CUDA port")


class PathSession:
    """Unified entry point for HC-s-t path query processing.

    Parameters
    ----------
    graph : the graph to query (or an existing :class:`BatchPathEngine`
        to wrap -- its config, cache and device are reused).
    config : engine configuration (ignored when wrapping an engine).
    planner : default execution strategy for :meth:`run`.
    cache : an explicit cross-batch :class:`SharedPathCache` (otherwise
        one is created when ``config.cache_bytes > 0``). Ignored when
        wrapping an engine.
    device : where the engine runs; ``None`` means ``"cuda"`` and raises
        when CUDA is absent -- pass ``"cpu"`` to run the plain kernel
        versions on the CPU.
    kernel_backend : ``"torch"`` | ``"cuda"``, overriding
        ``EngineConfig.kernel_backend``; it must agree with the device.
    """

    def __init__(self, graph: Union[Graph, BatchPathEngine],
                 config: Optional[EngineConfig] = None, *,
                 planner: Union[Planner, str] = Planner.BATCH,
                 cache: Optional[SharedPathCache] = None,
                 device: Union[torch.device, str, None] = None,
                 kernel_backend: Optional[str] = None):
        if isinstance(graph, BatchPathEngine):
            self.engine = graph
        else:
            if kernel_backend is not None:
                config = dataclasses.replace(config or EngineConfig(),
                                             kernel_backend=kernel_backend)
            self.engine = BatchPathEngine(graph, config, cache=cache,
                                          device=device)
        self.planner = Planner.coerce(planner)

    def run(self, queries: Sequence[QueryLike],
            planner: Optional[Union[Planner, str]] = None,
            clusters: Optional[list[list[int]]] = None) -> BatchReport:
        """Execute a batch now; returns a :class:`BatchReport`."""
        return self.engine.run(queries,
                               self.planner if planner is None else planner,
                               clusters)

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

    def update_graph(self, graph: Graph) -> None:
        """Swap the graph wholesale: rebuilds device views and invalidates
        every piece of graph-derived state (host dists, cross-batch
        cache)."""
        self.engine.set_graph(graph)

    def apply_delta(self, delta) -> dict:
        """Apply a :class:`~repro_torch.core.delta.GraphDelta`
        incrementally, now, through ``BatchPathEngine.apply_delta`` (CSR
        merge, patched device tables, hop-scoped cache invalidation), and
        return its application report. (The reference queues the delta
        for the next micro-batch boundary once a streaming server runs;
        streaming is not ported.)"""
        return self.engine.apply_delta(delta)

    # -- not ported yet ------------------------------------------------
    @property
    def server(self):
        raise NotImplementedError(_STREAMING)

    def submit(self, query: QueryLike, now: Optional[float] = None) -> int:
        raise NotImplementedError(_STREAMING)

    def pump(self, now: Optional[float] = None) -> bool:
        raise NotImplementedError(_STREAMING)

    def results(self, drain: bool = True):
        raise NotImplementedError(_STREAMING)

    def result(self, qid: int):
        raise NotImplementedError(_STREAMING)

    @property
    def batch_log(self) -> list:
        raise NotImplementedError(_STREAMING)
