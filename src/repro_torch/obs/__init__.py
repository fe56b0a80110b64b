"""repro_torch.obs -- runtime observability of the port.

* :mod:`repro_torch.obs.trace` -- the hierarchical span tracer (stdlib
  only). The engine times its stages through ``Span`` handles; enabling
  the process tracer (``EngineConfig.trace`` / ``PathSession(trace=True)``
  / ``serve --trace``) records them into a ring buffer exportable as
  Chrome-trace/Perfetto JSON.
* :mod:`repro_torch.obs.metrics` -- the process-wide registry of
  counters, gauges and histograms (the cache's hit/miss/eviction
  counters, ``routed_*``, ``engine_batch_wall_s``, ``query_latency_s``
  and the streaming server's ``serve_*``).

* :mod:`repro_torch.obs.torchprof` -- the ``torch.profiler`` bridge
  (``jaxprof`` in the reference): span annotations on the device
  timeline (``EngineConfig.trace_annotations``), whole-run capture
  (``serve --profile DIR``) and device-memory sampling.

``python -m repro_torch.obs summarize <trace.json>`` aggregates a saved
trace.
"""
from . import metrics, torchprof, trace  # noqa: F401
from .metrics import registry  # noqa: F401
from .trace import Span, Tracer, disable, enable, span, tracer  # noqa: F401

__all__ = ["trace", "metrics", "torchprof", "registry", "Span", "Tracer",
           "enable", "disable", "span", "tracer"]
