"""repro_torch.obs -- runtime observability of the port.

Only :mod:`repro_torch.obs.metrics`, the process-wide registry of
counters, gauges and histograms, is ported so far (the cache's hit/miss/
eviction counters, ``routed_*``, ``engine_batch_wall_s`` and
``query_latency_s``); span tracing comes with a later slice.
"""
from . import metrics  # noqa: F401
from .metrics import registry  # noqa: F401

__all__ = ["metrics", "registry"]
