"""Hierarchical runtime span tracer (zero-dependency layer of
``repro_torch.obs``).

A copy of ``repro/obs/trace.py`` with two differences: a fenced span
synchronizes the CUDA device of each fenced tensor (CPU tensors need no
fence), and ``enable(annotate=True)`` installs the ``torch.profiler``
bridge (``repro_torch.obs.torchprof``) where the reference installs
``jaxprof``'s.

The engine's batch-sharing claims are per-stage claims — detection,
clustering, cache hits, per-level MS-BFS, joins, assembly each get
shorter when sharing works — so wall time must be attributable per stage.
This module provides the one timing primitive every hot module uses:

    with tracer().span("enumerate.level", level=3) as sp:
        out = expand_level(...)
    stats["t_level"] = sp.duration

Design points:

* **Always-on timing, opt-in recording.** A ``Span`` handle measures its
  duration whether or not tracing is enabled, so the engine's
  backward-compatible ``t_*`` stats are *derived views over spans* — one
  start/stop site, no duplicated ``perf_counter`` bookkeeping. Only when
  the tracer is enabled does the finished span land in the ring buffer
  (bounded memory; old spans are dropped, never the run).
* **Thread-aware nesting.** The span stack is thread-local, so replica
  worker threads (``distributed.ShardedExecutor``) produce their own
  root-level spans while the admission thread keeps its hierarchy; the
  ring buffer itself is shared (appends are atomic under the GIL).
* **Optional device fencing.** Asynchronous launches mean a span can
  close before the device work it launched finishes. ``Span.fence(value)``
  marks tensors (or nested lists, tuples and dicts of them) whose CUDA
  device is synchronized at span exit *when the tracer was enabled with*
  ``fence=True``. (The engine's stage spans synchronize at exit whether
  traced or not, so their ``t_*`` stats measure completed work.) torch is
  imported only on the first fenced exit, keeping this module importable
  with no third-party dependency.
* **Profiler annotations.** A tracer's ``annotator`` (``name -> context
  manager``), when set and the tracer enabled, is entered for each span's
  lifetime: ``torchprof.attach`` / ``enable(annotate=True)`` install
  ``torch.profiler.record_function``, so every span is also a named range
  of a profiler window, and the kernels launched inside it are correlated
  to it on the device timeline. Without an annotator a span costs what it
  did before (one attribute read more).
* **Chrome-trace export.** :meth:`Tracer.export` writes the standard
  ``traceEvents`` JSON that chrome://tracing and https://ui.perfetto.dev
  open directly; :func:`summarize` / :func:`coverage` aggregate a saved
  trace (also exposed via ``python -m repro_torch.obs``).

The default tracer is a process-wide singleton: ``EngineConfig.trace`` /
``PathSession(trace=True)`` / ``serve --trace`` all enable the same
recorder, so one export covers every engine and replica in the process.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

__all__ = ["Span", "Tracer", "tracer", "enable", "disable", "span",
           "summarize", "coverage", "load"]

_DEFAULT_CAPACITY = 1 << 16
_KEEP = object()          # configure() sentinel: leave annotator as-is


class Span:
    """One timed region: context-manager handle *and* finished record.

    ``duration`` is valid after exit; ``elapsed`` gives a mid-span
    reading (used for early-return stats). Attributes set at creation or
    via :meth:`set` ride into the exported trace's ``args``.
    """

    __slots__ = ("name", "attrs", "t0", "t1", "tid", "depth",
                 "_tracer", "_fence", "_ann")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._tracer = tracer
        self.t0 = 0.0
        self.t1 = 0.0
        self.tid = 0
        self.depth = 0
        self._fence: Any = None
        self._ann = None

    # -- context manager ----------------------------------------------
    def __enter__(self) -> "Span":
        tr = self._tracer
        stack = tr._stack()
        self.depth = len(stack)
        self.tid = threading.get_ident()
        stack.append(self)
        ann = tr.annotator
        if ann is not None and tr.enabled:
            self._ann = ann(self.name)
            self._ann.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        tr = self._tracer
        if self._fence is not None and tr.fence:
            tr._block(self._fence)
        self.t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
            self._ann = None
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:            # exception skipped inner exits
            del stack[stack.index(self):]
        if tr.enabled:
            if exc_type is not None:
                self.attrs = dict(self.attrs, error=exc_type.__name__)
            tr._record(self)

    # -- API -----------------------------------------------------------
    @property
    def duration(self) -> float:
        """Seconds between enter and exit (0.0 while still open)."""
        return max(self.t1 - self.t0, 0.0)

    @property
    def elapsed(self) -> float:
        """Seconds since enter, readable mid-span (early returns)."""
        return time.perf_counter() - self.t0

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attributes after creation (e.g. a hit flag
        known only once the work ran)."""
        self.attrs = dict(self.attrs, **attrs)
        return self

    def fence(self, value) -> "Span":
        """Mark ``value`` (array/pytree) to block on at exit when the
        tracer runs with ``fence=True``; a no-op otherwise."""
        self._fence = value
        return self


class Tracer:
    """Ring-buffered span recorder with thread-local span stacks."""

    def __init__(self, enabled: bool = False,
                 capacity: int = _DEFAULT_CAPACITY,
                 fence: bool = False,
                 annotator: Optional[Callable[[str], Any]] = None):
        self.enabled = enabled
        self.fence = fence
        # annotator: name -> context manager entered for the span's
        # lifetime (torchprof.attach installs torch.profiler's
        # record_function so host spans also appear on the device timeline)
        self.annotator = annotator
        self._buf: deque = deque(maxlen=int(capacity))
        self._local = threading.local()
        self.t_origin = time.perf_counter()

    # -- span creation -------------------------------------------------
    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, sp: Span) -> None:
        self._buf.append(sp)

    def _block(self, value) -> None:
        """Synchronize every CUDA device that holds a fenced tensor."""
        devices = _cuda_devices(value, set())
        if devices:
            import torch
            for dev in devices:
                torch.cuda.synchronize(dev)

    # -- lifecycle -----------------------------------------------------
    def configure(self, *, enabled: Optional[bool] = None,
                  fence: Optional[bool] = None,
                  capacity: Optional[int] = None,
                  annotator=_KEEP) -> "Tracer":
        if enabled is not None:
            self.enabled = enabled
        if fence is not None:
            self.fence = fence
        if capacity is not None and capacity != self._buf.maxlen:
            self._buf = deque(self._buf, maxlen=int(capacity))
        if annotator is not _KEEP:
            self.annotator = annotator
        return self

    def reset(self) -> "Tracer":
        """Drop recorded spans and re-zero the export time origin."""
        self._buf.clear()
        self.t_origin = time.perf_counter()
        return self

    # -- queries / export ----------------------------------------------
    def __len__(self) -> int:
        return len(self._buf)

    def spans(self) -> list[Span]:
        """Finished spans, oldest first (a snapshot copy)."""
        return list(self._buf)

    def to_chrome(self) -> dict:
        """Chrome-trace ``traceEvents`` dict (complete 'X' events in
        microseconds; opens in chrome://tracing and Perfetto)."""
        pid = os.getpid()
        events = []
        tids = {}
        for sp in self._buf:
            events.append({
                "name": sp.name, "ph": "X", "pid": pid, "tid": sp.tid,
                "ts": (sp.t0 - self.t_origin) * 1e6,
                "dur": (sp.t1 - sp.t0) * 1e6,
                "cat": sp.name.split(".", 1)[0],
                "args": {**{k: _jsonable(v) for k, v in sp.attrs.items()},
                         "depth": sp.depth},
            })
            tids.setdefault(sp.tid, len(tids))
        for tid, i in tids.items():
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid,
                           "args": {"name": f"hcsp-{i}" if i else "main"}})
        return {"displayTimeUnit": "ms", "traceEvents": events}

    def export(self, path) -> dict:
        """Write the Chrome-trace JSON to ``path``; returns the dict."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of the tensors in ``value`` (a tensor, or nested
    lists, tuples and dicts of them); CPU tensors and other objects add
    none."""
    if isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    else:
        dev = getattr(value, "device", None)
        if getattr(dev, "type", None) == "cuda":
            out.add(dev)
    return out


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# ----------------------------------------------------------------------
# saved-trace analysis (shared by the CLI and the CI obs gate)
# ----------------------------------------------------------------------
def load(path) -> dict:
    with open(path) as f:
        return json.load(f)


def _complete_events(doc: dict) -> list[dict]:
    return [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]


def summarize(doc: dict) -> list[dict]:
    """Aggregate a Chrome-trace dict per span name: count, total/mean/max
    duration (ms), sorted by total descending."""
    agg: dict[str, list] = {}
    for e in _complete_events(doc):
        a = agg.setdefault(e["name"], [0, 0.0, 0.0])
        a[0] += 1
        a[1] += e.get("dur", 0.0)
        a[2] = max(a[2], e.get("dur", 0.0))
    rows = [{"name": name, "count": c, "total_ms": tot / 1e3,
             "mean_ms": tot / max(c, 1) / 1e3, "max_ms": mx / 1e3}
            for name, (c, tot, mx) in agg.items()]
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def coverage(doc: dict, root: str = "engine.run",
             occurrence: int = -1) -> float:
    """Fraction of a root span's wall covered by its direct children.

    Picks the ``occurrence``-th event named ``root`` (default: last, i.e.
    the warm run), then sums the durations of same-thread events one
    level deeper that fall inside its interval. This is the acceptance
    metric: per-stage durations must explain >= 90% of the batch wall,
    or the span taxonomy has a hole.
    """
    events = _complete_events(doc)
    roots = [e for e in events if e["name"] == root]
    if not roots:
        return 0.0
    r = sorted(roots, key=lambda e: e["ts"])[occurrence]
    r_depth = r.get("args", {}).get("depth", 0)
    lo, hi = r["ts"], r["ts"] + r.get("dur", 0.0)
    child = sum(
        e.get("dur", 0.0) for e in events
        if e is not r and e["tid"] == r["tid"]
        and e.get("args", {}).get("depth") == r_depth + 1
        and lo <= e["ts"] and e["ts"] + e.get("dur", 0.0) <= hi + 1.0)
    return min(child / r["dur"], 1.0) if r.get("dur") else 0.0


def stage_names(doc: dict) -> set:
    return {e["name"] for e in _complete_events(doc)}


# ----------------------------------------------------------------------
# the process-wide default tracer
# ----------------------------------------------------------------------
_TRACER = Tracer(enabled=False)


def tracer() -> Tracer:
    """The process-wide tracer (disabled until :func:`enable`)."""
    return _TRACER


def span(name: str, **attrs) -> Span:
    """Convenience: a span on the process-wide tracer (for modules that
    have no engine handle, e.g. the lazy host transfer in ``query.py``)."""
    return _TRACER.span(name, **attrs)


def enable(*, fence: bool = False, annotate: bool = False,
           capacity: Optional[int] = None) -> Tracer:
    """Enable (and return) the process-wide tracer.

    fence : synchronize the CUDA devices of fenced tensors at span exit
        (attribute device work to the launching span; costs overlap).
    annotate : wrap each span in a ``torch.profiler.record_function`` so
        spans show up on the timeline of a ``torch.profiler`` window (and
        its device kernels are correlated to them); False removes the
        annotator.
    Idempotent; repeated calls reconfigure the same singleton.
    """
    ann = _TRACER.annotator
    if annotate:
        from . import torchprof
        ann = torchprof.annotation_factory()
    elif annotate is False:
        ann = None
    _TRACER.enabled = True
    _TRACER.fence = bool(fence)
    _TRACER.annotator = ann
    if capacity is not None:
        _TRACER.configure(capacity=capacity)
    return _TRACER


def disable() -> Tracer:
    """Stop recording (span handles keep timing; nothing is stored)."""
    _TRACER.enabled = False
    return _TRACER
