"""Process-wide metrics registry: counters, gauges, log-bucketed histograms.

A copy of ``repro/obs/metrics.py`` (stdlib only). The compile log is not
ported, so the references to it below describe the reference package.

Spans (:mod:`repro_torch.obs.trace`) answer "where did *this* run spend its
wall"; metrics answer the fleet questions — cache hit ratio over the last
thousand batches, p99 end-to-end query latency, bytes resident per cache.
The registry is deliberately tiny and stdlib-only:

* metrics are keyed by ``(name, labels)`` where labels are plain kwargs
  (``histogram("query_e2e_s", planner="hybrid", tenant="t0")``) —
  get-or-create, so instrumentation sites never need registration
  boilerplate;
* histograms use geometric (log-spaced) buckets, ~19% relative width,
  covering 1µs .. ~4000s — constant memory per histogram regardless of
  sample count, with p50/p95/p99/p99.9 readout interpolated inside the
  winning bucket and clamped to the observed min/max;
* :meth:`MetricsRegistry.snapshot` / :meth:`~MetricsRegistry.since`
  mirror :mod:`repro.core.compilelog`: take a snapshot, run a workload,
  and ``since(snap)`` gives the deltas for just that window — that is how
  tests isolate one engine's cache traffic from another's on the shared
  process registry;
* :meth:`MetricsRegistry.render` dumps a Prometheus-style plain-text
  exposition (``# TYPE`` comments, ``name{label="v"} value`` lines,
  ``_count``/``_sum``/``{quantile=...}`` for histograms) for scraping or
  eyeballing.

Like the tracer and the compile log, the default registry is a process
singleton (:func:`registry`). Instruments are cheap enough to update
unconditionally (a counter ``inc`` is one float add), so there is no
enable/disable gate — the readout is simply empty until something runs.
"""
from __future__ import annotations

import bisect
import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "registry", "DEFAULT_QUANTILES"]

DEFAULT_QUANTILES = (0.5, 0.95, 0.99, 0.999)

# Geometric bucket grid shared by every histogram: 1µs lower edge,
# factor 2**(1/4) (~+19%/bucket), enough buckets to pass ~4200s.
_BUCKET_LO = 1e-6
_BUCKET_FACTOR = 2.0 ** 0.25
_N_BUCKETS = 128
_BOUNDS = tuple(_BUCKET_LO * _BUCKET_FACTOR ** i for i in range(_N_BUCKETS))


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class Counter:
    """Monotonic counter (float, so it can also accumulate bytes/seconds)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value (e.g. resident cache bytes)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Log-bucketed histogram over positive samples (latencies, sizes).

    Samples below the first bucket edge land in bucket 0; above the last
    edge, in the overflow bucket. Quantiles interpolate within the
    winning bucket's geometric span and are clamped to the observed
    min/max, so small-sample readouts stay inside the data range.
    """

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self):
        self.counts = [0] * (_N_BUCKETS + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, x: float) -> None:
        x = float(x)
        self.counts[bisect.bisect_right(_BOUNDS, x) if x > 0 else 0] += 1
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x

    def quantile(self, q: float) -> float:
        return _quantile_from_counts(self.counts, self.count, q,
                                     self.min, self.max)

    def quantiles(self, qs=DEFAULT_QUANTILES) -> dict:
        return {q: self.quantile(q) for q in qs}

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


def _quantile_from_counts(counts, total: int, q: float,
                          lo_clamp: float, hi_clamp: float) -> float:
    """Quantile readout from bucket counts (shared with window views)."""
    if total <= 0:
        return 0.0
    rank = q * (total - 1)
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c > rank:
            # interpolate within this bucket's geometric span
            lo = _BOUNDS[i - 1] if 0 < i <= _N_BUCKETS else 0.0
            hi = _BOUNDS[i] if i < _N_BUCKETS else _BOUNDS[-1] * _BUCKET_FACTOR
            frac = (rank - cum) / c
            val = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            return min(max(val, lo_clamp), hi_clamp)
        cum += c
    return hi_clamp


class _HistogramWindow:
    """Delta view of a histogram between two snapshots (quantiles over
    just the window's samples)."""

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self, counts, count, total, mn, mx):
        self.counts = counts
        self.count = count
        self.sum = total
        self.min = mn
        self.max = mx

    def quantile(self, q: float) -> float:
        return _quantile_from_counts(self.counts, self.count, q,
                                     self.min, self.max)

    def quantiles(self, qs=DEFAULT_QUANTILES) -> dict:
        return {q: self.quantile(q) for q in qs}

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Get-or-create store of labeled instruments + snapshot/diff/render."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}        # (kind, name, labels) -> instrument

    def _get(self, kind: str, cls, name: str, labels: dict):
        key = (kind, name, _labels_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(key, cls())
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", Histogram, name, labels)

    def collect(self, name: str) -> dict[tuple, object]:
        """Every instrument registered under ``name``, keyed by its label
        tuple (``(("tenant", "gold"),)`` → instrument). How a readout
        walks one metric family across label values — e.g. the per-tenant
        ``serve_admission_wait_s`` histograms — without knowing the label
        set up front."""
        return {key[2]: m for key, m in list(self._metrics.items())
                if key[1] == name}

    # -- snapshot / since (the compilelog pattern) ----------------------
    def snapshot(self) -> dict:
        """Immutable copy of all instrument states, for later ``since``."""
        snap = {}
        for key, m in list(self._metrics.items()):
            kind = key[0]
            if kind == "histogram":
                snap[key] = (tuple(m.counts), m.count, m.sum, m.min, m.max)
            else:
                snap[key] = m.value
        return snap

    def since(self, snap: dict) -> dict:
        """Window deltas vs. a snapshot.

        Counters/gauges map to value deltas; histograms map to
        :class:`_HistogramWindow` objects whose quantiles cover only the
        samples recorded after the snapshot.
        """
        out = {}
        for key, m in list(self._metrics.items()):
            kind, name, labels = key
            if kind == "histogram":
                c0, n0, s0, mn0, mx0 = snap.get(
                    key, ((0,) * len(m.counts), 0, 0.0, math.inf, -math.inf))
                dcounts = [a - b for a, b in zip(m.counts, c0)]
                dn = m.count - n0
                if dn <= 0:
                    continue
                # window min/max are not tracked incrementally; use the
                # lifetime bounds as conservative clamps
                out[(name, labels)] = _HistogramWindow(
                    dcounts, dn, m.sum - s0, m.min, m.max)
            else:
                d = m.value - snap.get(key, 0.0)
                if d != 0.0:
                    out[(name, labels)] = d
        return out

    # -- exposition -----------------------------------------------------
    def render(self, quantiles=DEFAULT_QUANTILES) -> str:
        """Prometheus-style plain-text dump of every instrument."""
        lines = []
        typed = set()
        for key in sorted(self._metrics, key=lambda k: (k[1], k[2], k[0])):
            kind, name, labels = key
            m = self._metrics[key]
            if name not in typed:
                lines.append(f"# TYPE {name} {kind}")
                typed.add(name)
            if kind == "histogram":
                lines.append(f"{name}_count{_fmt(labels)} {m.count}")
                lines.append(f"{name}_sum{_fmt(labels)} {_num(m.sum)}")
                for q in quantiles:
                    ql = labels + (("quantile", repr(q)),)
                    lines.append(f"{name}{_fmt(ql)} {_num(m.quantile(q))}")
            else:
                lines.append(f"{name}{_fmt(labels)} {_num(m.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


def _fmt(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


def _num(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() and abs(v) < 1e15 else repr(v)


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide metrics registry."""
    return _REGISTRY
