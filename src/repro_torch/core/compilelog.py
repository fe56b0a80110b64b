"""Compile telemetry: a per-kernel-library compile recorder.

Counterpart of ``repro/core/compilelog.py``, with the same API and the
same definitions over the port's own compile layer. The port has no
``jit`` and no ``torch.compile``: what it compiles are its hand-written
CUDA kernels, one shared library per source (``kernels/build.py``,
``build.SOURCES`` and ``build.PROBES``). So here

* a **compile** is one kernel library made ready in this process, keyed
  by its source name: built by ``nvcc`` in ``build.build()``, or loaded
  from the build directory on first use (``build._cdll``). A library
  built and then loaded counts once;
* a **retrace** is a compile of a name that was already ready before the
  observation window opened -- a library file of the same source that
  is new to the process, e.g. after the source's hash changed mid-run.

The library of a source is loaded once per process and every later
launch reuses it, and no shape, value or bucket selects another library,
so a warm path of the port counts 0 compiles by construction. On the CPU
nothing is ever built or loaded (the plain versions run), so every count
is 0 there.

    recorder = enable()              # process-wide, idempotent
    snap = recorder.snapshot()
    ...run a batch...
    recorder.since(snap)             # {source name: new compiles}
    recorder.retraces_since(snap)    # compiles of already-ready sources

Mechanism: :meth:`CompileLog.install` adds :meth:`CompileLog.record` as a
hook of ``kernels/build.py``, which calls it with the source name each
time a library is made ready (not a ``logging.Handler``: nothing here is
logged). Libraries made ready before the recorder was installed are not
counted, as compiles before ``jax_log_compiles`` was set are not in the
reference.

The library cache is process-global, so the recorder is a process-global
singleton. Replica threads can load libraries concurrently, so
:meth:`CompileLog.record` takes a lock.
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Optional

from ..kernels import build

__all__ = ["CompileLog", "enable", "active"]


class CompileLog:
    """Process-wide per-library compile counter (a ``build`` hook)."""

    def __init__(self) -> None:
        self.counts: Counter = Counter()     # source name -> compiles
        self._installed = False
        self._lock = threading.Lock()

    # -- the build hook ------------------------------------------------
    def record(self, name: str) -> None:
        """One compile of source ``name`` (called by ``kernels/build.py``)."""
        with self._lock:
            self.counts[name] += 1

    # -- queries -------------------------------------------------------
    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def snapshot(self) -> dict[str, int]:
        """Copy of the per-library counters (an observation-window mark)."""
        with self._lock:
            return dict(self.counts)

    def since(self, snapshot: dict[str, int]) -> dict[str, int]:
        """Per-library compiles since ``snapshot`` (only non-zero entries)."""
        out = {}
        for name, c in self.snapshot().items():
            d = c - snapshot.get(name, 0)
            if d > 0:
                out[name] = d
        return out

    def compiles_since(self, snapshot: dict[str, int]) -> int:
        return sum(self.since(snapshot).values())

    def retraces_since(self, snapshot: dict[str, int]) -> int:
        """Compiles of libraries that were already ready before the
        snapshot -- the warm-serving regressions, as opposed to first-time
        (cold) compiles of libraries the window introduced."""
        return sum(c for name, c in self.since(snapshot).items()
                   if snapshot.get(name, 0) > 0)

    def annotate(self, stats: dict, snapshot: dict[str, int]) -> dict:
        """Write the standard telemetry fields for one observation window
        into ``stats`` (engine run reports, delta reports, batch logs)."""
        new = self.since(snapshot)
        stats["n_compiles"] = sum(new.values())
        stats["n_retraces"] = sum(c for name, c in new.items()
                                  if snapshot.get(name, 0) > 0)
        stats["compiled_kernels"] = new
        return stats

    # -- install -------------------------------------------------------
    def install(self) -> "CompileLog":
        if not self._installed:
            build.add_compile_hook(self.record)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            build.remove_compile_hook(self.record)
            self._installed = False


_RECORDER: Optional[CompileLog] = None


def enable() -> CompileLog:
    """Install (or return the already-installed) process-wide recorder.

    Counters are cumulative for the process lifetime -- consumers take
    snapshots and diff, they never reset, so any number of engines and
    tests can share the singleton without clobbering each other.
    """
    global _RECORDER
    if _RECORDER is None:
        _RECORDER = CompileLog()
    return _RECORDER.install()


def active() -> Optional[CompileLog]:
    """The installed recorder, or None when telemetry is off."""
    return _RECORDER if (_RECORDER is not None and _RECORDER._installed) \
        else None
