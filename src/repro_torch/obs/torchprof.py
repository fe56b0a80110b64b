"""``torch.profiler`` integration for :mod:`repro_torch.obs`.

Counterpart of ``repro/obs/jaxprof.py``, with its functions under the
same names. Three capabilities:

* **Span annotations on the device timeline** -- :func:`attach` installs
  ``torch.profiler.record_function`` as a tracer's annotator, so every
  host span is also a named range of a profiler window, lining host
  stages up against the device timeline. Each kernel's CUDA runtime call
  (the port's own, launched through ``ctypes``, included) carries its
  thread and time in the trace, so the kernels a span launches can be
  charged to it, a replica thread's to that replica's spans
  (``chip_smoke.py``'s phase ``obs`` does).
  ``trace.enable(annotate=True)`` (``EngineConfig.trace_annotations``)
  does this for the process tracer.
* **Whole-run capture** -- :func:`start_trace` / :func:`stop_trace` (or
  the :func:`profile_run` context manager) bracket a run with a
  ``torch.profiler.profile`` window: CPU activity, plus CUDA activity
  when the device is a card. Stopping writes a Chrome trace
  (``torchprof_<pid>.trace.json``, chrome://tracing and Perfetto open it)
  into the log directory; ``serve --profile DIR`` wires this around the
  streaming loop.
* **Device-memory sampling** -- :func:`sample_device_memory` reads the
  CUDA caching allocator's ``allocated_bytes.all.current`` of each card
  into the ``device_bytes_in_use`` gauge (labelled per device), and
  :func:`save_memory_profile` writes the allocator's snapshot (a pickle
  that ``torch.cuda.memory``'s viewer reads) for offline digging.

Where the reference degrades to a no-op for a missing ``jax.profiler``,
this module does so only for a condition that is really absent: the
memory functions return ``None`` / ``False`` on a machine without a CUDA
device. A profiler that fails to start raises; it is never reported as
"no profiler".
"""
from __future__ import annotations

import contextlib
import os
import pickle
from pathlib import Path
from typing import Optional, Union

import torch

from . import metrics as _metrics
from . import trace as _trace

__all__ = ["available", "annotation", "annotation_factory", "attach",
           "detach", "start_trace", "stop_trace", "profile_run",
           "sample_device_memory", "save_memory_profile"]

# the running whole-run window: (profile, log directory), or None
_ACTIVE: Optional[tuple] = None


def available() -> bool:
    """True when ``torch.profiler`` can be used (it ships with torch)."""
    return hasattr(torch, "profiler") and \
        hasattr(torch.profiler, "record_function")


def annotation_factory():
    """The ``name -> context manager`` factory for span annotation:
    ``torch.profiler.record_function``."""
    return torch.profiler.record_function


def annotation(name: str):
    """A single named annotation context (convenience wrapper)."""
    return annotation_factory()(name)


def attach(tracer: Optional[_trace.Tracer] = None) -> _trace.Tracer:
    """Install the annotation factory on ``tracer`` (default: the process
    tracer), so recorded spans also appear on profiler timelines."""
    tr = tracer if tracer is not None else _trace.tracer()
    tr.annotator = annotation_factory()
    return tr


def detach(tracer: Optional[_trace.Tracer] = None) -> _trace.Tracer:
    tr = tracer if tracer is not None else _trace.tracer()
    tr.annotator = None
    return tr


def _activities(device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    on_card = torch.cuda.is_available() if device is None \
        else torch.device(device).type == "cuda"
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_trace(logdir: Union[str, os.PathLike], *,
                device: Union[torch.device, str, None] = None
                ) -> torch.profiler.profile:
    """Start a ``torch.profiler`` window whose Chrome trace
    :func:`stop_trace` writes into ``logdir``.

    device : the device of the profiled work; CUDA activity is traced
        when it is a card (``None``: when this machine has one).
    Returns the running profile. Raises ``RuntimeError`` if a window is
    already open; a profiler that fails to start raises too.
    """
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a torchprof trace is already running; "
                           "stop_trace() it first")
    prof = torch.profiler.profile(activities=_activities(device))
    prof.__enter__()
    _ACTIVE = (prof, Path(logdir))
    return prof


def stop_trace() -> Optional[Path]:
    """Stop the running window and write its Chrome trace; returns the
    file written (``None`` when no window was running)."""
    global _ACTIVE
    if _ACTIVE is None:
        return None
    prof, logdir = _ACTIVE
    _ACTIVE = None
    prof.__exit__(None, None, None)
    logdir.mkdir(parents=True, exist_ok=True)
    path = logdir / f"torchprof_{os.getpid()}.trace.json"
    prof.export_chrome_trace(str(path))
    return path


@contextlib.contextmanager
def profile_run(logdir: Union[str, os.PathLike, None], *,
                device: Union[torch.device, str, None] = None):
    """Bracket a block with start/stop_trace when ``logdir`` is set;
    yields the running ``torch.profiler.profile`` (``None`` without a
    ``logdir``), whose events stay readable after the block."""
    prof = start_trace(logdir, device=device) if logdir else None
    try:
        yield prof
    finally:
        if prof is not None:
            stop_trace()


def sample_device_memory(reg: Optional[_metrics.MetricsRegistry] = None
                         ) -> Optional[int]:
    """Sample each card's allocated bytes (the caching allocator's
    ``allocated_bytes.all.current``) into ``device_bytes_in_use`` gauges.

    Returns the total bytes across cards, or ``None`` on a machine with
    no CUDA device.
    """
    if not torch.cuda.is_available():
        return None
    reg = reg if reg is not None else _metrics.registry()
    total = 0
    for i in range(torch.cuda.device_count()):
        used = int(torch.cuda.memory_stats(i).get(
            "allocated_bytes.all.current", 0))
        reg.gauge("device_bytes_in_use", device=f"cuda:{i}").set(used)
        total += used
    return total


def save_memory_profile(path: Union[str, os.PathLike]) -> bool:
    """Write the CUDA caching allocator's snapshot (segments, blocks and,
    where allocation history is being recorded, its stack traces) to
    ``path``; ``False`` on a machine with no CUDA device."""
    if not torch.cuda.is_available():
        return False
    snapshot = torch.cuda.memory._snapshot()
    with open(path, "wb") as f:
        pickle.dump(snapshot, f)
    return True
