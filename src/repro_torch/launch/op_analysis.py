"""Census of one step traced on ``meta`` tensors.

The counterpart of ``repro/launch/hlo_analysis.py``. The JAX package
lowers a step to HLO and reads the text: dot FLOPs folded through its
loops, collective bytes, and ``count_eqns``, which counts a
``pallas_call`` as one equation. The port has no compiled module to
read, so :func:`analyze_step` runs the step once on ``meta`` tensors (no
data, no device work) and counts what the dispatcher sees:

* ``aten_ops`` and ``by_op``: every ATen op, by name;
* ``kernels``: each hand-written kernel call, counted as one op, with the
  operations and bytes its meta version reports
  (``kernels.registry.meta_launch``; the bound rules of ``PERF.md``
  section 6). The ATen ops inside a meta version (its outputs'
  allocation) are the call's, not ops of their own; ``ops`` is
  ``aten_ops`` plus the kernel calls;
* ``bytes_accessed``: the operands' and results' bytes of every ATen op
  that is not a view or an allocation, plus the kernels' analytic bytes
  (the counterpart of XLA's ``bytes accessed``: each op's traffic as if
  nothing stayed in a cache);
* ``flops``: the matmuls' and convolutions' FLOPs,
  ``torch.utils.flop_counter.FlopCounterMode``, backward included;
* ``collectives``: ops of the ``c10d`` namespaces, calls and result
  bytes by name (none on one device);
* ``memory``: the arguments' bytes (distinct storages), the outputs'
  (storages the arguments do not hold; ``alias_bytes`` those they do:
  tensors updated in place), and the peak of live bytes: each storage
  counted from the op that creates it until it is freed, the arguments'
  from the start, as are the ``state_bytes`` a step keeps between calls
  (the engine's visited words). ``temp_bytes`` is the peak less
  arguments, state and outputs.
"""
from __future__ import annotations

import contextlib
import time
import weakref
from collections import Counter
from typing import Any, Callable, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..kernels.registry import add_meta_listener, remove_meta_listener
from ..pytree import leaves

__all__ = ["analyze_step", "tensors_of", "COLLECTIVE_NAMESPACES"]

COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
# ATen ops that only allocate (no bytes moved)
_ALLOCATIONS = ("empty", "new_empty")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensors_of(obj: Any) -> Iterator[torch.Tensor]:
    """The tensors of a step's arguments or outputs: pytree leaves, and a
    module's parameters and buffers."""
    for leaf in leaves(obj):
        if isinstance(leaf, torch.Tensor):
            yield leaf
        elif isinstance(leaf, torch.nn.Module):
            yield from leaf.parameters()
            yield from leaf.buffers()


class _Live:
    """Live storage bytes, and their peak."""

    def __init__(self):
        self.cur = self.peak = 0
        self._held: dict = {}            # id(storage) -> bytes
        self._finalizers: list = []

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.cur += n
        self.peak = max(self.peak, self.cur)
        self._finalizers.append(weakref.finalize(st, self._free, key))

    def _free(self, key) -> None:
        self.cur -= self._held.pop(key)

    def close(self) -> None:
        for f in self._finalizers:
            f.detach()


class _Census(TorchDispatchMode):
    def __init__(self, live: _Live):
        super().__init__()
        self.live = live
        self.by_op: Counter = Counter()
        self.kernels: dict = {}
        self.collectives: dict = {}
        self.bytes = 0
        self._in_kernel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self._in_kernel:
            base = func.overloadpacket.__name__
            name = f"{func.namespace}.{base}"
            self.by_op[name] += 1
            if not func.is_view and not base.startswith(_ALLOCATIONS):
                self.bytes += sum(_nbytes(t) for t in tensors_of(
                    (args, kwargs or {}, out)))
            if func.namespace in COLLECTIVE_NAMESPACES:
                c = self.collectives.setdefault(name, {"calls": 0,
                                                       "bytes": 0})
                c["calls"] += 1
                c["bytes"] += sum(_nbytes(t) for t in tensors_of(out))
        for t in tensors_of(out):
            self.live.track(t)
        return out

    @contextlib.contextmanager
    def kernel(self, name: str, ops: float, nbytes: float):
        k = self.kernels.setdefault(name, {"calls": 0, "ops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["ops"] += float(ops)
        k["bytes"] += float(nbytes)
        self._in_kernel += 1
        try:
            yield
        finally:
            self._in_kernel -= 1


def _storages(tensors) -> dict:
    return {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in tensors}


def analyze_step(fn: Callable, args: tuple,
                 held: tuple = ()) -> tuple[dict, Any]:
    """Run ``fn(*args)`` once under the census; returns ``(record,
    outputs)``. The arguments are meant to be ``meta`` tensors (the dry
    run); on real ones the step runs and is counted the same way.
    ``held``: tensors the step keeps between calls (not arguments), live
    from the start (``state_bytes``)."""
    live = _Live()
    for t in tensors_of((args, held)):
        live.track(t)
    arg = _storages(tensors_of(args))
    census = _Census(live)
    add_meta_listener(census.kernel)
    t0 = time.perf_counter()
    try:
        with FlopCounterMode(display=False) as flops, census:
            out = fn(*args)
    finally:
        remove_meta_listener(census.kernel)
        live.close()
    t_trace = time.perf_counter() - t0
    outs = _storages(tensors_of(out))
    out_bytes = sum(n for k, n in outs.items() if k not in arg)
    alias = sum(n for k, n in outs.items() if k in arg)
    arg_bytes = sum(arg.values())
    state = sum(n for k, n in _storages(tensors_of(held)).items()
                if k not in arg)
    aten = sum(census.by_op.values())
    n_kernel = sum(k["calls"] for k in census.kernels.values())
    record = {
        "ops": aten + n_kernel, "aten_ops": aten,
        "by_op": dict(census.by_op.most_common()),
        "kernels": census.kernels,
        "kernel_ops": sum(k["ops"] for k in census.kernels.values()),
        "kernel_bytes": sum(k["bytes"] for k in census.kernels.values()),
        "bytes_accessed": census.bytes + sum(k["bytes"] for k in
                                             census.kernels.values()),
        "flops": float(flops.get_total_flops()),
        "collectives": census.collectives,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "alias_bytes": alias, "state_bytes": state,
                   "peak_live_bytes": live.peak,
                   "temp_bytes": max(live.peak - arg_bytes - out_bytes
                                     - state, 0)},
        "t_trace_s": t_trace,
    }
    return record, out
