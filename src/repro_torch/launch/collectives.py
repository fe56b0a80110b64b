"""Collectives over an axis of a layout of device slots: the counterparts
of ``jax.lax.psum`` / ``pmax`` / ``ppermute`` / ``all_gather`` inside a
``jax.shard_map``.

A program over a layout (``launch/mesh.py``) is single-controller, as a
``shard_map`` is: the caller holds one tensor per slot, in a list indexed
by slot, each on that slot's device. :func:`run_slots` runs a function
for each slot on the slot's CUDA stream (slot 0 on the caller's current
stream, slot j on :func:`_replica_stream`, the executor's stream of
replica j, so that a card repeated in the list runs its slots side by
side); the collectives take and return such lists.

Ordering and lifetimes. Every call is a fan-out and a gather: each slot's
stream first waits on the caller's stream, and the caller's stream waits
on every slot's event before the call returns. A tensor a slot made is
therefore complete, in the caller's stream order, before any later call
reads it, and a block freed afterwards is reused only by work ordered
after every read of it: a block made on a slot's stream returns to that
stream's pool, and the slot's next work waits on the caller first; a
block made on the caller's stream is reused by caller work that waited on
every slot (the argument of ``core/distributed.py``'s fan-out, which
needs no ``record_stream``). On the CPU the slots run one after another.

Reductions (:func:`psum`, :func:`pmax`, :func:`reduce_scatter`) run on
each group's first slot and take the members in slot order, ``((x0 + x1)
+ x2) + ...``: the result is deterministic and, on one device, bit-equal
to the same fold over a Python list. Every member receives the result (or
its block of it, :func:`reduce_scatter`): the first's tensor itself (a
view of it) where its device is the first's, a copy on its stream
otherwise.
:func:`ppermute` copies each sender's tensor into a receive buffer on the
receiver's stream, also between two slots of one card, so that a ring's
traffic is paid and measured as it would be across cards.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional, Sequence, Union

import torch

from .mesh import Layout

__all__ = ["run_slots", "psum", "pmax", "ppermute", "all_gather",
           "reduce_scatter", "slot_streams"]

Axes = Union[str, Sequence[str]]

_STREAMS: dict = {}


def _replica_stream(device: torch.device, ri: int):
    """The CUDA stream of replica (slot) ``ri`` on ``device``: made once
    per process and shared by every executor's replica ``ri`` and every
    layout's slot ``ri`` there. The caching allocator keeps a freed block
    for reuse on the stream it was allocated on only, so a fresh stream
    for each executor would strand the blocks of every earlier one on
    streams no one uses again."""
    key = (device, ri)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device)
    return _STREAMS[key]


@contextlib.contextmanager
def _slot_stream(device: torch.device, stream, caller):
    """Run a slot on ``stream`` (``None``: the device's current stream),
    ordered after the caller's stream; yields the stream, or ``None`` on
    the CPU."""
    if device.type != "cuda":
        yield None
        return
    with torch.cuda.device(device):
        s = torch.cuda.current_stream(device) if stream is None else stream
        if s != caller:
            s.wait_stream(caller)
        with torch.cuda.stream(s):
            yield s


def slot_streams(devices) -> list:
    """The CUDA stream of each slot of a device list: ``None`` (the
    caller's current stream) for slot 0 and for CPU slots,
    :func:`_replica_stream` for the others."""
    return [None if s == 0 or d.type != "cuda" else _replica_stream(d, s)
            for s, d in enumerate(devices)]


def run_slots(layout: Layout, fn: Callable[[int], object],
              slots: Optional[Sequence[int]] = None) -> list:
    """``[fn(s) for s in slots]`` (default every slot), each call on slot
    ``s``'s stream with its device current, ordered after the caller's
    stream; the caller's stream waits on each slot's end."""
    slots = range(layout.size) if slots is None else slots
    first = layout.device(0)
    caller = (torch.cuda.current_stream(first) if first.type == "cuda"
              else None)
    streams = slot_streams([layout.device(i) for i in range(layout.size)])
    outs, done = [], []
    for s in slots:
        with _slot_stream(layout.device(s), streams[s], caller) as st:
            outs.append(fn(s))
            if st is not None and st != caller:
                done.append(st.record_event())
    for ev in done:
        caller.wait_event(ev)
    return outs


def _check(xs: Sequence[torch.Tensor], layout: Layout, what: str) -> None:
    if len(xs) != layout.size:
        raise ValueError(f"{what}: one tensor per slot, {layout.size} "
                         f"slots, got {len(xs)}")


def _to(x, device: torch.device):
    """A tensor, or a tuple of tensors, on ``device``."""
    if isinstance(x, tuple):
        return tuple(t.to(device) for t in x)
    return x.to(device)


def _device_of(x) -> torch.device:
    return (x[0] if isinstance(x, tuple) else x).device


def _share(layout: Layout, groups: list, results: list) -> list:
    """Every member of group i receives ``results[i]`` (a tensor or a
    tuple of them): itself on the result's device, a copy on the member's
    stream elsewhere."""
    out = [None] * layout.size
    copy = []
    for g, r in zip(groups, results):
        for s in g:
            if layout.device(s) == _device_of(r):
                out[s] = r
            else:
                copy.append((s, r))
    if copy:
        src = dict(copy)
        got = run_slots(layout, lambda s: _to(src[s], layout.device(s)),
                        [s for s, _ in copy])
        for (s, _), x in zip(copy, got):
            out[s] = x
    return out


def _reduce(xs, layout: Layout, axes: Axes, op, what: str,
            share: bool = True) -> list:
    """Each group's fold in slot order on its first slot; shared with
    every member (``share``), else one result a group, in group order."""
    _check(xs, layout, what)
    groups = layout.groups(axes)
    by_first = {g[0]: g for g in groups}

    def fold(s):
        dev = layout.device(s)
        g = by_first[s]
        return functools.reduce(op, (xs[j].to(dev) for j in g[1:]), xs[g[0]])

    folds = run_slots(layout, fold, list(by_first))
    return _share(layout, groups, folds) if share else folds


def psum(xs: Sequence[torch.Tensor], layout: Layout, axes: Axes) -> list:
    """``jax.lax.psum`` over ``axes``: each slot receives the sum of its
    group's tensors, added in slot order on the group's first slot."""
    return _reduce(xs, layout, axes, torch.add, "psum")


def pmax(xs: Sequence[torch.Tensor], layout: Layout, axes: Axes) -> list:
    """``jax.lax.pmax`` over ``axes`` (elementwise, NaN-propagating as
    ``torch.maximum``)."""
    return _reduce(xs, layout, axes, torch.maximum, "pmax")


def all_gather(xs: Sequence, layout: Layout, axes: Axes,
               dim: Union[int, Sequence[int]] = 0,
               select: Optional[Callable[[int, torch.Tensor],
                                         torch.Tensor]] = None) -> list:
    """``jax.lax.all_gather(..., tiled=True)`` over ``axes``: each slot
    receives its group's tensors concatenated along ``dim`` (any
    dimension, negative counted from the end) in the order of
    :meth:`Layout.axis_index`.

    A slot's entry may be a tuple of tensors, each gathered along its own
    dimension (``dim`` then one a tensor) in the same pass over the
    slots; the slot then receives a tuple. ``select(s, x)``: the part of
    a member's tensor ``x`` that slot ``s`` receives (e.g. its heads of a
    cache piece); each slot then gathers its own parts on its stream,
    where without it each group gathers once, on its first slot."""
    _check(xs, layout, "all_gather")
    many = isinstance(xs[0], tuple)
    dims = tuple(dim) if many and not isinstance(dim, int) else \
        (dim,) * len(xs[0]) if many else (dim,)
    take = (lambda s, x: x) if select is None else select

    def cat(s, members):
        dev = layout.device(s)
        parts = [xs[j] if many else (xs[j],) for j in members]
        out = tuple(torch.cat([take(s, p[i]).to(dev) for p in parts], d)
                    for i, d in enumerate(dims))
        return out if many else out[0]

    groups = layout.groups(axes)
    if select is not None:
        group_of = {s: g for g in groups for s in g}
        return run_slots(layout, lambda s: cat(s, group_of[s]))
    by_first = {g[0]: g for g in groups}
    return _share(layout, groups, run_slots(
        layout, lambda s: cat(s, by_first[s]), list(by_first)))


def reduce_scatter(xs: Sequence[torch.Tensor], layout: Layout, axes: Axes,
                   dim: int = 0) -> list:
    """``jax.lax.psum_scatter(..., tiled=True)`` over ``axes``: the group's
    sum, folded in slot order on its first slot as :func:`psum` folds it,
    cut along ``dim`` into as many equal blocks as the group has members;
    the member at position ``i`` along ``axes`` receives block ``i`` (a
    view of the sum on the first slot's device, a copy on its stream
    elsewhere). Each block is bit-equal to the same block of
    :func:`psum`'s result."""
    _check(xs, layout, "reduce_scatter")
    groups = layout.groups(axes)
    n = len(groups[0])
    if xs[0].shape[dim] % n:
        raise ValueError(f"reduce_scatter: dimension {dim} of size "
                         f"{xs[0].shape[dim]} does not split into {n} "
                         f"blocks")
    sums = _reduce(xs, layout, axes, torch.add, "reduce_scatter",
                   share=False)
    size = xs[0].shape[dim] // n
    out = [None] * layout.size
    copy = {}
    for g, total in zip(groups, sums):
        for i, s in enumerate(g):
            block = total.narrow(dim, i * size, size)
            if layout.device(s) == total.device:
                out[s] = block
            else:
                copy[s] = block
    if copy:
        got = run_slots(layout, lambda s: copy[s].to(layout.device(s)),
                        list(copy))
        for s, x in zip(copy, got):
            out[s] = x
    return out


def ppermute(xs: Sequence[torch.Tensor], layout: Layout, axes: Axes,
             perm: Sequence[tuple]) -> list:
    """``jax.lax.ppermute`` over ``axes``: ``perm`` holds ``(i, j)`` pairs
    of positions along the axes; in every group the slot at ``j``
    receives a copy of the tensor of the slot at ``i``, made on the
    receiver's stream into a fresh buffer; a slot that receives nothing
    gets zeros."""
    _check(xs, layout, "ppermute")
    n = layout.axis_size(axes)
    dst = {}
    for i, j in perm:
        if not (0 <= i < n and 0 <= j < n) or j in dst:
            raise ValueError(f"ppermute: {list(perm)} is not a "
                             f"permutation of positions 0..{n - 1}")
        dst[j] = i
    sender = {}
    for g in layout.groups(axes):
        for j, s in enumerate(g):
            sender[s] = g[dst[j]] if j in dst else None

    def receive(s):
        src = sender[s]
        if src is None:
            return torch.zeros_like(xs[s])
        x = xs[src]
        buf = torch.empty(x.shape, dtype=x.dtype, device=layout.device(s))
        return buf.copy_(x)

    return run_slots(layout, receive)
