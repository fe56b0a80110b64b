"""Bit-parallel multi-source BFS (the paper's BuildIndex, Alg 1/4 lines 1-2).

Two routes, as in ``repro/core/msbfs.py``:

  * the ELL route (``msbfs_dist_ell``, ``msbfs_set_dist_ell``), the
    engine's default, on the ``msbfs_step`` kernel;
  * the segment route (``msbfs_dist``, ``msbfs_set_dist``, ``msbfs_hop``),
    the counterpart of the reference's ``"jnp"`` sweeps: one hop is a
    gather of frontier rows by a destination-sorted edge list and a
    segmented max over each destination's run (max == OR on {0, 1}).

Segment route. The frontier and dist are int8 (n+1, S) tables (row n the
sentinel). A hop visits the list in chunks of ``edge_chunk`` edges (the
(chunk, S) gather stays bounded) and skips chunks past ``m_valid``, the
chunk-rounded valid span (:func:`edge_span`). A chunk of a sorted list
holds the runs of one window of destinations, found once a list and
chunking by a binary search of the sorted destinations and kept with the
list (``EdgeSlices.plans``, :func:`segment_sweep`); the reduction is a fixed-order pass
over each destination's run in that window (``torch.segment_reduce``, no
atomics), and a sentinel edge ``(n, n)``, sorted past every window, is
dropped, never written to row n. The list may also be an :class:`~repro_torch.core.graph.EdgeSlices`
(the executor's edge-sharded view): each slot reduces its slice on its
own stream and the partials merge on the frontier's device in slot order.
The segmented max runs on float16 copies of the {0, 1} frontier (the
card's ``segment_reduce`` takes floating types only); the result is exact.

ELL route. The frontier is bit-packed (32 sources per int32 word,
``pack_bits`` layout) over the padded ELL *in*-neighbour table, and one
level is ONE fused ``msbfs_step`` launch (expand + visited dedup +
distance write). Distances are int8 (``k_max <= K_MAX_INT8``); unreached
= INF = k_max + 1.

Direction convention (as in the JAX package): a level relaxes
``next[v] = OR over in-neighbours u of v``, so forward distances on G take
the reverse table ``dg.r_ell_idx`` and distances on G_r take
``dg.ell_idx``; on the segment route they take G's edge list sorted by
destination (``dg.esrc``, ``dg.edst``) and G_r's (``dg.r_esrc``,
``dg.r_edst``).

Like the reference, either sweep runs all k_max levels (no early exit), so a
batch costs exactly k_max launches per direction. ``msbfs_set_dist_ell``
is the set-seeded sweep of the delta path's cache invalidation: one bit
column seeded with a whole vertex set (W = 1 word, 31 of its 32 bits
idle), on the same kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from .graph import EdgeSlices
from ..launch.collectives import _slot_stream
from ..kernels.msbfs_expand.ops import msbfs_step, wrap_int32

__all__ = ["msbfs_dist_ell", "msbfs_set_dist_ell", "msbfs_dist",
           "msbfs_set_dist", "msbfs_hop", "edge_span", "segment_sweep",
           "INF_FOR", "K_MAX_INT8"]

# Largest hop budget the int8 distance representation supports. INF_FOR
# (k_max + 1) must stay representable AND keep headroom below int8 max
# for downstream +1/-offset hop arithmetic (prune tables, splice
# budgets); 120 leaves 127 - 121 = 6 values of slack above the sentinel.
K_MAX_INT8 = 120
_INT8_MAX = 127


def INF_FOR(k_max: int) -> int:
    return k_max + 1


def _check_k_max(k_max: int) -> None:
    """int8-range guard of the sweep: raises before any device work
    instead of computing wrong-radius distances."""
    if not 0 <= int(k_max) <= K_MAX_INT8:
        raise ValueError(
            f"k_max={k_max} out of range for int8 MS-BFS distances: "
            f"requires 0 <= k_max <= K_MAX_INT8={K_MAX_INT8} so the "
            f"sentinel INF_FOR(k_max)={int(k_max) + 1} fits int8 "
            f"(max {_INT8_MAX}) with {_INT8_MAX - K_MAX_INT8 - 1} values "
            f"of headroom above INF for downstream hop arithmetic; "
            f"reduce the hop budget (or bucket it) before the sweep")


def edge_span(m_valid: int, edge_chunk: int, m_cap: int) -> int:
    """Chunk-rounded prefix of a sentinel-padded edge list that the
    chunked sweeps must visit: ``m_valid`` rounded *up* to an
    ``edge_chunk`` multiple, clamped to ``m_cap`` (the reference's
    function: every edge count inside one chunk maps to the same span)."""
    if m_valid >= m_cap:
        return int(m_cap)
    return int(min(-(-int(m_valid) // int(edge_chunk)) * int(edge_chunk),
                   m_cap))


# ----------------------------------------------------------------------
# the segment route
# ----------------------------------------------------------------------
def _slots(esrc, edst) -> tuple[list, dict]:
    """``[(src, dst, lo, stream), ...]`` of each slot of an edge list (a
    tensor is one slot on the caller's stream, ``lo`` a slice's first
    position in the whole list) and the chunk plans kept with its
    destinations."""
    if isinstance(esrc, EdgeSlices) != isinstance(edst, EdgeSlices):
        raise TypeError("esrc and edst must both be tensors or both "
                        "EdgeSlices")
    esrc, edst = EdgeSlices.of(esrc), EdgeSlices.of(edst)
    if [int(x.shape[0]) for x in esrc.slices] != \
            [int(x.shape[0]) for x in edst.slices]:
        raise ValueError("esrc and edst must be cut into the same slices")
    out, lo = [], 0
    for src, dst, stream in zip(esrc.slices, edst.slices, esrc.streams):
        out.append((src, dst, lo, stream))
        lo += int(src.shape[0])
    return out, edst.plans


def _pieces(lo: int, hi: int, m: int, m_used: int, edge_chunk: int):
    """The slot ``[lo, hi)``'s share of the reference's chunks
    ``[c, min(c + edge_chunk, m))``, ``c`` in ``range(0, m_used,
    edge_chunk)``, as bounds local to the slot."""
    c = (lo // edge_chunk) * edge_chunk
    while c < min(m_used, hi):
        a, b = max(c, lo), min(c + edge_chunk, m, hi)
        if a < b:
            yield a - lo, b - lo
        c += edge_chunk


def _chunk_plan(plans: dict, dst, lo: int, m: int, m_used: int, n: int,
                edge_chunk: int) -> list:
    """``(a, b, w0, w1, off)`` of each chunk of a slot's destinations
    ``dst`` that holds a real edge: positions ``[a, b)``, the window of
    destinations ``[w0, w1)`` it holds and the runs' offsets in it
    (``off[v - w0]`` .. ``off[v - w0 + 1]`` for destination v; sentinels
    sort past the last). Made on the first sweep of a list and chunking
    (one copy of the chunks' end destinations to the host, and a stream
    synchronize so that any stream may read the offsets) and kept in
    ``plans``, the list's ``EdgeSlices.plans``."""
    key = (lo, m, m_used, n, edge_chunk)
    plan = plans.get(key)
    if plan is not None:
        return plan
    pieces = list(_pieces(lo, lo + int(dst.shape[0]), m, m_used,
                          edge_chunk))
    ends = []
    if pieces:
        at = torch.tensor([x for a, b in pieces for x in (a, b - 1)],
                          device=dst.device)
        # repro-lint: waive[RPL001] once a list and chunking: the chunks' destination windows, kept with the list
        ends = dst[at].tolist()
    plan = []
    for i, (a, b) in enumerate(pieces):
        w0, w1 = ends[2 * i], min(ends[2 * i + 1], n - 1) + 1
        if w0 >= n:
            continue                       # sentinels only
        seg = torch.arange(w0, w1 + 1, dtype=dst.dtype, device=dst.device)
        plan.append((a, b, w0, w1, torch.searchsorted(dst[a:b], seg)))
    if dst.device.type == "cuda":
        torch.cuda.current_stream(dst.device).synchronize()
    plans[key] = plan
    return plan


def _slot_reduce(values, src, dst, lo, plans, m, m_used, n, edge_chunk,
                 reduce: str):
    """One slot's partial: ``reduce`` ("max" or "sum") of ``values``' rows
    gathered by ``src`` over each destination's run, chunk by chunk in
    list order (a destination split between chunks combined in that order
    too). Returns ``(w0, part)``, the partial of destinations ``w0 ..
    w0 + len(part) - 1`` (the slot's window), or ``None`` when the slot
    holds no real edge to visit."""
    plan = _chunk_plan(plans, dst, lo, m, m_used, n, edge_chunk)
    if not plan:
        return None
    w_lo = plan[0][2]
    acc = values.new_zeros((plan[-1][3] - w_lo, *values.shape[1:]))
    for a, b, w0, w1, off in plan:
        part = torch.segment_reduce(values.index_select(0, src[a:b]),
                                    reduce, offsets=off, axis=0,
                                    unsafe=True, initial=0)
        win = acc[w0 - w_lo:w1 - w_lo]
        if reduce == "max":
            torch.maximum(win, part, out=win)
        else:
            win += part
    return w_lo, acc


def segment_sweep(values: torch.Tensor, esrc, edst, *, n: int,
                  edge_chunk: int = 1 << 22, m_valid: Optional[int] = None,
                  reduce: str = "max") -> torch.Tensor:
    """``out[v] = reduce over edges (u -> v) of values[u]`` for v < n.

    values : (n+1, ...) float rows on the caller's device (row n neutral:
             zeros).
    esrc, edst : a destination-sorted, sentinel-padded edge list, as two
             int32 tensors or as two ``EdgeSlices`` cut alike.
    Returns (n, ...) of ``values``' dtype on its device: empty segments
    give 0. With slices, each slot reduces its slice on its stream
    (``values`` copied once to each other device it meets) and the
    partials merge here in slot order, after each slot's event.
    """
    if reduce not in ("max", "sum"):
        raise ValueError(f"reduce must be 'max' or 'sum', got {reduce!r}")
    edge_chunk = int(edge_chunk)
    if edge_chunk < 1:
        raise ValueError(f"edge_chunk={edge_chunk} must be positive")
    slots, plans = _slots(esrc, edst)
    m = sum(int(src.shape[0]) for src, _, _, _ in slots)
    m_used = m if m_valid is None else min(int(m_valid), m)
    primary = values.device
    args = (plans, m, m_used, n, edge_chunk, reduce)
    caller = torch.cuda.current_stream(primary) \
        if primary.type == "cuda" else None
    parts = []
    if len(slots) == 1 and slots[0][3] is None \
            and slots[0][0].device == primary:
        src, dst, lo, _ = slots[0]
        parts.append((_slot_reduce(values, src, dst, lo, *args), None))
    else:
        copies = {primary: (values, None)}
        for src, dst, lo, stream in slots:
            dev = src.device
            with _slot_stream(dev, stream, caller) as s:
                if dev not in copies:
                    copies[dev] = (values.to(dev), None if s is None
                                   else s.record_event())
                local, ready = copies[dev]
                if ready is not None:
                    s.wait_event(ready)
                part = _slot_reduce(local, src, dst, lo, *args)
                if part is not None and dev != primary:
                    part = (part[0], part[1].to(primary))
                done = None if s is None or s == caller \
                    else s.record_event()
            parts.append((part, done))
    acc = values.new_zeros((n, *values.shape[1:]))
    for part, done in parts:            # slot order
        if done is not None:
            caller.wait_event(done)
        if part is None:
            continue
        w0, part = part
        win = acc[w0:w0 + part.shape[0]]
        if reduce == "max":
            torch.maximum(win, part, out=win)
        else:
            win += part
    return acc


def msbfs_hop(frontier: torch.Tensor, esrc, edst, n: int,
              edge_chunk: int = 1 << 22,
              m_valid: Optional[int] = None) -> torch.Tensor:
    """One BFS relaxation: ``next[v, s] = OR over edges (u -> v) of
    frontier[u, s]``.

    frontier : (n+1, S) int8 in {0, 1} (row n = sentinel zeros).
    m_valid  : the chunk-rounded valid-edge span (:func:`edge_span`);
               ``None`` sweeps the whole list -- correct either way.
    Returns (n+1, S) int8, row n zero.
    """
    nxt = frontier.new_zeros(frontier.shape)
    part = segment_sweep(frontier.to(torch.float16), esrc, edst, n=n,
                         edge_chunk=edge_chunk, m_valid=m_valid,
                         reduce="max")
    nxt[:n] = part
    return nxt


def _sweep(dist: torch.Tensor, frontier: torch.Tensor, esrc, edst, n: int,
           k_max: int, edge_chunk: int, m_valid: Optional[int]):
    """The hops of a segment-route sweep, in place on int8 ``dist``
    (n+1, S): a vertex first reached at hop h gets h."""
    INF = INF_FOR(k_max)
    for hop in range(1, k_max + 1):
        nxt = msbfs_hop(frontier, esrc, edst, n, edge_chunk, m_valid)
        new = nxt.masked_fill_(dist < INF, 0)   # newly reached only
        dist.masked_fill_(new.bool(), hop)
        frontier = new
        frontier[n] = 0
    dist[n] = INF
    return dist


def msbfs_dist(esrc, edst, sources: torch.Tensor, *, n: int, k_max: int,
               edge_chunk: int = 1 << 22,
               m_valid: Optional[int] = None) -> torch.Tensor:
    """Distances from each source, capped at k_max (the segment route).

    esrc/edst : (m,) int32 edges sorted by destination (the reverse lists
                for G_r), or their ``EdgeSlices``.
    sources   : (S,) vertex ids (repeats allowed; columns are
                independent).
    Returns (n+1, S) int8 on the lists' (slot 0's) device:
    ``dist[v, i] = min(hops(sources[i] -> v), INF)``, row n = INF.
    """
    _check_k_max(k_max)
    device = esrc.device
    esrc, edst = EdgeSlices.of(esrc), EdgeSlices.of(edst)   # one plan
    S = int(sources.shape[0])
    sources = sources.to(device=device, dtype=torch.int64)
    cols = torch.arange(S, device=device)
    dist = torch.full((n + 1, S), INF_FOR(k_max), dtype=torch.int8,
                      device=device)
    dist[sources, cols] = 0
    frontier = torch.zeros((n + 1, S), dtype=torch.int8, device=device)
    frontier[sources, cols] = 1
    return _sweep(dist, frontier, esrc, edst, n, k_max, edge_chunk, m_valid)


def msbfs_set_dist(esrc, edst, seed_mask: torch.Tensor, *, n: int,
                   k_max: int, edge_chunk: int = 1 << 22,
                   m_valid: Optional[int] = None) -> torch.Tensor:
    """Distance from a vertex *set* (the segment route): one column
    seeded with every member, ``dist[v] = min over seeds of hops(seed ->
    v)``.

    seed_mask : (n+1,) int8 in {0, 1} (row n must be 0).
    Returns (n+1,) int8 with unreached = INF = k_max + 1, row n = INF.
    """
    _check_k_max(k_max)
    device = esrc.device
    esrc, edst = EdgeSlices.of(esrc), EdgeSlices.of(edst)   # one plan
    seed = seed_mask.to(device=device, dtype=torch.int8)[:, None]
    dist = torch.where(seed != 0, 0, INF_FOR(k_max)).to(torch.int8)
    frontier = seed.clone()
    return _sweep(dist, frontier, esrc, edst, n, k_max, edge_chunk,
                  m_valid)[:, 0].contiguous()


def msbfs_dist_ell(ell_in_idx: torch.Tensor, sources: torch.Tensor, *,
                   n: int, k_max: int) -> torch.Tensor:
    """Distances from each source, capped at k_max.

    ell_in_idx : (n, D) or (n+1, D) int32 padded ELL *in*-neighbour table
                 (pad = n; a row n is dropped, never expanded).
    sources    : (S,) int64/int32 vertex ids on the table's device.
    Returns (n+1, S) int8: ``dist[v, i] = min(hops(sources[i] -> v), INF)``,
    row n = INF (the sentinel of padded gathers).
    """
    _check_k_max(k_max)
    device = ell_in_idx.device
    idx = ell_in_idx[:n]
    S = int(sources.shape[0])
    W = -(-S // 32)
    INF = INF_FOR(k_max)
    sources = sources.to(device=device, dtype=torch.int64)
    cols = torch.arange(S, device=device)
    # seed bits straight into packed words: each column sets one distinct
    # bit, so the int64 sum of a word's bits is their OR
    words = torch.zeros((n + 1, W), dtype=torch.int64, device=device)
    words.index_put_((sources, cols // 32),
                     torch.ones_like(cols) << (cols % 32), accumulate=True)
    words[n] = 0                                   # sentinel stays 0
    frontier = wrap_int32(words)                   # (n+1, W)
    visited = frontier[:n].clone()                 # seeds reached at hop 0
    # row n is the INF sentinel; the kernel sees the first n rows
    dist = torch.full((n + 1, W * 32), INF, dtype=torch.int8, device=device)
    dist[sources, cols] = 0
    for hop in range(1, k_max + 1):
        frontier = msbfs_step(idx, frontier, visited, dist[:n], hop)
    return dist[:, :S].contiguous()


def msbfs_set_dist_ell(ell_in_idx: torch.Tensor, seed_mask: torch.Tensor,
                       *, n: int, k_max: int) -> torch.Tensor:
    """Distances from a vertex *set*: ``dist[v] = min over seeds x of
    hops(x -> v)``, capped at k_max.

    ell_in_idx : (n, D) or (n+1, D) int32 padded ELL *in*-neighbour table
                 (pad = n; a row n is dropped, never expanded).
    seed_mask  : (n+1,) int8 in {0, 1} on the table's device (row n is
                 ignored).
    Returns (n+1,) int8 with unreached = INF = k_max + 1, row n = INF.
    """
    _check_k_max(k_max)
    device = ell_in_idx.device
    idx = ell_in_idx[:n]
    INF = INF_FOR(k_max)
    seed = seed_mask.to(device=device) != 0
    seed[n] = False                                # sentinel stays 0
    # one column: the packed word of a vertex is 1 (bit 0) or 0
    frontier = seed.to(torch.int32)[:, None]       # (n+1, 1)
    visited = frontier[:n].clone()                 # seeds reached at hop 0
    dist = torch.full((n + 1, 32), INF, dtype=torch.int8, device=device)
    dist[:n, 0].masked_fill_(seed[:n], 0)
    for hop in range(1, k_max + 1):
        frontier = msbfs_step(idx, frontier, visited, dist[:n], hop)
    return dist[:, 0].contiguous()
