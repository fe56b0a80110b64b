"""Graph containers: the host ``Graph`` (numpy CSR, both directions) and
the ``DeviceGraph`` of padded ELL tables the kernels read.

Counterpart of ``repro/core/graph.py``. The host ``Graph`` is a copy of the
JAX package's (numpy only), plus :meth:`Graph.from_arrays`, which carries a
JAX-side graph's five arrays over. ``DeviceGraph`` holds the padded ELL
in-/out-neighbour tables as int32 tensors on the engine's device:

  padded ELL -- (n, cap) neighbour matrix padded with the sentinel value
                ``n``; every frontier or count table carries one extra
                row ``n`` of neutral values, so a pad entry is inert in the
                BFS OR-gather and the enumeration gather.

ELL capacities are bucketed to powers of two (``pow2_ceil`` of the largest
degree), so every kernel shape is stable while the graph stays within its
bucket.

The segment route (``EngineConfig.index_route="segment"``, the counterpart
of the reference's ``"jnp"`` sweeps) also needs the destination-sorted
edge lists (``Graph.edges_by_dst`` / ``r_edges_by_dst``) on the device.
``DeviceGraph.build(..., edge_lists=True)`` uploads them padded with
**sentinel edges** ``(n, n)`` to a power-of-two bucket (``pad_edge_list``):
``edst = n`` lies past every segment, so a segmented reduction drops the
message, and ``esrc = n`` gathers the neutral row ``n`` that every
frontier and count table carries -- a sentinel edge is inert in the BFS
semiring and in the walk-count DP. A sharded view cuts each list into
contiguous slices, one per slot of the executor's device list
(:class:`EdgeSlices`, ``distributed.shard_graph_edges``).
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional, Union

import numpy as np
import torch

__all__ = ["Graph", "DeviceGraph", "EllView", "EdgeSlices", "pow2_ceil",
           "pad_edge_list"]


def pow2_ceil(x: int) -> int:
    """Smallest power of two >= x (1 for x <= 1) -- the shared shape-bucket
    rounding of every device view."""
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


def pad_edge_list(esrc: np.ndarray, edst: np.ndarray, n: int,
                  cap: int) -> tuple[np.ndarray, np.ndarray]:
    """Sentinel-pad a dst-sorted edge list to ``cap`` entries.

    Sentinel edges are ``(n, n)``: dropped by segmented reductions over
    segments ``0 .. n-1`` and reading the neutral row ``n`` on gathers, so
    the padded list means the same as the exact one. ``n`` sorts after
    every real destination, so the list stays sorted by destination.
    """
    m = int(esrc.shape[0])
    if cap < m:
        raise ValueError(f"edge bucket {cap} smaller than edge count {m}")
    if cap == m:
        return esrc.astype(np.int32, copy=False), \
            edst.astype(np.int32, copy=False)
    pad = np.full(cap - m, n, dtype=np.int32)
    return (np.concatenate([esrc.astype(np.int32, copy=False), pad]),
            np.concatenate([edst.astype(np.int32, copy=False), pad]))


def edge_list_tensors(g: "Graph", device: Union[torch.device, str],
                      cap: int) -> dict:
    """``esrc``, ``edst``, ``r_esrc``, ``r_edst`` of ``g`` (G's and G_r's
    edges sorted by destination), sentinel-padded to ``cap`` and put on
    ``device`` as int32 tensors: the segment route's lists."""
    out = {}
    for names, (src, dst) in ((("esrc", "edst"), g.edges_by_dst),
                              (("r_esrc", "r_edst"), g.r_edges_by_dst)):
        for name, arr in zip(names, pad_edge_list(src, dst, g.n, int(cap))):
            out[name] = torch.from_numpy(arr).to(device)
    return out


@dataclasses.dataclass(frozen=True)
class EdgeSlices:
    """One int32 edge array cut into contiguous slices, slice j on slot
    j's device: the port's counterpart of an edge array sharded over a
    1-D mesh. ``streams[j]`` is the CUDA stream slot j's partial
    reductions run on (``None``: the caller's current stream).
    ``plans`` keeps the segment sweeps' chunk plans of these slices
    (``msbfs.segment_sweep``), made on first use and valid while the
    slices live, since an edge list is never written in place."""

    slices: tuple
    streams: tuple
    plans: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    @staticmethod
    def of(x: Union[torch.Tensor, "EdgeSlices"]) -> "EdgeSlices":
        """``x`` itself, or a tensor as one slice on the caller's
        stream."""
        return x if isinstance(x, EdgeSlices) else EdgeSlices((x,), (None,))

    @property
    def shape(self) -> tuple[int]:
        return (sum(int(x.shape[0]) for x in self.slices),)

    @property
    def device(self) -> torch.device:
        return self.slices[0].device


@dataclasses.dataclass(frozen=True)
class EllView:
    """Padded ELL adjacency: idx[v, d] = d-th out-neighbor or n (sentinel)."""

    idx: np.ndarray          # (n, cap) int32, padded with n
    mask: np.ndarray         # (n, cap) bool
    spill_src: np.ndarray    # (n_spill,) int32 COO remainder
    spill_dst: np.ndarray    # (n_spill,) int32
    cap: int


@dataclasses.dataclass(frozen=True)
class Graph:
    """Directed graph, CSR in both directions. Vertices are 0..n-1."""

    n: int
    indptr: np.ndarray       # (n+1,) int64 -- out-edges CSR
    indices: np.ndarray      # (m,) int32, sorted within row
    r_indptr: np.ndarray     # (n+1,) int64 -- in-edges CSR (reverse graph)
    r_indices: np.ndarray    # (m,) int32

    @staticmethod
    def from_edges(n: int, src, dst, dedup: bool = True) -> "Graph":
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if src.size:
            keep = src != dst  # drop self loops: never on a simple path twice
            src, dst = src[keep], dst[keep]
        if dedup and src.size:
            key = src * n + dst
            _, uniq = np.unique(key, return_index=True)
            src, dst = src[uniq], dst[uniq]
        indptr, indices = _csr(n, src, dst)
        r_indptr, r_indices = _csr(n, dst, src)
        return Graph(n=n, indptr=indptr, indices=indices,
                     r_indptr=r_indptr, r_indices=r_indices)

    @staticmethod
    def from_arrays(n: int, indptr, indices, r_indptr,
                    r_indices) -> "Graph":
        """Carry a graph's state over: the five CSR arrays of a
        ``repro.core.graph.Graph`` (``n, indptr, indices, r_indptr,
        r_indices``) in, this package's ``Graph`` out. The arrays are
        copied with the dtypes above; the shapes are checked."""
        n = int(n)
        g = Graph(n=n,
                  indptr=np.array(indptr, dtype=np.int64),
                  indices=np.array(indices, dtype=np.int32),
                  r_indptr=np.array(r_indptr, dtype=np.int64),
                  r_indices=np.array(r_indices, dtype=np.int32))
        if g.indptr.shape != (n + 1,) or g.r_indptr.shape != (n + 1,):
            raise ValueError(f"indptr arrays must have n+1={n + 1} entries")
        m = int(g.indices.shape[0])
        if (g.r_indices.shape != (m,) or int(g.indptr[-1]) != m
                or int(g.r_indptr[-1]) != m):
            raise ValueError("CSR arrays disagree on the edge count")
        return g

    @property
    def m(self) -> int:
        return int(self.indices.shape[0])

    def out_degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    def in_degree(self) -> np.ndarray:
        return np.diff(self.r_indptr)

    def neighbors(self, v: int, reverse: bool = False) -> np.ndarray:
        ip, ix = (self.r_indptr, self.r_indices) if reverse else (self.indptr, self.indices)
        return ix[ip[v]:ip[v + 1]]

    @cached_property
    def edges_by_dst(self) -> tuple[np.ndarray, np.ndarray]:
        """(src, dst) of G with dst non-decreasing, both int32."""
        dst = np.repeat(np.arange(self.n, dtype=np.int32),
                        np.diff(self.r_indptr))
        return self.r_indices.astype(np.int32), dst

    @cached_property
    def r_edges_by_dst(self) -> tuple[np.ndarray, np.ndarray]:
        """(src, dst) of G_r with dst non-decreasing (the edges of G keyed
        by their source), both int32."""
        dst = np.repeat(np.arange(self.n, dtype=np.int32),
                        np.diff(self.indptr))
        return self.indices.astype(np.int32), dst

    def ell(self, cap: Optional[int] = None, reverse: bool = False) -> EllView:
        ip, ix = (self.r_indptr, self.r_indices) if reverse else (self.indptr, self.indices)
        deg = np.diff(ip).astype(np.int64)
        if cap is None:
            cap = int(deg.max()) if self.n else 1
        cap = max(int(cap), 1)
        idx = np.full((self.n, cap), self.n, dtype=np.int32)
        # vectorized fill of the first `cap` neighbors per row
        take = np.minimum(deg, cap)
        rows = np.repeat(np.arange(self.n), take)
        cols = _ragged_arange(take)
        flat = np.repeat(ip[:-1], take) + cols
        idx[rows, cols] = ix[flat]
        mask = idx != self.n
        # spill: neighbors beyond cap
        extra = deg - take
        s_rows = np.repeat(np.arange(self.n, dtype=np.int32), extra)
        s_cols = _ragged_arange(extra) + np.repeat(take, extra)
        s_flat = np.repeat(ip[:-1], extra) + s_cols
        return EllView(idx=idx, mask=mask,
                       spill_src=s_rows, spill_dst=ix[s_flat].astype(np.int32),
                       cap=cap)

    def reverse(self) -> "Graph":
        return Graph(n=self.n, indptr=self.r_indptr, indices=self.r_indices,
                     r_indptr=self.indptr, r_indices=self.indices)

    # -- incremental mutation ------------------------------------------
    def apply_delta(self, delta) -> tuple["Graph", np.ndarray]:
        """Successor graph after a :class:`~repro_torch.core.delta.GraphDelta`.

        Merges the (deduplicated, self-loop-free) edge mutations into both
        CSR directions without re-sorting the kept edges -- equivalent to a
        ``from_edges`` rebuild on the edited edge list, in time
        proportional to ``m + |delta| log m``. Returns ``(new_graph,
        touched)`` where ``touched`` holds the unique endpoints of every
        *effective* change (no-op inserts/deletes excluded); an empty
        ``touched`` means ``new_graph is self``.
        """
        from .delta import apply_delta as _apply_delta
        applied = _apply_delta(self, delta)
        return applied.graph, applied.touched


def _csr(n: int, src: np.ndarray, dst: np.ndarray):
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=n).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, dst.astype(np.int32)


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated."""
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    offs = np.repeat(np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    return np.arange(total, dtype=np.int64) - offs


Edges = Union[torch.Tensor, EdgeSlices]


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Padded ELL tables of a Graph on one device (built once per engine).

    ``ell_idx`` holds out-neighbours (G), ``r_ell_idx`` in-neighbours
    (G_r); both are (n, cap) int32 padded with ``n``, caps pow2-bucketed
    per direction. A graph built for the segment route also holds the
    destination-sorted edge lists of G (``esrc``, ``edst``) and of G_r
    (``r_esrc``, ``r_edst``), int32, sentinel-padded to ``m_cap``; on the
    ELL route they are ``None``.
    """

    n: int
    m: int                    # valid edge count; the lists hold m_cap
    ell_idx: torch.Tensor     # (n, ell_cap) int32, pad = n
    r_ell_idx: torch.Tensor   # (n, r_ell_cap) int32, pad = n
    ell_cap: int
    r_ell_cap: int
    esrc: Optional[Edges] = None     # (m_cap,) sorted by dst, sentinel n
    edst: Optional[Edges] = None
    r_esrc: Optional[Edges] = None
    r_edst: Optional[Edges] = None

    @property
    def m_cap(self) -> int:
        """Padded edge-bucket capacity of the edge lists (0 without
        them)."""
        return 0 if self.esrc is None else int(self.esrc.shape[0])

    @property
    def has_edge_lists(self) -> bool:
        return self.esrc is not None

    @staticmethod
    def build(g: Graph, device: Union[torch.device, str], *,
              min_ell_caps: tuple[int, int] = (1, 1),
              edge_lists: bool = False,
              edge_cap: Optional[int] = None) -> "DeviceGraph":
        """Materialize the ELL tables on ``device``, each direction's
        capacity ``pow2_ceil(max degree)`` floored at ``min_ell_caps``
        (fwd, rev) -- the same tables as the JAX package's padded
        ``DeviceGraph``. The delta path passes its current caps, so a
        rebuild never shrinks a bucket. ``edge_lists=True`` also uploads
        both directions' edge lists, sentinel-padded to ``edge_cap``
        (default ``pow2_ceil(m)``)."""
        lists = {} if not edge_lists else edge_list_tensors(
            g, device, pow2_ceil(g.m) if edge_cap is None else edge_cap)
        deg = np.diff(g.indptr)
        r_deg = np.diff(g.r_indptr)
        ell = g.ell(cap=max(pow2_ceil(int(deg.max()) if deg.size else 1),
                            min_ell_caps[0]))
        rell = g.reverse().ell(cap=max(pow2_ceil(int(r_deg.max())
                                                 if r_deg.size else 1),
                                       min_ell_caps[1]))
        return DeviceGraph(
            n=g.n, m=g.m,
            ell_idx=torch.from_numpy(ell.idx).to(device),
            r_ell_idx=torch.from_numpy(rell.idx).to(device),
            ell_cap=ell.cap, r_ell_cap=rell.cap, **lists)

    def direction(self, reverse: bool) -> torch.Tensor:
        """The out-neighbour table of a search direction (G or G_r)."""
        return self.r_ell_idx if reverse else self.ell_idx

    def edge_list(self, reverse: bool) -> tuple[EdgeSlices, EdgeSlices]:
        """G's (``reverse=False``) or G_r's destination-sorted list as
        ``(esrc, edst)`` EdgeSlices, made once per DeviceGraph, so that
        the sweeps' chunk plans are kept, and freed, with it."""
        return self._edge_slices[bool(reverse)]

    @cached_property
    def _edge_slices(self) -> tuple:
        if not self.has_edge_lists:
            raise ValueError("this DeviceGraph holds no edge lists (build "
                             "it with edge_lists=True)")
        return tuple((EdgeSlices.of(s), EdgeSlices.of(d)) for s, d in (
            (self.esrc, self.edst), (self.r_esrc, self.r_edst)))
