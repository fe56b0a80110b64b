"""Dynamic-graph subsystem: batched edge deltas with incremental CSR merge.

Counterpart of ``repro/core/delta.py`` (numpy, copied with its semantics).
Streaming workloads interleave queries with continuous edge arrivals;
rebuilding the graph from scratch (``Graph.from_edges``) for every
mutation re-sorts the whole edge list and forces the serving stack to
cold-start. This module makes a mutation proportional to its *size*:

  * ``GraphDelta``    -- a normalized batch of edge insertions/deletions
                         (self-loops dropped, duplicates collapsed, vertex
                         set fixed -- matching ``from_edges`` semantics).
  * ``apply_delta``   -- successor graph by sorted-key CSR merge in both
                         directions: kept edges are copied in bulk, the
                         few changed rows absorb the inserts, nothing is
                         re-sorted. Returns the *effective* change set and
                         the touched vertices -- the locality radius the
                         ELL row refresh and the hop-scoped cache
                         invalidation key off.
  * ``update_device_graph`` -- patches a :class:`DeviceGraph` instead of a
                         full rebuild: only the touched rows of the two ELL
                         tables are recomputed and written on the device;
                         falls back to ``DeviceGraph.build`` (caps that
                         never shrink) when a row outgrows its ELL cap.
  * ``host_set_dist`` -- BFS from the touched frontier for hop-scoped cache
                         invalidation, over the *old* CSR.

Delta semantics: deletions apply first, then insertions --
``new = (old - remove) | add``. Deleting an absent edge and inserting a
present one are no-ops and do not mark vertices as touched.

A ``DeviceGraph`` of the segment route also holds the destination-sorted
edge lists; ``update_device_graph`` re-uploads them, sentinel-padded to a
bucket that never shrinks, as the reference does. Left out of the
reference's ``update_device_graph``: the pow2 padding of the scattered row
set, which exists only to keep the reference's jit shapes stable. The rows
and lists are written out of place (``index_copy``, new tensors), so the
old ``DeviceGraph`` stays valid, as an immutable JAX array would.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .graph import (DeviceGraph, Graph, _ragged_arange, edge_list_tensors,
                    pow2_ceil)

__all__ = ["GraphDelta", "AppliedDelta", "apply_delta",
           "update_device_graph", "host_set_dist", "pow2_ceil"]


def _normalize_pairs(src, dst, drop_self_loops: bool) -> tuple[np.ndarray, np.ndarray]:
    src = np.asarray(src, dtype=np.int64).ravel()
    dst = np.asarray(dst, dtype=np.int64).ravel()
    if src.shape != dst.shape:
        raise ValueError("src/dst arrays must have equal length")
    if src.size and (src.min() < 0 or dst.min() < 0):
        raise ValueError("vertex ids must be >= 0")
    if drop_self_loops and src.size:
        keep = src != dst
        src, dst = src[keep], dst[keep]
    if src.size:  # dedupe pairs without knowing n (delta is graph-agnostic)
        pairs = np.unique(np.stack([src, dst], axis=1), axis=0)
        src, dst = pairs[:, 0], pairs[:, 1]
    return src, dst


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """A normalized batch of edge mutations against a fixed vertex set.

    Insertions drop self-loops (never on a simple path, mirroring
    ``Graph.from_edges``) and both lists are deduplicated at construction,
    so a delta is a pair of edge *sets*. Vertex-id bounds are checked
    against the graph at apply time.
    """

    add_src: np.ndarray
    add_dst: np.ndarray
    del_src: np.ndarray
    del_dst: np.ndarray

    def __post_init__(self):
        a_s, a_d = _normalize_pairs(self.add_src, self.add_dst,
                                    drop_self_loops=True)
        d_s, d_d = _normalize_pairs(self.del_src, self.del_dst,
                                    drop_self_loops=False)
        object.__setattr__(self, "add_src", a_s)
        object.__setattr__(self, "add_dst", a_d)
        object.__setattr__(self, "del_src", d_s)
        object.__setattr__(self, "del_dst", d_d)

    @classmethod
    def from_pairs(cls, add: Sequence = (), remove: Sequence = ()) -> "GraphDelta":
        """Build from iterables of ``(u, v)`` pairs."""
        add = np.asarray(list(add), dtype=np.int64).reshape(-1, 2)
        rem = np.asarray(list(remove), dtype=np.int64).reshape(-1, 2)
        return cls(add[:, 0], add[:, 1], rem[:, 0], rem[:, 1])

    @classmethod
    def empty(cls) -> "GraphDelta":
        z = np.zeros(0, np.int64)
        return cls(z, z, z, z)

    @property
    def n_add(self) -> int:
        return int(self.add_src.size)

    @property
    def n_del(self) -> int:
        return int(self.del_src.size)

    def __bool__(self) -> bool:
        return self.n_add > 0 or self.n_del > 0

    def max_vertex(self) -> int:
        """Largest vertex id referenced (-1 for an empty delta)."""
        parts = [a for a in (self.add_src, self.add_dst,
                             self.del_src, self.del_dst) if a.size]
        return int(max(int(a.max()) for a in parts)) if parts else -1


class AppliedDelta(NamedTuple):
    """Result of merging one delta: the successor graph plus the effective
    change set (after no-op elimination) in decoded form."""

    graph: Graph
    added_src: np.ndarray     # (na,) int64 -- edges actually inserted
    added_dst: np.ndarray
    removed_src: np.ndarray   # (nr,) int64 -- edges actually removed
    removed_dst: np.ndarray
    touched: np.ndarray       # (nt,) int64 -- unique endpoints of all changes

    @property
    def n_changed(self) -> int:
        return int(self.added_src.size + self.removed_src.size)


def _member(a: np.ndarray, b_sorted: np.ndarray) -> np.ndarray:
    """Mask over ``a``: which elements occur in sorted array ``b_sorted``."""
    if b_sorted.size == 0 or a.size == 0:
        return np.zeros(a.size, dtype=bool)
    pos = np.searchsorted(b_sorted, a)
    hit = pos < b_sorted.size
    out = np.zeros(a.size, dtype=bool)
    out[hit] = b_sorted[pos[hit]] == a[hit]
    return out


def _merge_disjoint_sorted(kept: np.ndarray, added: np.ndarray) -> np.ndarray:
    """Merge two sorted, disjoint key arrays in O(len) -- no re-sort."""
    if added.size == 0:
        return kept
    if kept.size == 0:
        return added
    out = np.empty(kept.size + added.size, dtype=kept.dtype)
    # final index of each element = own rank + #smaller elements of the other
    out[np.arange(kept.size) + np.searchsorted(added, kept)] = kept
    out[np.arange(added.size) + np.searchsorted(kept, added)] = added
    return out


def _csr_keys(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    """``row * n + col`` keys of a CSR, ascending (rows sorted, cols sorted
    within each row)."""
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    return rows * n + indices


def _merged_csr(indptr: np.ndarray, indices: np.ndarray, n: int,
                removed_keys: np.ndarray, added_keys: np.ndarray,
                key_old: Optional[np.ndarray] = None,
                ) -> tuple[np.ndarray, np.ndarray]:
    """One direction of the CSR merge; all key arrays ``row * n + col``
    ascending."""
    if key_old is None:
        key_old = _csr_keys(indptr, indices, n)
    kept = key_old[~_member(key_old, removed_keys)]
    new_key = _merge_disjoint_sorted(kept, added_keys)
    # indptr shifts by the cumulative per-row degree change -- O(n + d),
    # no O(m) bincount over the whole edge list
    delta_deg = (np.bincount(added_keys // n, minlength=n)
                 - np.bincount(removed_keys // n, minlength=n)).astype(np.int64)
    new_indptr = indptr + np.concatenate([[0], np.cumsum(delta_deg)])
    return new_indptr, (new_key % n).astype(np.int32)


def apply_delta(g: Graph, delta: GraphDelta) -> AppliedDelta:
    """Merge a delta into ``g``: ``new = (old - remove) | add``.

    Equivalent to ``Graph.from_edges`` on the edited edge list (both CSR
    directions, bit for bit), but kept edges are copied without
    re-sorting. Requires a deduplicated graph (``from_edges`` default).
    """
    n = g.n
    if delta.max_vertex() >= n:
        raise ValueError(f"delta references vertices outside the graph "
                         f"(n={n}, max id {delta.max_vertex()})")
    key_old = _csr_keys(g.indptr, g.indices, n)
    add_key = delta.add_src * n + delta.add_dst          # unique by construction
    del_key = delta.del_src * n + delta.del_dst
    # effective change set: deleting an absent edge / inserting a present
    # one is a no-op; delete-then-insert of a present edge cancels out
    removed = del_key[_member(del_key, key_old) & ~_member(del_key, add_key)]
    added = add_key[~_member(add_key, key_old)]
    if removed.size == 0 and added.size == 0:
        z = np.zeros(0, np.int64)
        return AppliedDelta(graph=g, added_src=z, added_dst=z,
                            removed_src=z, removed_dst=z, touched=z)

    indptr, indices = _merged_csr(g.indptr, g.indices, n, removed, added,
                                  key_old=key_old)
    # reverse direction: rekey (u, v) -> v * n + u
    removed_r = np.sort((removed % n) * n + removed // n)
    added_r = np.sort((added % n) * n + added // n)
    r_indptr, r_indices = _merged_csr(g.r_indptr, g.r_indices, n,
                                      removed_r, added_r)
    g2 = Graph(n=n, indptr=indptr, indices=indices,
               r_indptr=r_indptr, r_indices=r_indices)
    touched = np.unique(np.concatenate([added // n, added % n,
                                        removed // n, removed % n]))
    return AppliedDelta(graph=g2,
                        added_src=added // n, added_dst=added % n,
                        removed_src=removed // n, removed_dst=removed % n,
                        touched=touched)


# ----------------------------------------------------------------------
# device-view patching
# ----------------------------------------------------------------------

def _ell_rows(g: Graph, rows: np.ndarray, cap: int,
              reverse: bool) -> np.ndarray:
    """(len(rows), cap) padded-ELL rows (pad = n) for a subset of vertices."""
    ip, ix = (g.r_indptr, g.r_indices) if reverse else (g.indptr, g.indices)
    deg = (ip[rows + 1] - ip[rows]).astype(np.int64)
    idx = np.full((rows.size, cap), g.n, dtype=np.int32)
    r = np.repeat(np.arange(rows.size), deg)
    c = _ragged_arange(deg)
    idx[r, c] = ix[np.repeat(ip[rows], deg) + c]
    return idx


def _patched(g: Graph, table: torch.Tensor, rows: np.ndarray,
             reverse: bool) -> torch.Tensor:
    """``table`` with the given rows recomputed from ``g``: one host-built
    block of rows, one upload, one ``index_copy`` on the table's device."""
    if rows.size == 0:
        return table
    block = torch.from_numpy(_ell_rows(g, rows, table.shape[1], reverse))
    index = torch.from_numpy(rows.astype(np.int64))
    return table.index_copy(0, index.to(table.device),
                            block.to(table.device))


def update_device_graph(dg: DeviceGraph, applied: AppliedDelta,
                        ) -> tuple[DeviceGraph, bool]:
    """Patch device views for a merged delta; ``(new_dg, incremental)``.

    Only the touched rows of the two ELL tables (out-rows of changed
    sources, in-rows of changed destinations) are recomputed and written,
    so the tables keep their shapes. Falls back to a full
    ``DeviceGraph.build`` when a touched row outgrows its table's ELL cap
    (the ELL must stay spill-free for enumeration); the rebuild takes the
    current caps as floors, so a bucket never shrinks and grow/shrink
    churn around a boundary cannot thrash. Edge lists, where ``dg`` has
    them, are re-uploaded padded to ``m_cap`` while the edges fit it, else
    to ``pow2_ceil(m)`` (on a rebuild, the larger of the two).
    """
    g2 = applied.graph
    fwd_rows = np.unique(np.concatenate([applied.added_src,
                                         applied.removed_src]))
    rev_rows = np.unique(np.concatenate([applied.added_dst,
                                         applied.removed_dst]))
    fwd_deg = g2.indptr[fwd_rows + 1] - g2.indptr[fwd_rows]
    rev_deg = g2.r_indptr[rev_rows + 1] - g2.r_indptr[rev_rows]
    device = dg.ell_idx.device
    if ((fwd_deg.size and int(fwd_deg.max()) > dg.ell_cap)
            or (rev_deg.size and int(rev_deg.max()) > dg.r_ell_cap)):
        # every bucket stays monotone: an overflow after deletion-heavy
        # churn cannot shrink one and re-thrash the next insert wave
        return DeviceGraph.build(
            g2, device, min_ell_caps=(dg.ell_cap, dg.r_ell_cap),
            edge_lists=dg.has_edge_lists,
            edge_cap=max(dg.m_cap, pow2_ceil(g2.m))), False
    lists = {} if not dg.has_edge_lists else edge_list_tensors(
        g2, device, dg.m_cap if g2.m <= dg.m_cap else pow2_ceil(g2.m))
    return dataclasses.replace(
        dg, m=g2.m,
        ell_idx=_patched(g2, dg.ell_idx, fwd_rows, reverse=False),
        r_ell_idx=_patched(g2, dg.r_ell_idx, rev_rows, reverse=True),
        **lists), True


def host_set_dist(g_old: Graph, applied: AppliedDelta, k_max: int,
                  reverse: bool) -> np.ndarray:
    """BFS distances from the touched frontier, host-side over the old CSR.

    ``dist[v] = min over touched x of hops(x -> v)``; ``reverse=True``
    walks G_r (i.e. prices ``hops(v -> x)``). Only the touched balls'
    edges are visited, not ``m``. Returns ``(n+1,) int32`` capped at
    ``k_max`` (unreached = k_max + 1, row n INF), equal to
    :func:`~repro_torch.core.msbfs.msbfs_set_dist_ell` -- the sweep for
    graphs resident on the device -- at the same ``k_max``.

    Walking the *old* graph alone suffices for old, new, and union alike:
    both endpoints of every changed edge are seeds, so any path using a
    changed edge has a suffix from a distance-0 vertex over unchanged
    edges only -- distances from the touched set agree on all three
    graphs, and one sweep certifies cached state and its fresh
    recomputation.
    """
    ip, ix = (g_old.r_indptr, g_old.r_indices) if reverse \
        else (g_old.indptr, g_old.indices)
    INF = k_max + 1
    dist = np.full(g_old.n + 1, INF, np.int32)
    frontier = applied.touched
    dist[frontier] = 0
    for hop in range(1, k_max + 1):
        if frontier.size == 0:
            break
        deg = (ip[frontier + 1] - ip[frontier]).astype(np.int64)
        nbrs = np.unique(ix[np.repeat(ip[frontier], deg) +
                            _ragged_arange(deg)].astype(np.int64))
        frontier = nbrs[dist[nbrs] == INF]
        dist[frontier] = hop
    return dist
