"""Query index: per-source/target distance matrices and slack vectors.

Counterpart of ``repro/core/index.py`` (its ELL route): PathEnum's
light-weight index (Lemma 3.1) built for the whole batch with one
multi-source BFS per direction (Alg 1/4 lines 1-2), plus the slack vectors
the enumeration prunes with:

  slack[v] = max over consumers (k_q - offset_q - dist(v, endpoint_q))

A frontier vertex v at depth d survives iff d <= slack[v] (equivalently
Lemma 3.1's |p| + dist(v, t) <= k). ``walk_counts_ell`` is the walk-count
DP behind capacity planning and the "+" planners' split, on the ELL route;
``walk_counts`` is the same DP on the segment route (the reference's
``"jnp"`` arm): a chunked segmented sum over the destination-sorted edge
lists, or over their edge-sharded slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .graph import DeviceGraph, EdgeSlices
from .msbfs import INF_FOR, edge_span, msbfs_dist, msbfs_dist_ell, \
    segment_sweep
from ..kernels.ell_spmm.ops import ell_aggregate

__all__ = ["QueryIndex", "build_index", "slack_from_dists",
           "walk_counts_ell", "walk_counts", "INDEX_ROUTES"]

# the index's routes: "ell" (the default, on the kernels) and "segment"
# (the reference's "jnp" sweeps over the destination-sorted edge lists)
INDEX_ROUTES = ("ell", "segment")

Query = tuple[int, int, int]  # (s, t, k)


@dataclasses.dataclass(frozen=True)
class QueryIndex:
    queries: tuple[Query, ...]
    k_max: int
    sources: np.ndarray       # (Su,) unique source vertices
    targets: np.ndarray       # (Tu,) unique target vertices
    src_col: np.ndarray       # (Q,) column of q.s in dist_s
    tgt_col: np.ndarray       # (Q,) column of q.t in dist_t
    dist_s: torch.Tensor      # (n+1, Su) int8 -- dist_G(s, v); row n = INF
    dist_t: torch.Tensor      # (n+1, Tu) int8 -- dist_{G_r}(t, v) = dist_G(v, t)
    INF: int


def slack_from_dists(dist_cols: torch.Tensor, ks: np.ndarray,
                     offsets: np.ndarray, INF: int) -> torch.Tensor:
    """slack[v] = max_c (ks[c] - offsets[c] - dist_cols[v, c]); INF dist -> -1.

    dist_cols: (n+1, C) int8; returns (n+1,) int8 (row n forced to -1).
    """
    d = dist_cols.to(torch.int32)
    base = torch.as_tensor(np.asarray(ks, np.int32)
                           - np.asarray(offsets, np.int32),
                           device=d.device)
    val = torch.where(d >= INF, -1, base[None, :] - d)
    out = val.max(dim=1).values.clamp(-1, 127).to(torch.int8)
    out[-1] = -1
    return out


def build_index(dg: DeviceGraph, queries: Sequence[Query],
                edge_chunk: int = 1 << 22, route: str = "ell") -> QueryIndex:
    """Multi-source BFS from all sources on G and all targets on G_r.

    ``route="ell"``: forward distances gather the reverse ELL table
    (in-neighbours of G) and vice versa; each level is one ``msbfs_step``
    launch on the device's kernel arm. ``route="segment"``: the
    segment-route sweeps (``msbfs_dist``) over ``dg``'s edge lists, which
    may be sentinel-padded and edge-sharded, visiting their chunk-rounded
    valid span (``edge_span``) in chunks of ``edge_chunk``. Both give the
    same distances.
    """
    if route not in INDEX_ROUTES:
        raise ValueError(f"unknown index route {route!r}; valid: "
                         f"{', '.join(INDEX_ROUTES)}")
    if route == "segment" and not dg.has_edge_lists:
        raise ValueError("the segment route needs a DeviceGraph built "
                         "with edge_lists=True")
    queries = tuple((int(s), int(t), int(k)) for s, t, k in queries)
    k_max = max(k for _, _, k in queries)
    srcs = np.unique(np.array([q[0] for q in queries], np.int32))
    tgts = np.unique(np.array([q[1] for q in queries], np.int32))
    src_col = np.searchsorted(srcs, [q[0] for q in queries]).astype(np.int32)
    tgt_col = np.searchsorted(tgts, [q[1] for q in queries]).astype(np.int32)
    if route == "segment":
        m_valid = edge_span(dg.m, edge_chunk, dg.m_cap)
        dist_s = msbfs_dist(*dg.edge_list(False), torch.from_numpy(srcs),
                            n=dg.n, k_max=k_max, edge_chunk=edge_chunk,
                            m_valid=m_valid)
        dist_t = msbfs_dist(*dg.edge_list(True), torch.from_numpy(tgts),
                            n=dg.n, k_max=k_max, edge_chunk=edge_chunk,
                            m_valid=m_valid)
    else:
        dist_s = msbfs_dist_ell(dg.r_ell_idx, torch.from_numpy(srcs),
                                n=dg.n, k_max=k_max)
        dist_t = msbfs_dist_ell(dg.ell_idx, torch.from_numpy(tgts),
                                n=dg.n, k_max=k_max)
    return QueryIndex(queries=queries, k_max=k_max, sources=srcs,
                      targets=tgts, src_col=src_col, tgt_col=tgt_col,
                      dist_s=dist_s, dist_t=dist_t, INF=INF_FOR(k_max))


def walk_counts_ell(ell_in_idx: torch.Tensor, source: int,
                    slack: torch.Tensor, *, n: int,
                    budget: int) -> torch.Tensor:
    """Per-level pruned-walk counts: upper bounds on the enumeration
    frontier sizes. One ``ell_spmm`` launch (F = 1) per level.

    ell_in_idx: (n, D) padded ELL *in*-neighbour table (forward counts on
    G take ``dg.r_ell_idx``, reverse counts take ``dg.ell_idx`` -- the
    convention of :func:`~repro_torch.core.msbfs.msbfs_dist_ell`);
    slack: (n+1,) int8. Returns the (budget+1,) float32 totals (level 0
    == 1) on the device, so that the caller copies them to the host once.
    Totals are integer-valued float32, exact below 2**24 whatever the
    order of summation.
    """
    idx = ell_in_idx[:n]                       # (n, D), pad = n
    c = torch.zeros((n,), dtype=torch.float32, device=idx.device)
    c[source] = 1.0
    keep = slack[:-1]
    totals = [torch.ones((), dtype=torch.float32, device=idx.device)]
    for lvl in range(1, budget + 1):
        nxt = ell_aggregate(idx, c[:, None], op="sum")[:, 0]
        c = nxt * (keep >= lvl)
        totals.append(c.sum())
    return torch.stack(totals)


def walk_counts(esrc, edst, source: int, slack: torch.Tensor, *, n: int,
                budget: int, edge_chunk: int = 1 << 22,
                m_valid: Optional[int] = None) -> torch.Tensor:
    """Per-level pruned-walk counts on the segment route:
    ``c_{l+1}[v] = sum over edges (u -> v) of c_l[u]``, masked by
    ``slack[v] >= l+1``.

    esrc/edst: a destination-sorted, sentinel-padded edge list (or its
    ``EdgeSlices``); the count vector carries the zero row ``n``, so a
    sentinel edge adds nothing. ``m_valid`` is the chunk-rounded span of
    :func:`~repro_torch.core.msbfs.edge_span`. Returns the (budget+1,)
    float32 totals (level 0 == 1) on the lists' device. Each destination's
    run is summed in list order (``segment_sweep``), chunks and slots in
    theirs; the sums are integer-valued float32, exact below 2**24
    whatever the order.
    """
    device = esrc.device
    esrc, edst = EdgeSlices.of(esrc), EdgeSlices.of(edst)   # one plan
    c = torch.zeros((n + 1,), dtype=torch.float32, device=device)
    c[source] = 1.0
    keep = slack[:-1].to(device)
    totals = [torch.ones((), dtype=torch.float32, device=device)]
    for lvl in range(1, budget + 1):
        nxt = segment_sweep(c, esrc, edst, n=n, edge_chunk=edge_chunk,
                            m_valid=m_valid, reduce="sum")
        nxt = nxt * (keep >= lvl)
        c = torch.cat([nxt, nxt.new_zeros(1)])
        totals.append(nxt.sum())
    return torch.stack(totals)
