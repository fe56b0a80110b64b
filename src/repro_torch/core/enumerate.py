"""Frontier path-enumeration supersteps (Alg 1/4 ``Search``, level by level).

Counterpart of ``repro/core/enumerate.py``. The level-l frontier is a
PathSet of all simple paths of length exactly l that survive the slack
prune. One superstep expands every frontier path by every ELL neighbour at
once, masks invalid candidates (padding / duplicate vertex / Lemma-3.1
slack prune / splice triggers), and cumsum-compacts the survivors.
``expand_level`` picks the arm by the frontier's device: on the card the
whole level is one fused kernel (``expand_level_cuda``, around
``path_member``'s duplicate test), elsewhere the eager composition of
plain PyTorch ops around ``path_member_ref`` (``expand_level_ref``); the
two agree bit for bit on every output. On ``meta`` tensors (the dry run)
``expand_level_meta`` gives the outputs' shapes and computes nothing.

Splice handling (BatchEnum, Alg 4 lines 20-23): vertices that root a
materialized dominating HC-s path query are *not* expanded when the cached
budget covers the remaining budget; the (prefix x cached-suffix) cross join
happens in join.py.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.path_join.ops import fused_level_cuda, path_member_ref
from ..kernels.registry import ArmLike, KernelArm, meta_launch, resolve_arm
from .pathset import PathSet, compact_index, compact_rows

__all__ = ["ExpandOut", "expand_level", "expand_level_ref",
           "expand_level_cuda", "expand_level_meta", "prune_table", "extract_rows",
           "select_ending_at", "count_ending_at"]


class ExpandOut(NamedTuple):
    frontier: PathSet         # level+1 frontier (spliced candidates excluded)
    nbrs: torch.Tensor        # (cap, D) raw neighbor matrix (for splice extraction)
    splice_hit: torch.Tensor  # (cap, D) bool -- candidates redirected to splice


def prune_table(slack: torch.Tensor, splice_budget: torch.Tensor) -> torch.Tensor:
    """Stack the two per-vertex int8 prune vectors into the (n+1, 2)
    table :func:`expand_level` consumes -- column 0 = Lemma-3.1 slack,
    column 1 = splice budget (-1 = no dominating query)."""
    return torch.stack([slack, splice_budget], dim=1)


def expand_level(verts: torch.Tensor, count: torch.Tensor,
                 ell_idx: torch.Tensor, prune_tbl: torch.Tensor,
                 stop_vertex: int, *, level: int, budget: int,
                 out_cap: int, arm: ArmLike = None) -> ExpandOut:
    """One superstep: expand all level-`level` paths by one hop.

    verts:  (cap, L) int32 frontier paths (cols 0..level used).
    ell_idx: (n, D) int32 padded ELL table (pad = n).
    prune_tbl: (n+1, 2) int8 from :func:`prune_table` -- keep candidate v
            at depth d iff slack[v] >= d; candidates whose splice budget
            covers budget-(level+1) splice instead of expanding.
    stop_vertex: do not expand *from* this vertex (dedicated query
            optimization; pass -2 to disable).
    arm: the kernel arm; by default the one of ``verts``' device.
    """
    fn = {KernelArm.CUDA: expand_level_cuda,
          KernelArm.META: expand_level_meta}.get(
        resolve_arm(verts.device, arm), expand_level_ref)
    return fn(verts, count, ell_idx, prune_tbl, stop_vertex, level=level,
              budget=budget, out_cap=out_cap)


def expand_level_ref(verts: torch.Tensor, count: torch.Tensor,
                     ell_idx: torch.Tensor, prune_tbl: torch.Tensor,
                     stop_vertex: int, *, level: int, budget: int,
                     out_cap: int) -> ExpandOut:
    """The plain version of :func:`expand_level` (any device)."""
    cap = verts.shape[0]
    n = prune_tbl.shape[0] - 1
    D = ell_idx.shape[1]
    device = verts.device
    row_valid = torch.arange(cap, device=device) < count
    # rows past `count` gather row 0 (row_valid masks what they produce)
    last = torch.where(row_valid, verts[:, level], 0)
    nbrs = ell_idx[last]                             # (cap, D)
    valid = (nbrs != n) & row_valid[:, None]
    valid &= (last != stop_vertex)[:, None]
    dup = path_member_ref(verts[:, :level + 1], nbrs) > 0
    pruned = prune_tbl[nbrs]                         # (cap, D, 2) one gather
    keep = valid & ~dup & (pruned[..., 0] >= level + 1)
    remaining = budget - (level + 1)
    splice_hit = keep & (pruned[..., 1] >= remaining)
    expand_mask = keep & ~splice_hit

    # survivors in (row, candidate) order: prefix + new vertex at level+1,
    # gathered straight from the packed slot -> source map
    src, n_out, ovf = compact_index(expand_mask.reshape(-1), out_cap)
    hit = src >= 0
    src = src.clamp(min=0)
    out = verts[src // D]
    out[:, level + 1] = nbrs.reshape(-1)[src]
    out = torch.where(hit[:, None], out, torch.full_like(out, -1))
    return ExpandOut(frontier=PathSet(out, n_out, ovf),
                     nbrs=nbrs, splice_hit=splice_hit)


def expand_level_cuda(verts: torch.Tensor, count: torch.Tensor,
                      ell_idx: torch.Tensor, prune_tbl: torch.Tensor,
                      stop_vertex: int, *, level: int, budget: int,
                      out_cap: int) -> ExpandOut:
    """The fused kernel of :func:`expand_level` (CUDA tensors): one memset
    and one launch, no host sync; the new frontier's count and overflow
    are one int64 pair on the card (``pathset.read_status``)."""
    out, n_out, ovf, nbrs, splice_hit = fused_level_cuda(
        verts, count, ell_idx, prune_tbl, stop_vertex, level=level,
        budget=budget, out_cap=out_cap)
    return ExpandOut(frontier=PathSet(out, n_out, ovf),
                     nbrs=nbrs, splice_hit=splice_hit)


def expand_level_meta(verts: torch.Tensor, count: torch.Tensor,
                      ell_idx: torch.Tensor, prune_tbl: torch.Tensor,
                      stop_vertex: int, *, level: int, budget: int,
                      out_cap: int) -> ExpandOut:
    """The meta arm (the dry run): the fused level's outputs, empty. Its
    bytes by ``PERF.md`` section 6's rule for the fused level, at the most
    the shapes allow (every row valid, every candidate live): the rows,
    their ELL rows and the candidates' prune entries read, ``nbrs``,
    ``splice_hit``, the new frontier and its status written."""
    cap, L = verts.shape
    D = ell_idx.shape[1]
    device = verts.device
    with meta_launch("expand_level", ops=0,
                     nbytes=cap * L * 4 + cap * D * 4 + cap * D * 2
                     + cap * D * 5 + out_cap * L * 4 + 16):
        out = torch.empty((out_cap, L), dtype=torch.int32, device=device)
        frontier = PathSet(out, torch.empty((), dtype=torch.int64,
                                            device=device),
                           torch.empty((), dtype=torch.bool, device=device))
        return ExpandOut(frontier=frontier,
                         nbrs=torch.empty((cap, D), dtype=torch.int32,
                                          device=device),
                         splice_hit=torch.empty((cap, D), dtype=torch.bool,
                                                device=device))


def extract_rows(verts: torch.Tensor, row_mask: torch.Tensor, *,
                 out_cap: int) -> PathSet:
    """Compact the rows of `verts` where row_mask is True."""
    out, n_out, ovf = compact_rows(row_mask, verts, out_cap)
    return PathSet(out, n_out, ovf)


def _ending_at(verts: torch.Tensor, count: torch.Tensor, vertex: int,
               col: int) -> torch.Tensor:
    rows = torch.arange(verts.shape[0], device=verts.device)
    return (rows < count) & (verts[:, col] == vertex)


def count_ending_at(verts: torch.Tensor, count: torch.Tensor, vertex: int,
                    *, col: int) -> torch.Tensor:
    """Number of rows ending (column `col`) at `vertex` -- a mask
    reduction, no compaction and no output buffer."""
    return _ending_at(verts, count, vertex, col).sum()


def select_ending_at(verts: torch.Tensor, count: torch.Tensor, vertex: int,
                     *, col: int, out_cap: int) -> PathSet:
    """Rows whose path ends (column `col`) at `vertex` (forward-complete paths)."""
    out, n_out, ovf = compact_rows(_ending_at(verts, count, vertex, col),
                                   verts, out_cap)
    return PathSet(out, n_out, ovf)
