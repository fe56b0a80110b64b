"""Path concatenation ⊕ (Def 3.1) as fixed-capacity sort/searchsorted joins.

Counterpart of ``repro/core/join.py`` (its kernel route). Two flavours:

  * keyed_join   -- the bidirectional final join: forward paths of length
                    exactly `a` matched with backward paths on the shared
                    last vertex (hash join -> stable sort + searchsorted
                    bucket join; each output path is produced exactly once).
  * cross_join   -- the splice join: (prefix x cached child suffix), no key
                    (the prefix's appended vertex == child's source).

Both enumerate pair ids into an `out_cap` buffer with an overflow flag,
assemble the concatenated vertex rows, and check simple-path validity with
``rowwise_overlap`` over the *half* rows:

  * keyed join : both halves are simple and share the key vertex, so the
    assembled row has a duplicate <=> overlap(A[:a+1], B[:b+1]) >= 2,
    i.e. valid <=> key match & overlap == 1.
  * cross join : prefix and child are each simple, so a duplicate
    <=> overlap(prefix, child) >= 1, i.e. valid <=> overlap == 0.

Pair positions and counts are int64 throughout.

Each join picks its arm by the device: on the card, after the keyed
join's pair setup (two ``searchsorted`` and a ``cumsum``), the pair
mapping, the overlap test, the assembly and the compaction are one fused
kernel (``*_cuda``, one memset and one launch); elsewhere the plain
PyTorch composition around ``rowwise_overlap_ref`` and ``compact_rows``
(``*_ref``). The two agree bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.path_join.ops import fused_join_cuda, rowwise_overlap_ref
from ..kernels.registry import ArmLike, KernelArm, resolve_arm
from .pathset import PathSet, compact_rows

__all__ = ["sort_by_last", "keyed_join", "keyed_join_count", "cross_join",
           "keyed_join_ref", "keyed_join_count_ref", "cross_join_ref",
           "keyed_join_cuda", "keyed_join_count_cuda", "cross_join_cuda",
           "SortedSide"]

_BIG_KEY = 2**31 - 1   # sorts invalid rows last
_NO_KEY = -7           # a probe key that never matches


class SortedSide(NamedTuple):
    verts: torch.Tensor   # (cap, L) rows sorted by key (invalid rows last)
    keys: torch.Tensor    # (cap,) sorted keys (invalid = big sentinel)
    count: torch.Tensor


def sort_by_last(verts: torch.Tensor, count: torch.Tensor, *,
                 col: int) -> SortedSide:
    cap = verts.shape[0]
    valid = torch.arange(cap, device=verts.device) < count
    keys = torch.where(valid, verts[:, col], _BIG_KEY)
    # stable, as jnp.argsort: equal keys keep their row order, so the join
    # emits rows in the reference's order
    order = torch.argsort(keys, stable=True)
    return SortedSide(verts=verts[order], keys=keys[order].contiguous(),
                      count=count)


def _pair_setup(a: SortedSide, b_verts: torch.Tensor,
                b_count: torch.Tensor, b_col: int):
    """The key buckets: for each B row, the first A row with its key
    (``lo``) and the inclusive end of its pair ids (``offs``, int64)."""
    device = b_verts.device
    b_cap = b_verts.shape[0]
    b_valid = torch.arange(b_cap, device=device) < b_count
    b_keys = torch.where(b_valid, b_verts[:, b_col], _NO_KEY).contiguous()
    lo = torch.searchsorted(a.keys, b_keys, right=False)
    hi = torch.searchsorted(a.keys, b_keys, right=True)
    offs = torch.cumsum((hi - lo) * b_valid, dim=0, dtype=torch.int64)
    return lo, offs


def _enumerate_pairs(a: SortedSide, b_verts: torch.Tensor,
                     b_count: torch.Tensor, b_col: int, out_cap: int):
    """Key-bucket pair enumeration shared by the materializing and
    counting keyed joins: map pair id i -> (A row, B row) over rows
    sharing the last vertex. Returns (a_pos, b_idx, pair_valid, total)
    with pair ids beyond out_cap dropped (total still exact).
    """
    device = b_verts.device
    b_cap = b_verts.shape[0]
    lo, offs = _pair_setup(a, b_verts, b_count, b_col)
    total = offs[-1] if b_cap > 0 else \
        torch.zeros((), dtype=torch.int64, device=device)

    i = torch.arange(out_cap, device=device)
    pair_valid = i < torch.clamp(total, max=out_cap)
    b_idx = torch.searchsorted(offs, i, right=True)
    b_idx = torch.clamp(b_idx, max=b_cap - 1)
    prev = torch.where(b_idx > 0, offs[torch.clamp(b_idx - 1, min=0)], 0)
    a_pos = lo[b_idx] + (i - prev)
    a_pos = torch.clamp(a_pos, 0, a.verts.shape[0] - 1)
    return a_pos, b_idx, pair_valid, total


def _splice_pairs(p_count: torch.Tensor, c_count: torch.Tensor,
                  out_cap: int, device):
    """Splice-join pair enumeration: pair id i -> (prefix i // c_count,
    child i % c_count). Returns (p_idx, c_idx, pair_valid, total)."""
    i = torch.arange(out_cap, device=device)
    total = p_count * c_count
    pair_valid = i < torch.clamp(total, max=out_cap)
    denom = torch.clamp(c_count, min=1)
    p_idx = torch.minimum(i // denom, torch.clamp(p_count - 1, min=0))
    c_idx = torch.minimum(i % denom, torch.clamp(c_count - 1, min=0))
    return p_idx, c_idx, pair_valid, total


def _assemble_keyed(a: SortedSide, b_verts: torch.Tensor, a_pos, b_idx,
                    pair_valid, a_col: int, b_col: int, width: int):
    """Rows A[0..a_col] ++ reversed(B[0..b_col-1]) and their validity."""
    a_rows = a.verts[a_pos][:, :a_col + 1]
    b_full = b_verts[b_idx][:, :b_col + 1]                  # incl. key vertex
    assembled = torch.full((a_pos.shape[0], width), -1, dtype=torch.int32,
                           device=b_verts.device)
    assembled[:, :a_col + 1] = a_rows
    assembled[:, a_col + 1:a_col + 1 + b_col] = b_full[:, :b_col].flip(1)
    assembled = torch.where(pair_valid[:, None], assembled, -1)
    ok = pair_valid & (rowwise_overlap_ref(a_rows, b_full) == 1)
    return assembled, ok


def _cuda(device, arm: ArmLike) -> bool:
    return resolve_arm(device, arm) is KernelArm.CUDA


def keyed_join(a: SortedSide, b_verts: torch.Tensor, b_count: torch.Tensor,
               *, a_col: int, b_col: int, out_cap: int, out_width: int,
               arm: ArmLike = None) -> PathSet:
    """⊕ join: A rows (forward, last col = a_col) with B rows (backward,
    last col = b_col) sharing the last vertex.

    Output row = A[0..a_col] ++ reversed(B[0..b_col-1])   (B's join vertex
    and direction folded away), so out length = a_col + b_col hops.
    """
    fn = keyed_join_cuda if _cuda(b_verts.device, arm) else keyed_join_ref
    return fn(a, b_verts, b_count, a_col=a_col, b_col=b_col, out_cap=out_cap,
              out_width=out_width)


def keyed_join_ref(a: SortedSide, b_verts: torch.Tensor,
                   b_count: torch.Tensor, *, a_col: int, b_col: int,
                   out_cap: int, out_width: int) -> PathSet:
    """The plain version of :func:`keyed_join` (any device)."""
    a_pos, b_idx, pair_valid, total = _enumerate_pairs(
        a, b_verts, b_count, b_col, out_cap)
    assembled, ok = _assemble_keyed(a, b_verts, a_pos, b_idx, pair_valid,
                                    a_col, b_col, out_width)
    out, n_out, ovf = compact_rows(ok, assembled, out_cap)
    return PathSet(out, n_out, ovf | (total > out_cap))


def keyed_join_cuda(a: SortedSide, b_verts: torch.Tensor,
                    b_count: torch.Tensor, *, a_col: int, b_col: int,
                    out_cap: int, out_width: int) -> PathSet:
    """:func:`keyed_join` on the card: the pair setup, then one fused
    kernel (one memset and one launch)."""
    lo, offs = _pair_setup(a, b_verts, b_count, b_col)
    out, n_out, ovf = fused_join_cuda(
        "keyed", a.verts, b_verts, a_len=a_col + 1, b_len=b_col + 1,
        out_cap=out_cap, width=out_width, lo=lo, offs=offs)
    return PathSet(out, n_out, ovf)


def keyed_join_count(a: SortedSide, b_verts: torch.Tensor,
                     b_count: torch.Tensor, *, a_col: int, b_col: int,
                     pair_cap: int, arm: ArmLike = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Count ⊕-join results without assembling an output PathSet.

    Same pair enumeration and simple-path filter as :func:`keyed_join`,
    but no output buffer and no compaction. Returns ``(n_results,
    overflow)``; overflow means the raw pair count exceeded ``pair_cap``
    and the caller must retry larger.
    """
    fn = keyed_join_count_cuda if _cuda(b_verts.device, arm) \
        else keyed_join_count_ref
    return fn(a, b_verts, b_count, a_col=a_col, b_col=b_col,
              pair_cap=pair_cap)


def keyed_join_count_ref(a: SortedSide, b_verts: torch.Tensor,
                         b_count: torch.Tensor, *, a_col: int, b_col: int,
                         pair_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`keyed_join_count` (any device)."""
    a_pos, b_idx, pair_valid, total = _enumerate_pairs(
        a, b_verts, b_count, b_col, pair_cap)
    a_rows = a.verts[a_pos][:, :a_col + 1]
    b_full = b_verts[b_idx][:, :b_col + 1]
    ok = pair_valid & (rowwise_overlap_ref(a_rows, b_full) == 1)
    return ok.sum(), total > pair_cap


def keyed_join_count_cuda(a: SortedSide, b_verts: torch.Tensor,
                          b_count: torch.Tensor, *, a_col: int, b_col: int,
                          pair_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`keyed_join_count` on the card: the pair setup, then one
    fused kernel (one memset and one launch; one atomic add a warp)."""
    lo, offs = _pair_setup(a, b_verts, b_count, b_col)
    _, n, ovf = fused_join_cuda(
        "keyed_count", a.verts, b_verts, a_len=a_col + 1, b_len=b_col + 1,
        out_cap=pair_cap, lo=lo, offs=offs)
    return n, ovf


def cross_join(p_verts: torch.Tensor, p_count: torch.Tensor,
               c_verts: torch.Tensor, c_count: torch.Tensor,
               *, p_col: int, c_col: int, out_cap: int,
               out_width: int, arm: ArmLike = None) -> PathSet:
    """Splice join: every prefix (cols 0..p_col) × every cached child path
    (cols 0..c_col; child path starts at the spliced vertex).

    Output row = prefix ++ child, out length = (p_col) + 1 + c_col hops
    counting the prefix->child edge.
    """
    fn = cross_join_cuda if _cuda(p_verts.device, arm) else cross_join_ref
    return fn(p_verts, p_count, c_verts, c_count, p_col=p_col, c_col=c_col,
              out_cap=out_cap, out_width=out_width)


def cross_join_ref(p_verts: torch.Tensor, p_count: torch.Tensor,
                   c_verts: torch.Tensor, c_count: torch.Tensor,
                   *, p_col: int, c_col: int, out_cap: int,
                   out_width: int) -> PathSet:
    """The plain version of :func:`cross_join` (any device)."""
    device = p_verts.device
    p_idx, c_idx, pair_valid, total = _splice_pairs(p_count, c_count,
                                                    out_cap, device)
    p_rows = p_verts[p_idx][:, :p_col + 1]
    c_rows = c_verts[c_idx][:, :c_col + 1]
    assembled = torch.full((out_cap, out_width), -1, dtype=torch.int32,
                           device=device)
    assembled[:, :p_col + 1] = p_rows
    assembled[:, p_col + 1:p_col + 2 + c_col] = c_rows
    assembled = torch.where(pair_valid[:, None], assembled, -1)

    ok = pair_valid & (rowwise_overlap_ref(p_rows, c_rows) == 0)
    out, n_out, ovf = compact_rows(ok, assembled, out_cap)
    return PathSet(out, n_out, ovf | (total > out_cap))


def cross_join_cuda(p_verts: torch.Tensor, p_count: torch.Tensor,
                    c_verts: torch.Tensor, c_count: torch.Tensor,
                    *, p_col: int, c_col: int, out_cap: int,
                    out_width: int) -> PathSet:
    """:func:`cross_join` on the card: one fused kernel (one memset and
    one launch), both counts read on the device."""
    out, n_out, ovf = fused_join_cuda(
        "splice", p_verts, c_verts, a_len=p_col + 1, b_len=c_col + 1,
        out_cap=out_cap, width=out_width, p_count=p_count, c_count=c_count)
    return PathSet(out, n_out, ovf)
