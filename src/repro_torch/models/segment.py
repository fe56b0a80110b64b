"""Row gathers and segmented reductions that add in a fixed order.

The GNN's message passing (:mod:`.gnn`) gathers node rows by an edge
list and adds the messages of each destination; the recsys model's
embedding lookups (:mod:`.recsys`) gather table rows whose gradients add
up per id. A scatter-add on CUDA (``index_add_``, and the backward of
``table[idx]``) adds with atomics in no fixed order, so two runs of one
training step could differ in the last bit, and a resumed run would not
repeat the uninterrupted one. Here every such sum runs over rows sorted
by their index (a stable sort), one segment after another, each in the
rows' order:

  ``Segments(idx, n)`` -- an index vector into ``n`` rows; on first use
                          sorted once: ``perm`` (the stable argsort), the
                          indices present (``ids``, a few copies of sizes
                          to the host), their ``counts``, and the summing
                          passes over their runs in sorted order;
  ``Segments.reduce``  -- sum, mean or max of rows already in that sorted
                          order: ``torch.segment_reduce`` over the runs of
                          the indices present (on the card one thread a
                          (segment, column) adds its run in turn; the
                          sum's backward is a gather, the max's shares a
                          segment's gradient among its tied rows), a run
                          longer than ``CHUNK`` rows in chunks whose sums
                          a second pass adds, placed into zeros with
                          ``index_copy`` (each row written once);
  ``Segments.gather``  -- ``table.index_select(0, idx)``, whose backward
                          adds the gradient rows of each index through the
                          same sorted segments (or, for rows gathered
                          already in sorted order, through them as they
                          stand).

A stable sort keeps each segment's rows in their original order, the
order in which the JAX package's ``segment_sum`` adds them on the CPU
(segments of up to ``CHUNK`` rows are added in exactly that order).
Only the indices present are reduced, so a table of millions of rows
whose batch touches a few hundred thousand pays for those alone (and a
zero fill).
"""
from __future__ import annotations

from functools import cached_property
from typing import Optional

import torch

__all__ = ["Segments", "gather_rows", "CHUNK"]

# the longest run one summing pass adds: ``torch.segment_reduce`` adds a
# segment's rows one after another (on the card in one thread a column),
# so a skewed segment (a hub's in-edges, a popular id's gradient rows)
# would take its length in serial steps; longer segments are summed in
# chunks of CHUNK rows, then the chunks' sums, in order
CHUNK = 256


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    """[0, c0, c0 + c1, ...] (int64) of run lengths ``counts``."""
    out = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                      device=counts.device)
    torch.cumsum(counts, 0, out=out[1:])
    return out


class Segments:
    """An index vector ``idx`` (int, 1-D, values in ``[0, n)``) into ``n``
    rows. The sort is made on first use, so a gather under ``no_grad``
    never pays for it."""

    def __init__(self, idx: torch.Tensor, n: int):
        self.idx, self.n = idx, int(n)

    @cached_property
    def _sorted(self) -> tuple:
        keys, perm = torch.sort(self.idx, stable=True)
        if keys.device.type == "meta":
            # the dry run traces shapes only: as many runs as the indices
            # allow, summed in one pass (their lengths are data)
            m = min(keys.numel(), self.n)
            runs = torch.empty(m, dtype=torch.int64, device=keys.device)
            return perm, runs, runs, [torch.empty(
                m + 1, dtype=torch.int64, device=keys.device)]
        ids, counts = torch.unique_consecutive(keys, return_counts=True)
        ids = ids.long()                  # index_copy takes int64 indices
        # the summing passes: each pass's offsets; a segment longer than
        # CHUNK rows is cut into chunks of CHUNK, summed, and its chunks'
        # sums summed in the next pass
        passes, offsets, sizes = [], _offsets(counts), counts
        while sizes.numel() and int(sizes.max()) > CHUNK:
            n_chunks = (sizes + CHUNK - 1) // CHUNK
            seg = torch.repeat_interleave(
                torch.arange(sizes.numel(), device=sizes.device), n_chunks)
            first = _offsets(n_chunks)[:-1]
            k = torch.arange(seg.numel(), device=seg.device) - first[seg]
            passes.append(torch.cat([offsets[seg] + k * CHUNK,
                                     offsets[-1:]]))
            offsets, sizes = _offsets(n_chunks), n_chunks
        passes.append(offsets)
        return perm, ids, counts, passes

    @property
    def perm(self) -> torch.Tensor:
        return self._sorted[0]

    @property
    def ids(self) -> torch.Tensor:
        return self._sorted[1]

    @property
    def counts(self) -> torch.Tensor:
        return self._sorted[2]

    def _passes(self, rows: torch.Tensor, op: str) -> torch.Tensor:
        """(S, ...) of ``rows`` in sorted order reduced over the runs of
        the S indices present, by ``op`` (``sum`` or ``max``)."""
        for offsets in self._sorted[3]:
            rows = torch.segment_reduce(rows, op, offsets=offsets, axis=0,
                                        unsafe=True)
        return rows

    def reduce(self, rows: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """(n, ...) of ``rows`` (one per index, in sorted order) reduced per
        segment: ``sum``, ``mean`` (the sum over the count) or ``max`` (0
        where a segment has no finite maximum, as the JAX package's
        ``_segment``); an index with no row gives 0. The gradient of a
        maximum is shared equally among the rows of its segment that equal
        it, as in JAX."""
        if op not in ("sum", "mean", "max"):
            raise ValueError(f"unknown segment op {op!r}")
        if op == "max":
            out = _SegmentMax.apply(rows, self)
            out = torch.where(torch.isfinite(out), out, 0.0)
        else:
            out = self._passes(rows, "sum")
        if op == "mean":
            c = self.counts.to(rows.dtype)
            out = out / c.reshape((-1,) + (1,) * (rows.dim() - 1))
        return rows.new_zeros((self.n,) + tuple(rows.shape[1:])).index_copy(
            0, self.ids, out)

    def gather(self, table: torch.Tensor,
               sorted_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``table.index_select(0, idx)``; the backward adds each index's
        gradient rows in sorted order (``table`` has ``n`` rows).

        With ``sorted_idx``: ``table.index_select(0, sorted_idx)``, rows
        that stand in this vector's sorted order (one per sorted position,
        such as the destinations of edges sorted by destination); the
        backward adds their gradient rows by this vector's segments as they
        stand, with no sort, and keeps ``table``'s rows. A segment past
        them (``n`` larger than the table: the masked edges' extra
        segment) is dropped, so a row keyed there must get no gradient."""
        if sorted_idx is None:
            return _GatherRows.apply(table, self.idx, self, True)
        return _GatherRows.apply(table, sorted_idx, self, False)


class _SegmentMax(torch.autograd.Function):
    """(S, ...) segment maxima of rows in sorted order; the backward shares
    each segment's gradient equally among its rows equal to the maximum
    (counted over the whole segment, across the summing chunks)."""

    @staticmethod
    def forward(ctx, rows, seg: Segments):
        out = seg._passes(rows, "max")
        ctx.seg = seg
        ctx.save_for_backward(rows, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        rows, out = ctx.saved_tensors
        seg = ctx.seg
        at = torch.repeat_interleave(
            torch.arange(seg.counts.numel(), device=rows.device), seg.counts)
        tie = (rows == out.index_select(0, at)).to(grad.dtype)
        share = grad / torch.clamp(seg._passes(tie, "sum"), min=1.0)
        return tie * share.index_select(0, at), None


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, idx, seg: Segments, permute: bool):
        ctx.seg, ctx.permute, ctx.n_rows = seg, permute, table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        seg = ctx.seg
        if ctx.permute:
            grad = grad.index_select(0, seg.perm)
        return seg.reduce(grad)[:ctx.n_rows], None, None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an index tensor of any shape, with the
    fixed-order backward of :meth:`Segments.gather`."""
    rows = Segments(idx.reshape(-1), table.shape[0]).gather(table)
    return rows.reshape(*idx.shape, *table.shape[1:])
