"""Fixed-capacity path buffers (``PathSet``) and compaction utilities.

Counterpart of ``repro/core/pathset.py``. A PathSet stores up to ``cap``
paths as a dense int32 matrix on the device. The first ``count`` rows are
valid and packed at the front; unused cells are -1. ``count`` and
``overflow`` stay 0-d device tensors, so reading them (``int(ps.count)``)
is a host sync, made where the engine needs the value, as in the
reference; :func:`read_status` reads both with one copy.
``HostPathSet`` / ``offload`` / ``upload`` are the cross-batch cache's
storage form and its round trip.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["PathSet", "HostPathSet", "empty", "singleton", "compact_index",
           "compact_rows", "concat", "to_host", "offload", "upload",
           "pathset_nbytes", "read_status"]

# per-PathSet bookkeeping charged on top of the vertex matrix (count +
# overflow scalars); shared by HostPathSet.nbytes and the cache's
# pre-transfer size estimate so the two can never diverge
PATHSET_BOOKKEEPING_BYTES = 16


def pathset_nbytes(cap: int, width: int, itemsize: int = 4) -> int:
    """Bytes one (cap, width) path buffer accounts for -- the single
    byte-math used both for ``HostPathSet.nbytes`` (LRU budget accounting)
    and for size estimates taken from device shapes before any transfer."""
    return int(cap) * int(width) * int(itemsize) + PATHSET_BOOKKEEPING_BYTES


class PathSet(NamedTuple):
    verts: torch.Tensor     # (cap, L) int32, row i cols 0..length_i are vertices
    count: torch.Tensor     # () int64 -- number of valid (packed) rows
    overflow: torch.Tensor  # () bool -- True if rows were dropped to fit cap

    @property
    def cap(self) -> int:
        return self.verts.shape[0]

    @property
    def width(self) -> int:
        return self.verts.shape[1]


def empty(cap: int, width: int, device) -> PathSet:
    return PathSet(verts=torch.full((cap, width), -1, dtype=torch.int32,
                                    device=device),
                   count=torch.zeros((), dtype=torch.int64, device=device),
                   overflow=torch.zeros((), dtype=torch.bool, device=device))


def singleton(vertex: int, width: int, device) -> PathSet:
    """PathSet holding the single length-0 path [vertex]."""
    ps = empty(1, width, device)
    ps.verts[0, 0] = vertex
    return PathSet(ps.verts, torch.ones((), dtype=torch.int64, device=device),
                   ps.overflow)


def _packed(count: torch.Tensor, overflow: torch.Tensor) -> bool:
    """True where overflow is the low byte of the int64 word after count
    (the fused kernels' status pair, ``path_join.ops.packed_status``)."""
    return (count.dtype == torch.int64 and overflow.dtype == torch.bool
            and count.dim() == 0 and overflow.dim() == 0
            and count.device == overflow.device
            and overflow.untyped_storage().data_ptr()
            == count.untyped_storage().data_ptr()
            and overflow.data_ptr() == count.data_ptr() + 8)


def read_status(count: torch.Tensor, overflow: torch.Tensor
                ) -> tuple[int, bool]:
    """``(int(count), bool(overflow))``: where a fused kernel wrote them
    (views of one int64 pair on the card), with one device-to-host copy."""
    if _packed(count, overflow):
        n, ovf = torch.as_strided(count, (2,), (1,)).tolist()
        return n, bool(ovf)
    return int(count), bool(overflow)


def compact_index(mask: torch.Tensor, out_cap: int):
    """Source row of each packed output slot.

    mask: (N,) bool. Returns ``(src, count, overflow)``: ``src`` is
    (out_cap,) int64 holding, in order, the indices where mask is True
    (-1 past the last one); masked rows beyond out_cap are dropped
    (overflow=True) and ``count`` is clamped to out_cap.
    """
    device = mask.device
    pos = torch.cumsum(mask, dim=0, dtype=torch.int64) - 1
    total = pos[-1] + 1 if mask.shape[0] > 0 else \
        torch.zeros((), dtype=torch.int64, device=device)
    # rejected rows all land on the dump slot out_cap, which is cut off:
    # a plain assignment, whichever duplicate wins there is discarded
    dest = torch.where(mask & (pos < out_cap), pos,
                       torch.full_like(pos, out_cap))
    src = torch.full((out_cap + 1,), -1, dtype=torch.int64, device=device)
    src[dest] = torch.arange(mask.shape[0], device=device)
    return src[:out_cap], torch.clamp(total, max=out_cap), total > out_cap


def compact_rows(mask: torch.Tensor, payload: torch.Tensor, out_cap: int,
                 fill: int = -1):
    """Pack the payload rows where mask is True into (out_cap, ...).

    mask: (N,) bool; payload: (N, ...) -- returns (out, count, overflow).
    Rows beyond out_cap are dropped (overflow=True).
    """
    src, count, overflow = compact_index(mask, out_cap)
    hit = src >= 0
    out = payload[src.clamp(min=0)] if payload.shape[0] else \
        payload.new_full((out_cap,) + payload.shape[1:], fill)
    shape = (out_cap,) + (1,) * (payload.dim() - 1)
    out = torch.where(hit.view(shape), out, torch.full_like(out, fill))
    return out, count, overflow


def concat(sets: list[PathSet]) -> PathSet:
    """Concatenate packed PathSets (same width) into one packed PathSet:
    the valid rows of each, in order, in a buffer of the summed capacity."""
    sets = [s for s in sets if s is not None]
    if not sets:
        raise ValueError("concat of no PathSets")
    if len(sets) == 1:
        return sets[0]
    verts = torch.cat([s.verts for s in sets])
    device = verts.device
    valid = torch.cat([torch.arange(s.cap, device=device) < s.count
                       for s in sets])
    out, count, _ = compact_rows(valid, verts, verts.shape[0])
    overflow = torch.stack([s.overflow for s in sets]).any()
    return PathSet(out, count, overflow)


def to_host(ps: PathSet) -> np.ndarray:
    """Valid rows as a host numpy array (n, L)."""
    return ps.verts[:int(ps.count)].cpu().numpy()


class HostPathSet(NamedTuple):
    """Host copy of a PathSet (the cross-batch cache's storage form).

    The full padded buffer is kept (not just the valid rows) so an upload
    restores the exact capacity bucket of the original materialization.
    """

    verts: np.ndarray   # (cap, L) int32
    count: int
    overflow: bool

    @property
    def nbytes(self) -> int:
        return pathset_nbytes(self.verts.shape[0], self.verts.shape[1],
                              self.verts.itemsize)

    @property
    def cap(self) -> int:
        return self.verts.shape[0]


def offload(ps: PathSet) -> HostPathSet:
    """Device -> host copy preserving capacity, count and overflow (a copy
    on the CPU too: the entry never shares memory with a batch's tensors)."""
    return HostPathSet(verts=ps.verts.to("cpu", copy=True).numpy(),
                       count=int(ps.count),
                       overflow=bool(ps.overflow))


def upload(hps: HostPathSet, device) -> PathSet:
    """Host -> ``device`` inverse of :func:`offload`, with the port's
    dtypes (int32 vertices, int64 count, bool overflow)."""
    return PathSet(verts=torch.from_numpy(hps.verts).to(device, copy=True),
                   count=torch.tensor(hps.count, dtype=torch.int64,
                                      device=device),
                   overflow=torch.tensor(hps.overflow, dtype=torch.bool,
                                         device=device))
