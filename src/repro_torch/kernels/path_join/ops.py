"""Vertex comparisons of path rows: ``path_member``, ``rowwise_overlap``,
``path_overlap`` and the join-validity matrices built on it; and the fused
passes the engine runs them in (one expand level, one join).

Counterpart of ``repro/kernels/path_join``: the ``*_ref`` functions are the
plain PyTorch versions, the ``*_cuda`` functions wrap ``csrc/path_join.cu``
(which says what each kernel replaces, what bounds it and how it is
designed), and ``path_member`` / ``rowwise_overlap`` / ``path_overlap``
pick the arm from the tensors' device. ``keyed_join_valid`` and
``splice_join_valid`` are the reference's tensor code around
``path_overlap``. Inputs may be row slices of wider path matrices: the
kernels take a row stride, and only the last dimension must be contiguous.

``fused_level_cuda`` and ``fused_join_cuda`` launch the passes that hold
``path_member`` and ``rowwise_overlap`` on the card: a whole expand level
and a whole keyed, counting or splice join (``core/enumerate.py`` and
``core/join.py`` hold their plain versions and pick the arm). Each is one
memset and one kernel; a fused level adds one to ``LAUNCHES["path_member"]``
and ``LAUNCHES["level_fused"]``, a fused join to
``LAUNCHES["rowwise_overlap"]`` and ``LAUNCHES["join_fused"]``. Their
count and overflow are words 0 and 1 of one int64 pair on the card
(:func:`packed_status`), read with one copy by ``pathset.read_status``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from ..registry import (ArmLike, KernelArm, check_tensor, count_launch,
                        resolve_arm)

__all__ = ["path_member", "path_member_ref", "path_member_cuda",
           "rowwise_overlap", "rowwise_overlap_ref", "rowwise_overlap_cuda",
           "path_overlap", "path_overlap_ref", "path_overlap_cuda",
           "keyed_join_valid", "splice_join_valid", "fused_level_cuda",
           "fused_join_cuda", "packed_status"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "path_member_launch": [_P, _L, _P, _L, _P, _I, _I, _I, _P],
    "rowwise_overlap_launch": [_P, _L, _P, _L, _P, _I, _I, _I, _P],
    "path_overlap_launch": [_P, _L, _P, _L, _P, _I, _I, _I, _I, _P],
    "expand_level_launch": [_P, _L, _P, _I, _I, _P, _I, _P, _I, _I, _I, _I,
                            _I, _P, _L, _L, _L, _P, _P, _P],
    "join_launch": [_I, _P, _L, _L, _P, _L, _L, _P, _P, _P, _P, _I, _I, _I,
                    _L, _P, _L, _L, _P],
}
# the fused passes' blocks: 8 warps, rows_per_warp frontier rows per warp
# (level) or a pair id per thread (join); their scan state is 3 head
# words and one a block (csrc/path_join.cu)
_FUSED_WARPS, _FUSED_THREADS, _STATE_HEAD = 8, 256, 3
# a level's blocks: a row per warp up to this many blocks, then up to 32
# rows per warp, so that a cap of 2**20 rows launches 8192 blocks, each
# taking a ticket, not 131072
_LEVEL_TILES = 8192
# the joins of ``fused_join_cuda`` and their codes in ``join_launch``
_JOIN_KINDS = {"keyed": 0, "keyed_count": 1, "splice": 2}


def path_member_ref(verts: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """out[i, d] = #{p : cand[i, d] == verts[i, p]}: (N, L), (N, D) int32
    -> (N, D) int32."""
    eq = cand[:, :, None] == verts[:, None, :]
    return eq.sum(dim=2, dtype=torch.int32)


def rowwise_overlap_ref(a_verts: torch.Tensor,
                        b_verts: torch.Tensor) -> torch.Tensor:
    """out[i] = #{(p, q) : A[i, p] == B[i, q], A[i, p] >= 0}: (N, LA),
    (N, LB) int32 -> (N,) int32."""
    eq = (a_verts[:, :, None] == b_verts[:, None, :]) \
        & (a_verts >= 0)[:, :, None]
    return eq.sum(dim=(1, 2), dtype=torch.int32)


def path_overlap_ref(a_verts: torch.Tensor,
                     b_verts: torch.Tensor) -> torch.Tensor:
    """out[i, j] = #{(p, q) : A[i, p] == B[j, q], A[i, p] >= 0}: (NA, LA),
    (NB, LB) int32 -> (NA, NB) int32."""
    eq = (a_verts[:, None, :, None] == b_verts[None, :, None, :]) \
        & (a_verts >= 0)[:, None, :, None]
    return eq.sum(dim=(2, 3), dtype=torch.int32)


def _rows_match(x: torch.Tensor, y: torch.Tensor, what: str) -> None:
    if x.shape[0] != y.shape[0] or x.device != y.device:
        raise ValueError(f"{what}: row counts or devices differ "
                         f"({tuple(x.shape)} on {x.device}, "
                         f"{tuple(y.shape)} on {y.device})")


def path_member_cuda(verts: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Launch the ``path_member`` kernel (contract of the plain version)."""
    check_tensor("verts", verts, torch.int32, 2, strided_rows=True)
    check_tensor("cand", cand, torch.int32, 2, strided_rows=True)
    _rows_match(verts, cand, "path_member")
    N, L = verts.shape
    D = cand.shape[1]
    out = torch.empty((N, D), dtype=torch.int32, device=cand.device)
    if N == 0 or D == 0:
        return out
    if L == 0:
        return out.zero_()
    lib = build.load("path_join", _SIGNATURES)
    stream = torch.cuda.current_stream(cand.device).cuda_stream
    rc = lib.path_member_launch(verts.data_ptr(), verts.stride(0),
                                cand.data_ptr(), cand.stride(0),
                                out.data_ptr(), N, L, D, stream)
    build.check(lib, rc, "path_member")
    count_launch("path_member")
    return out


def rowwise_overlap_cuda(a_verts: torch.Tensor,
                         b_verts: torch.Tensor) -> torch.Tensor:
    """Launch the ``rowwise_overlap`` kernel (contract of the plain
    version)."""
    check_tensor("a_verts", a_verts, torch.int32, 2, strided_rows=True)
    check_tensor("b_verts", b_verts, torch.int32, 2, strided_rows=True)
    _rows_match(a_verts, b_verts, "rowwise_overlap")
    N, LA = a_verts.shape
    LB = b_verts.shape[1]
    out = torch.empty((N,), dtype=torch.int32, device=a_verts.device)
    if N == 0:
        return out
    if LA == 0 or LB == 0:
        return out.zero_()
    lib = build.load("path_join", _SIGNATURES)
    stream = torch.cuda.current_stream(a_verts.device).cuda_stream
    rc = lib.rowwise_overlap_launch(a_verts.data_ptr(), a_verts.stride(0),
                                    b_verts.data_ptr(), b_verts.stride(0),
                                    out.data_ptr(), N, LA, LB, stream)
    build.check(lib, rc, "rowwise_overlap")
    count_launch("rowwise_overlap")
    return out


def path_overlap_cuda(a_verts: torch.Tensor,
                      b_verts: torch.Tensor) -> torch.Tensor:
    """Launch the ``path_overlap`` kernel (contract of the plain version)."""
    check_tensor("a_verts", a_verts, torch.int32, 2, strided_rows=True)
    check_tensor("b_verts", b_verts, torch.int32, 2, strided_rows=True)
    if a_verts.device != b_verts.device:
        raise ValueError(f"path_overlap: tensors lie on {a_verts.device} "
                         f"and {b_verts.device}")
    NA, LA = a_verts.shape
    NB, LB = b_verts.shape
    out = torch.empty((NA, NB), dtype=torch.int32, device=a_verts.device)
    if NA == 0 or NB == 0:
        return out
    if LA == 0 or LB == 0:
        return out.zero_()
    lib = build.load("path_join", _SIGNATURES)
    stream = torch.cuda.current_stream(a_verts.device).cuda_stream
    rc = lib.path_overlap_launch(a_verts.data_ptr(), a_verts.stride(0),
                                 b_verts.data_ptr(), b_verts.stride(0),
                                 out.data_ptr(), NA, NB, LA, LB, stream)
    build.check(lib, rc, "path_overlap")
    count_launch("path_overlap")
    return out


def packed_status(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(count, overflow)`` as 0-d views of words 0 and 1 of an int64
    state: count is word 0, overflow the low byte of word 1 (which the
    kernels set to 0 or 1) read as a bool. No copy and no launch."""
    return state[0], state[1:2].view(torch.bool)[0]


def _fused_buffers(state_words: int, out_shape: tuple, device):
    """One int32 allocation: the scan state (``state_words`` int64 words)
    then the output rows of ``out_shape`` (none for ``()``); returns
    (buffer, state, out)."""
    n_out = out_shape[0] * out_shape[1] if out_shape else 0
    buf = torch.empty((2 * state_words + n_out,), dtype=torch.int32,
                      device=device)
    state = buf[:2 * state_words].view(torch.int64)
    out = buf[2 * state_words:].view(out_shape) if out_shape else None
    return buf, state, out


def _device_count(name: str, x: torch.Tensor, device) -> torch.Tensor:
    """A count argument as a 0-d int64 tensor on ``device`` (no copy when
    it is one already)."""
    if x.dim() != 0 or x.device != device:
        raise ValueError(f"{name}: expected a 0-d tensor on {device}, got "
                         f"shape {tuple(x.shape)} on {x.device}")
    return x if x.dtype == torch.int64 else x.to(torch.int64)


def _rows_per_warp(cap: int) -> int:
    """Frontier rows each warp of the fused level takes (1..32)."""
    return min(32, max(1, -(-cap // (_FUSED_WARPS * _LEVEL_TILES))))


def fused_level_cuda(verts: torch.Tensor, count: torch.Tensor,
                     ell_idx: torch.Tensor, prune_tbl: torch.Tensor,
                     stop_vertex: int, *, level: int, budget: int,
                     out_cap: int):
    """Launch the fused expand level (``csrc/path_join.cu``
    ``expand_level_kernel``): the contract of ``expand_level_ref``.

    Returns ``(out, count, overflow, nbrs, splice_hit)``: the (out_cap, L)
    frontier, its count and overflow (:func:`packed_status`), and the
    (cap, D) neighbour matrix and splice mask."""
    check_tensor("verts", verts, torch.int32, 2, strided_rows=True)
    check_tensor("ell_idx", ell_idx, torch.int32, 2)
    check_tensor("prune_tbl", prune_tbl, torch.int8, 2)
    device = verts.device
    if ell_idx.device != device or prune_tbl.device != device:
        raise ValueError("fused expand level: tensors lie on "
                         f"{device}, {ell_idx.device} and {prune_tbl.device}")
    cap, L = verts.shape
    D = ell_idx.shape[1]
    n = prune_tbl.shape[0] - 1
    if prune_tbl.shape[1] != 2 or prune_tbl.data_ptr() % 2:
        raise ValueError(f"prune_tbl: expected a 2-byte aligned (n+1, 2) "
                         f"table, got {tuple(prune_tbl.shape)}")
    if not 0 <= level < budget or level + 1 >= L:
        raise ValueError(f"level {level} outside a budget of {budget} "
                         f"in paths of {L} columns")
    count = _device_count("count", count, device)
    rows_per_warp = _rows_per_warp(cap)
    tiles = max(1, -(-cap // (_FUSED_WARPS * rows_per_warp)))
    state_words = _STATE_HEAD + tiles
    buf, state, out = _fused_buffers(state_words, (out_cap, L), device)
    nbrs = torch.empty((cap, D), dtype=torch.int32, device=device)
    splice_hit = torch.empty((cap, D), dtype=torch.bool, device=device)
    lib = build.load("path_join", _SIGNATURES)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.expand_level_launch(
        verts.data_ptr(), verts.stride(0), count.data_ptr(), cap, L,
        ell_idx.data_ptr(), D, prune_tbl.data_ptr(), n, int(stop_vertex),
        level, budget - (level + 1), rows_per_warp, buf.data_ptr(),
        buf.numel() * 4, state_words, out_cap, nbrs.data_ptr(),
        splice_hit.data_ptr(), stream)
    build.check(lib, rc, "expand_level")
    count_launch("path_member", "level_fused")
    return (out, *packed_status(state), nbrs, splice_hit)


def fused_join_cuda(kind: str, a_verts: torch.Tensor, b_verts: torch.Tensor,
                    *, a_len: int, b_len: int, out_cap: int, width: int = 0,
                    lo: torch.Tensor = None, offs: torch.Tensor = None,
                    p_count: torch.Tensor = None,
                    c_count: torch.Tensor = None):
    """Launch the fused join (``csrc/path_join.cu`` ``join_kernel``).

    ``kind`` is ``"keyed"`` (A rows sorted by key, B rows, the bucket
    starts ``lo`` and inclusive pair offsets ``offs`` of
    ``core/join.py``), ``"keyed_count"`` (the same, counted only) or
    ``"splice"`` (prefix rows, child rows, their counts ``p_count`` and
    ``c_count``). ``a_len`` / ``b_len`` columns of each half are compared
    and assembled. Returns ``(out, count, overflow)``, ``out`` (out_cap,
    width) and None for the counting join."""
    if kind not in _JOIN_KINDS:
        raise ValueError(f"unknown join kind {kind!r}; valid kinds: "
                         f"{' | '.join(_JOIN_KINDS)}")
    check_tensor("a_verts", a_verts, torch.int32, 2, strided_rows=True)
    check_tensor("b_verts", b_verts, torch.int32, 2, strided_rows=True)
    device = a_verts.device
    if b_verts.device != device:
        raise ValueError(f"fused join: tensors lie on {device} and "
                         f"{b_verts.device}")
    if not (0 < a_len <= a_verts.shape[1] and 0 < b_len <= b_verts.shape[1]):
        raise ValueError(f"fused join: halves of {a_len} and {b_len} columns "
                         f"from rows of {a_verts.shape[1]} and "
                         f"{b_verts.shape[1]}")
    keyed = kind != "splice"
    if keyed:
        for name, x in (("lo", lo), ("offs", offs)):
            check_tensor(name, x, torch.int64, 1)
            if x.shape[0] != b_verts.shape[0] or x.device != device:
                raise ValueError(f"{name}: expected ({b_verts.shape[0]},) on "
                                 f"{device}, got {tuple(x.shape)} on "
                                 f"{x.device}")
        if a_verts.shape[0] == 0:
            raise ValueError("fused keyed join: no A rows")
        p_count = c_count = None
        need = a_len + b_len - 1
    else:
        p_count = _device_count("p_count", p_count, device)
        c_count = _device_count("c_count", c_count, device)
        need = a_len + b_len
    if kind != "keyed_count" and width < need:
        raise ValueError(f"fused {kind} join: rows of {need} vertices do not "
                         f"fit a width of {width}")
    tiles = max(1, -(-out_cap // _FUSED_THREADS))
    state_words = _STATE_HEAD + tiles
    shape = (out_cap, width) if kind != "keyed_count" else ()
    buf, state, out = _fused_buffers(state_words, shape, device)
    ptr = (lambda x: 0 if x is None else x.data_ptr())
    lib = build.load("path_join", _SIGNATURES)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.join_launch(
        _JOIN_KINDS[kind], a_verts.data_ptr(), a_verts.stride(0),
        a_verts.shape[0], b_verts.data_ptr(), b_verts.stride(0),
        b_verts.shape[0], ptr(lo), ptr(offs), ptr(p_count), ptr(c_count),
        a_len, b_len, width, out_cap, buf.data_ptr(), buf.numel() * 4,
        state_words, stream)
    build.check(lib, rc, f"{kind} join")
    count_launch("rowwise_overlap", "join_fused")
    return (out, *packed_status(state))


def path_member(verts: torch.Tensor, cand: torch.Tensor,
                arm: ArmLike = None) -> torch.Tensor:
    """(N, L) prefixes x (N, D) candidates -> (N, D) int32 member counts."""
    if resolve_arm(cand.device, arm) is KernelArm.CUDA:
        return path_member_cuda(verts, cand)
    return path_member_ref(verts, cand)


def rowwise_overlap(a_verts: torch.Tensor, b_verts: torch.Tensor,
                    arm: ArmLike = None) -> torch.Tensor:
    """Row-aligned shared-vertex counts: (N, LA) x (N, LB) -> (N,) int32."""
    if resolve_arm(a_verts.device, arm) is KernelArm.CUDA:
        return rowwise_overlap_cuda(a_verts, b_verts)
    return rowwise_overlap_ref(a_verts, b_verts)


def path_overlap(a_verts: torch.Tensor, b_verts: torch.Tensor,
                 arm: ArmLike = None) -> torch.Tensor:
    """All-pairs shared-vertex counts: (NA, LA) x (NB, LB) -> (NA, NB)."""
    if resolve_arm(a_verts.device, arm) is KernelArm.CUDA:
        return path_overlap_cuda(a_verts, b_verts)
    return path_overlap_ref(a_verts, b_verts)


def keyed_join_valid(a_verts: torch.Tensor, a_col: int,
                     b_verts: torch.Tensor, b_col: int,
                     arm: ArmLike = None) -> torch.Tensor:
    """(NA, NB) bool: last vertices match and it is the only shared vertex."""
    ov = path_overlap(a_verts[:, :a_col + 1], b_verts[:, :b_col + 1], arm)
    key = a_verts[:, a_col][:, None] == b_verts[:, b_col][None, :]
    key &= (a_verts[:, a_col] >= 0)[:, None]
    return key & (ov == 1)


def splice_join_valid(p_verts: torch.Tensor, p_col: int,
                      c_verts: torch.Tensor, c_col: int,
                      arm: ArmLike = None) -> torch.Tensor:
    """(NP, NC) bool: prefix and cached suffix share no vertex."""
    ov = path_overlap(p_verts[:, :p_col + 1], c_verts[:, :c_col + 1], arm)
    valid_p = (p_verts[:, 0] >= 0)[:, None]
    valid_c = (c_verts[:, 0] >= 0)[None, :]
    return (ov == 0) & valid_p & valid_c
