"""Vertex comparisons of path rows: ``path_member``, ``rowwise_overlap``,
``path_overlap`` and the join-validity matrices built on it.

Counterpart of ``repro/kernels/path_join``: the ``*_ref`` functions are the
plain PyTorch versions, the ``*_cuda`` functions wrap ``csrc/path_join.cu``
(which says what each kernel replaces, what bounds it and how it is
designed), and ``path_member`` / ``rowwise_overlap`` / ``path_overlap``
pick the arm from the tensors' device. ``keyed_join_valid`` and
``splice_join_valid`` are the reference's tensor code around
``path_overlap``. Inputs may be row slices of wider path matrices: the
kernels take a row stride, and only the last dimension must be contiguous.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from ..registry import (LAUNCHES, ArmLike, KernelArm, check_tensor,
                        resolve_arm)

__all__ = ["path_member", "path_member_ref", "path_member_cuda",
           "rowwise_overlap", "rowwise_overlap_ref", "rowwise_overlap_cuda",
           "path_overlap", "path_overlap_ref", "path_overlap_cuda",
           "keyed_join_valid", "splice_join_valid"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "path_member_launch": [_P, _L, _P, _L, _P, _I, _I, _I, _P],
    "rowwise_overlap_launch": [_P, _L, _P, _L, _P, _I, _I, _I, _P],
    "path_overlap_launch": [_P, _L, _P, _L, _P, _I, _I, _I, _I, _P],
}


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
    LAUNCHES["path_member"] += 1
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
    LAUNCHES["rowwise_overlap"] += 1
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
    LAUNCHES["path_overlap"] += 1
    return out


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
