"""Fused MS-BFS level (``msbfs_step``), the single packed hop
(``msbfs_hop_packed``) and the bit packing helpers.

Counterpart of ``repro/kernels/msbfs_expand``: ``msbfs_step_ref`` and
``msbfs_expand_ref`` are the plain PyTorch versions, ``msbfs_step_cuda``
and ``msbfs_expand_cuda`` the wrappers of the CUDA kernels in
``csrc/msbfs_step.cu`` (which says what each replaces, what bounds it and
how it is designed), and ``msbfs_step`` / ``msbfs_hop_packed`` pick the arm
from the tensors' device (:mod:`repro_torch.kernels.registry`;
``msbfs_step_meta`` on ``meta`` tensors, for the dry run).

Packed words are ``torch.int32`` with ``pack_bits``' bit layout (bit b of
word w is column w*32+b, little endian within the word); the kernel reads
them as ``uint32``. PyTorch on the CPU lacks ``~``, ``>>`` and ``max`` for
``torch.uint32``, so int32 is the storage type; words are built in int64
and wrapped into the int32 range explicitly, and right shifts of int32
(arithmetic) are masked after shifting.

Both arms of ``msbfs_step`` have one contract: ``visited`` and ``dist``
are updated in place, and the new frontier comes back as a fresh
``(V+1, W)`` tensor whose sentinel row V is zero, ready to be the next
level's input. ``msbfs_hop_packed`` writes nothing it is given: it ignores
row V of its input frontier (the reference zeroes a copy of it) and
returns a fresh ``(V+1, W)`` tensor whose row V is zero.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from ..registry import (ArmLike, KernelArm, check_tensor, count_launch,
                        meta_launch, resolve_arm)

__all__ = ["pack_bits", "unpack_bits", "wrap_int32", "msbfs_step",
           "msbfs_step_ref", "msbfs_step_cuda", "msbfs_step_meta",
           "msbfs_hop_packed",
           "msbfs_expand_ref", "msbfs_expand_cuda"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"msbfs_step_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
               "msbfs_expand_launch": [_P, _P, _P, _I, _I, _I, _P]}


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(V, S) bool -> (V, ceil(S/32)) int32 words (little endian)."""
    V, S = bits.shape
    W = -(-S // 32)
    padded = torch.zeros((V, W * 32), dtype=torch.bool, device=bits.device)
    padded[:, :S] = bits
    padded = padded.view(V, W, 32)
    acc = torch.zeros((V, W), dtype=torch.int64, device=bits.device)
    for b in range(32):
        acc |= padded[:, :, b].to(torch.int64) << b
    return wrap_int32(acc)


def unpack_bits(words: torch.Tensor, S: int) -> torch.Tensor:
    """(V, W) int32 words -> (V, S) bool."""
    V, W = words.shape
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1   # mask after the shift
    return bits.reshape(V, W * 32)[:, :S].bool()


def msbfs_step_ref(ell_idx: torch.Tensor, frontier: torch.Tensor,
                   visited: torch.Tensor, dist: torch.Tensor,
                   hop: int) -> torch.Tensor:
    """Plain version of the fused level (same contract as the kernel).

    ell_idx  : (V, D) int32 in-neighbour table, pad = V
    frontier : (V+1, W) int32 words of level hop-1, row V = 0
    visited  : (V, W) int32 words reached so far -- ``|= new`` in place
    dist     : (V, W*32) int8 -- ``hop`` written in place where a new bit
               was set
    Returns the new frontier (V+1, W) int32, row V = 0.
    """
    V, D = ell_idx.shape
    W = frontier.shape[1]
    acc = torch.zeros((V, W), dtype=torch.int32, device=frontier.device)
    for d in range(D):
        acc |= frontier[ell_idx[:, d]]
    new = acc & ~visited
    visited |= new
    dist.masked_fill_(unpack_bits(new, W * 32), hop)
    return torch.cat([new, torch.zeros((1, W), dtype=torch.int32,
                                       device=new.device)])


def msbfs_step_cuda(ell_idx: torch.Tensor, frontier: torch.Tensor,
                    visited: torch.Tensor, dist: torch.Tensor,
                    hop: int) -> torch.Tensor:
    """Launch ``csrc/msbfs_step.cu`` (contract of :func:`msbfs_step_ref`)."""
    check_tensor("ell_idx", ell_idx, torch.int32, 2)
    check_tensor("frontier", frontier, torch.int32, 2)
    check_tensor("visited", visited, torch.int32, 2)
    check_tensor("dist", dist, torch.int8, 2)
    V, D = ell_idx.shape
    W = frontier.shape[1]
    if (frontier.shape != (V + 1, W) or visited.shape != (V, W)
            or dist.shape != (V, W * 32)):
        raise ValueError(
            f"msbfs_step shapes disagree: ell {tuple(ell_idx.shape)}, "
            f"frontier {tuple(frontier.shape)}, visited "
            f"{tuple(visited.shape)}, dist {tuple(dist.shape)}")
    if len({t.device for t in (ell_idx, frontier, visited, dist)}) != 1:
        raise ValueError("msbfs_step tensors lie on different devices")
    if not 0 <= hop <= 127:
        raise ValueError(f"hop={hop} does not fit int8")
    out = torch.empty((V + 1, W), dtype=torch.int32, device=frontier.device)
    if W == 0:
        return out
    if V == 0 or D == 0:
        # nothing to gather: the new frontier is empty (row V included)
        return out.zero_()
    lib = build.load("msbfs_step", _SIGNATURES)
    stream = torch.cuda.current_stream(frontier.device).cuda_stream
    rc = lib.msbfs_step_launch(ell_idx.data_ptr(), frontier.data_ptr(),
                               visited.data_ptr(), dist.data_ptr(),
                               out.data_ptr(), V, D, W, hop, stream)
    build.check(lib, rc, "msbfs_step")
    count_launch("msbfs_step")
    return out


def msbfs_step_meta(ell_idx: torch.Tensor, frontier: torch.Tensor,
                    visited: torch.Tensor, dist: torch.Tensor,
                    hop: int) -> torch.Tensor:
    """The meta arm (the dry run): the new (V+1, W) frontier, empty. Work
    by ``PERF.md`` section 6's rule for the kernel: one OR a (vertex,
    word, ELL entry); the ELL read, the frontier read and written, visited
    read and written. The dist stamps (a byte a new bit) depend on the
    data and are not counted."""
    V, D = ell_idx.shape
    W = frontier.shape[1]
    with meta_launch("msbfs_step", ops=V * W * D,
                     nbytes=V * D * 4 + (V + 1) * W * 4 * 2 + V * W * 4 * 2):
        return torch.empty((V + 1, W), dtype=torch.int32,
                           device=frontier.device)


def msbfs_step(ell_idx: torch.Tensor, frontier: torch.Tensor,
               visited: torch.Tensor, dist: torch.Tensor, hop: int,
               arm: ArmLike = None) -> torch.Tensor:
    """One fused MS-BFS level on the arm of the tensors' device."""
    chosen = resolve_arm(frontier.device, arm)
    if chosen is KernelArm.CUDA:
        return msbfs_step_cuda(ell_idx, frontier, visited, dist, hop)
    if chosen is KernelArm.META:
        return msbfs_step_meta(ell_idx, frontier, visited, dist, hop)
    return msbfs_step_ref(ell_idx, frontier, visited, dist, hop)


def msbfs_expand_ref(ell_idx: torch.Tensor,
                     frontier: torch.Tensor) -> torch.Tensor:
    """Plain version of the single hop (same contract as the kernel).

    ell_idx  : (V, D) int32 in-neighbour table, pad = V
    frontier : (V+1, W) int32 words; row V is read as zero whatever it holds
    Returns ``next[v] = OR_d frontier[ell_idx[v, d]]`` as a fresh (V+1, W)
    int32 tensor, row V = 0.
    """
    V, D = ell_idx.shape
    W = frontier.shape[1]
    fw = torch.cat([frontier[:V], torch.zeros((1, W), dtype=torch.int32,
                                              device=frontier.device)])
    out = torch.zeros((V + 1, W), dtype=torch.int32, device=frontier.device)
    for d in range(D):
        out[:V] |= fw[ell_idx[:, d]]
    return out


def msbfs_expand_cuda(ell_idx: torch.Tensor,
                      frontier: torch.Tensor) -> torch.Tensor:
    """Launch the ``msbfs_expand`` kernel of ``csrc/msbfs_step.cu``
    (contract of :func:`msbfs_expand_ref`)."""
    check_tensor("ell_idx", ell_idx, torch.int32, 2)
    check_tensor("frontier", frontier, torch.int32, 2)
    V, D = ell_idx.shape
    W = frontier.shape[1]
    if frontier.shape[0] != V + 1:
        raise ValueError(f"msbfs_expand shapes disagree: ell "
                         f"{tuple(ell_idx.shape)}, frontier "
                         f"{tuple(frontier.shape)}")
    if ell_idx.device != frontier.device:
        raise ValueError("msbfs_expand tensors lie on different devices")
    out = torch.empty((V + 1, W), dtype=torch.int32, device=frontier.device)
    if W == 0:
        return out
    if V == 0 or D == 0:
        return out.zero_()
    lib = build.load("msbfs_step", _SIGNATURES)
    stream = torch.cuda.current_stream(frontier.device).cuda_stream
    rc = lib.msbfs_expand_launch(ell_idx.data_ptr(), frontier.data_ptr(),
                                 out.data_ptr(), V, D, W, stream)
    build.check(lib, rc, "msbfs_expand")
    count_launch("msbfs_expand")
    return out


def msbfs_hop_packed(ell_idx: torch.Tensor, frontier_words: torch.Tensor,
                     arm: ArmLike = None) -> torch.Tensor:
    """One packed MS-BFS hop: (V, D) ELL x (V+1, W) words -> the next
    (V+1, W) words, row V zero, on the arm of the tensors' device."""
    if resolve_arm(frontier_words.device, arm) is KernelArm.CUDA:
        return msbfs_expand_cuda(ell_idx, frontier_words)
    return msbfs_expand_ref(ell_idx, frontier_words)
