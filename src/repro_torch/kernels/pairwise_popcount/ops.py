"""All-pairs popcount(AND) over packed bitmaps (``pairwise_popcount``),
and the Γ packing that feeds it on the similarity stage (``gamma_pack``).

Counterpart of ``repro/kernels/pairwise_popcount``: ``intersections`` is
the plain PyTorch version, ``pairwise_popcount_cuda`` the wrapper of
``csrc/pairwise_popcount.cu`` (which says what it replaces, what bounds it
and how it is designed), and ``pairwise_popcount`` picks the arm from the
tensor's device. ``gamma_pack_ref`` / ``gamma_pack_cuda`` pack Γ straight
from the index's int8 distances, and ``gamma_intersections`` is the
similarity stage's entry: on the card ``gamma_pack`` then
``pairwise_popcount``, on the CPU the plain composition (``gamma_bits``,
``pack_bits``, ``intersections``).

The plain version is exact integer arithmetic (a SWAR popcount in int64),
never a float product, so it equals the kernel bit for bit. It walks the
(Q, Q, W) pair-by-word space in chunks: whole, that space is billions of
elements at Q = 256 queries over a 2**20-vertex graph.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from ..msbfs_expand.ops import pack_bits
from ..registry import (ArmLike, KernelArm, check_tensor, count_launch,
                        resolve_arm)

__all__ = ["intersections", "popcount32", "pairwise_popcount",
           "pairwise_popcount_cuda", "pairwise_intersections", "gamma_bits",
           "gamma_pack_ref", "gamma_pack_cuda", "gamma_intersections"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"pairwise_popcount_launch": [_P, _P, _I, _I, _P],
               "gamma_pack_launch": [_P, _P, _P, _P, _I, _I, _I, _P]}

# elements of one (rows, Q, words) chunk of the plain version
_CHUNK = 1 << 22


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit counts of int64 values in [0, 2**32) (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def intersections(words: torch.Tensor) -> torch.Tensor:
    """Plain version: (Q, W) int32 words -> (Q, Q) int32,
    ``out[i, j] = sum_w popcount(words[i, w] & words[j, w])``."""
    Q, W = words.shape
    out = torch.zeros((Q, Q), dtype=torch.int64, device=words.device)
    if Q == 0 or W == 0:
        return out.to(torch.int32)
    x = words.to(torch.int64) & 0xFFFFFFFF
    wc = min(W, 4096)
    rows = max(1, _CHUNK // (Q * wc))
    for w0 in range(0, W, wc):
        xw = x[:, w0:w0 + wc]
        for i0 in range(0, Q, rows):
            both = xw[i0:i0 + rows, None, :] & xw[None, :, :]
            out[i0:i0 + rows] += popcount32(both).sum(-1)
    return out.to(torch.int32)


def pairwise_popcount_cuda(words: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/pairwise_popcount.cu``: (Q, W) int32 -> (Q, Q) int32."""
    check_tensor("words", words, torch.int32, 2)
    Q, W = words.shape
    out = torch.empty((Q, Q), dtype=torch.int32, device=words.device)
    if Q == 0:
        return out
    if W == 0:
        return out.zero_()
    lib = build.load("pairwise_popcount", _SIGNATURES)
    stream = torch.cuda.current_stream(words.device).cuda_stream
    rc = lib.pairwise_popcount_launch(words.data_ptr(), out.data_ptr(), Q, W,
                                      stream)
    build.check(lib, rc, "pairwise_popcount")
    count_launch("pairwise_popcount")
    return out


def pairwise_popcount(words: torch.Tensor, arm: ArmLike = None) -> torch.Tensor:
    """(Q, W) int32 packed bitmaps -> (Q, Q) int32 intersection sizes."""
    if resolve_arm(words.device, arm) is KernelArm.CUDA:
        return pairwise_popcount_cuda(words)
    return intersections(words)


def pairwise_intersections(gamma_bits: torch.Tensor,
                           arm: ArmLike = None) -> torch.Tensor:
    """(Q, V) bool rows -> (Q, Q) int32 ``|row_i & row_j|``."""
    return pairwise_popcount(pack_bits(gamma_bits), arm)


def gamma_bits(dist: torch.Tensor, col: torch.Tensor, ks: torch.Tensor,
               n: int) -> torch.Tensor:
    """(Q, n) bool Γ rows: ``dist[v, col[q]] <= ks[q]`` for v < n.

    dist : (>= n, Su) int8 distances of the index (``dist_s`` / ``dist_t``)
    col  : (Q,) int32 column of each query in ``dist``
    ks   : (Q,) int8 hop budget of each query
    """
    return (dist[:n, col.long()] <= ks[None, :]).T


def gamma_pack_ref(dist: torch.Tensor, col: torch.Tensor, ks: torch.Tensor,
                   n: int) -> torch.Tensor:
    """Plain version of ``gamma_pack``: (Q, ceil(n/32)) int32 words of
    :func:`gamma_bits` in ``pack_bits``' layout, tail bits zero."""
    return pack_bits(gamma_bits(dist, col, ks, n))


def gamma_pack_cuda(dist: torch.Tensor, col: torch.Tensor, ks: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Launch ``gamma_pack`` of ``csrc/pairwise_popcount.cu`` (contract of
    :func:`gamma_pack_ref`; every ``col`` must lie in ``[0, Su)``)."""
    check_tensor("dist", dist, torch.int8, 2)
    check_tensor("col", col, torch.int32, 1)
    check_tensor("ks", ks, torch.int8, 1)
    Q, Su = col.shape[0], dist.shape[1]
    if ks.shape[0] != Q or not 0 <= n <= dist.shape[0]:
        raise ValueError(f"gamma_pack shapes disagree: dist "
                         f"{tuple(dist.shape)}, col {tuple(col.shape)}, ks "
                         f"{tuple(ks.shape)}, n {n}")
    if len({t.device for t in (dist, col, ks)}) != 1:
        raise ValueError("gamma_pack tensors lie on different devices")
    out = torch.empty((Q, -(-n // 32)), dtype=torch.int32, device=dist.device)
    if Q == 0 or n == 0:
        return out
    if Su == 0:
        raise ValueError("gamma_pack: dist has no columns for the queries")
    lib = build.load("pairwise_popcount", _SIGNATURES)
    stream = torch.cuda.current_stream(dist.device).cuda_stream
    rc = lib.gamma_pack_launch(dist.data_ptr(), col.data_ptr(),
                               ks.data_ptr(), out.data_ptr(), n, Su, Q,
                               stream)
    build.check(lib, rc, "gamma_pack")
    count_launch("gamma_pack")
    return out


def gamma_intersections(dist: torch.Tensor, col: torch.Tensor,
                        ks: torch.Tensor, n: int,
                        arm: ArmLike = None) -> torch.Tensor:
    """(Q, Q) int32 ``|Γ_i ∩ Γ_j|`` of the Γ rows :func:`gamma_bits`
    describes; the diagonal holds the sizes ``|Γ_i|``. On the card
    ``gamma_pack`` then ``pairwise_popcount``; on the CPU the plain
    composition."""
    if resolve_arm(dist.device, arm) is KernelArm.CUDA:
        return pairwise_popcount_cuda(gamma_pack_cuda(dist, col, ks, n))
    return pairwise_intersections(gamma_bits(dist, col, ks, n))
