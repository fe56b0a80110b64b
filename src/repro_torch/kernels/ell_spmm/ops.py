"""Padded-ELL gather-reduce (``ell_spmm``) behind the walk-count DP.

Counterpart of ``repro/kernels/ell_spmm``: ``ell_spmm_ref`` is the plain
PyTorch version, ``ell_spmm_cuda`` the wrapper of ``csrc/ell_spmm.cu``
(which says what it replaces, what bounds it and how it is designed), and
``ell_aggregate`` appends the neutral row and picks the arm from the
tensors' device. The wrapper takes one of two kernels by shape
(:func:`f1_route`): ``ell_gather_f1_kernel`` for the engine's walk counts
(F = 1), ``ell_spmm_kernel`` for the rest; ``LAUNCHES["ell_spmm"]`` counts
both, and ``LAUNCHES["ell_gather_f1"]`` the first alone.

Both arms accumulate over the D columns in ascending order, one float add
(or max) at a time, as the Pallas kernel's ``fori_loop`` does, so the
kernel, the plain version and the JAX kernel agree bit for bit for any
values, not only for integer-valued floats below 2**24. (``x[idx].sum(1)``
would leave the order of summation unspecified.)
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from ..registry import (ArmLike, KernelArm, check_tensor, count_launch,
                        resolve_arm)

__all__ = ["ell_aggregate", "ell_spmm_ref", "ell_spmm_cuda", "f1_route",
           "OPS"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ell_spmm_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P]}

OPS = ("sum", "max")


def _check_op(op: str) -> None:
    if op not in OPS:
        raise ValueError(f"unknown ell_spmm op {op!r}; valid: "
                         f"{' | '.join(OPS)}")


def f1_route(D: int, F: int, aligned: bool) -> bool:
    """Whether ``ell_gather_f1_kernel`` takes a call: F = 1, D a multiple
    of 4 up to 128 (a group of D / 4 lanes per row, each lane one 16-byte
    load of 4 indices) and the table 16-byte aligned."""
    return F == 1 and D % 4 == 0 and 4 <= D <= 128 and aligned


def ell_spmm_ref(ell_idx: torch.Tensor, xs: torch.Tensor,
                 op: str = "sum") -> torch.Tensor:
    """Plain version: ``out[v, f] = reduce_d xs[ell_idx[v, d], f]``.

    ell_idx : (V, D) int32, entries in [0, V] (pad = V)
    xs      : (V+1, F) float32, row V the neutral element of ``op``
    Returns (V, F) float32, accumulated over d in ascending order.
    """
    _check_op(op)
    V, D = ell_idx.shape
    F = xs.shape[1]
    fill = 0.0 if op == "sum" else float("-inf")
    acc = torch.full((V, F), fill, dtype=xs.dtype, device=xs.device)
    for d in range(D):
        g = xs[ell_idx[:, d]]
        acc = acc + g if op == "sum" else torch.maximum(acc, g)
    return acc


def ell_spmm_cuda(ell_idx: torch.Tensor, xs: torch.Tensor,
                  op: str = "sum") -> torch.Tensor:
    """Launch ``csrc/ell_spmm.cu`` (contract of :func:`ell_spmm_ref`)."""
    _check_op(op)
    check_tensor("ell_idx", ell_idx, torch.int32, 2)
    check_tensor("xs", xs, torch.float32, 2)
    V, D = ell_idx.shape
    F = xs.shape[1]
    if xs.shape[0] != V + 1 or xs.device != ell_idx.device:
        raise ValueError(f"ell_spmm: xs must be (V+1, F) = ({V + 1}, F) on "
                         f"{ell_idx.device}, got {tuple(xs.shape)} on "
                         f"{xs.device}")
    fill = 0.0 if op == "sum" else float("-inf")
    out = torch.empty((V, F), dtype=torch.float32, device=xs.device)
    if V == 0 or F == 0:
        return out
    if D == 0:
        return out.fill_(fill)
    f1 = f1_route(D, F, ell_idx.data_ptr() % 16 == 0)
    lib = build.load("ell_spmm", _SIGNATURES)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    rc = lib.ell_spmm_launch(ell_idx.data_ptr(), xs.data_ptr(),
                             out.data_ptr(), V, D, F, OPS.index(op), int(f1),
                             stream)
    build.check(lib, rc, "ell_spmm")
    count_launch("ell_spmm", *(("ell_gather_f1",) if f1 else ()))
    return out


def ell_aggregate(ell_idx: torch.Tensor, x: torch.Tensor, op: str = "sum",
                  arm: ArmLike = None) -> torch.Tensor:
    """x: (V, F) float32 node features -> (V, F) aggregated over the ELL
    neighbours of each row.

    Appends the neutral sentinel row (pad index = V) and runs on the arm
    of the tensors' device; for ``max``, rows with no neighbour (-inf) and
    any other non-finite result come back as 0.
    """
    fill = 0.0 if op == "sum" else float("-inf")
    neutral = torch.full((1, x.shape[1]), fill, dtype=x.dtype,
                         device=x.device)
    xs = torch.cat([x, neutral])
    if resolve_arm(x.device, arm) is KernelArm.CUDA:
        out = ell_spmm_cuda(ell_idx, xs, op)
    else:
        out = ell_spmm_ref(ell_idx, xs, op)
    if op == "max":
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return out
