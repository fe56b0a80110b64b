"""int8 error-feedback gradient compression (a port of
``repro/optim/compress.py``).

Per-tensor symmetric int8 codes with a scale. The JAX
``ef_compressed_psum`` runs under ``shard_map`` over an axis; here it has
two forms with one arithmetic:

* :func:`ef_compressed_psum` over the sequence of the axis members'
  gradients and error buffers: one shared scale (the largest member's),
  an exact int32 sum of the codes, and each member's residual carried to
  its next step (error feedback);
* :func:`ef_compressed_psum_axis` over an axis of a layout
  (``launch/mesh.py``), each member's gradient and error on its slot: the
  shared scale is the ``pmax`` of the members' scales, the codes go
  through an exact int32 ``psum`` (``launch/collectives.py``), and each
  slot keeps its own residual. It computes the same bits as the sequence
  form: a max and an integer sum do not depend on their order.

The JAX package wires this function into no train step, and neither does
the port.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..launch import collectives
from ..launch.mesh import Layout

__all__ = ["compress_int8", "decompress_int8", "ef_compressed_psum",
           "ef_compressed_psum_axis"]


def compress_int8(x: torch.Tensor):
    """x (float32 / bf16) -> (int8 codes, float32 scale)."""
    xf = x.float()
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return codes, scale


def decompress_int8(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.float() * scale


def _fed(grad: torch.Tensor, error: torch.Tensor) -> torch.Tensor:
    """A member's gradient with its carried residual, float32."""
    return grad.float() + error


def _scale(g: torch.Tensor) -> torch.Tensor:
    """A member's own scale (a 0-d float32)."""
    return torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0


def _codes(g: torch.Tensor, smax: torch.Tensor) -> torch.Tensor:
    """A member's codes in the shared grid, float32 integers in
    [-127, 127]."""
    return torch.clamp(torch.round(g / smax), -127, 127)


def ef_compressed_psum(grads: Sequence[torch.Tensor],
                       errors: Sequence[torch.Tensor]):
    """The error-feedback int8 all-reduce of one gradient leaf over the
    axis whose members hold ``grads[i]`` and error buffers ``errors[i]``.

    Returns ``(reduced float32, [new error of each member])``: every
    member receives the same ``reduced``."""
    if len(grads) != len(errors) or not grads:
        raise ValueError("ef_compressed_psum: one gradient and one error "
                         "buffer per axis member")
    gs = [_fed(g, e) for g, e in zip(grads, errors)]
    smax = torch.stack([_scale(g) for g in gs]).max()
    codes = [_codes(g, smax) for g in gs]
    total = sum(c.to(torch.int32) for c in codes)
    reduced = total.float() * smax
    return reduced, [g - c * smax for g, c in zip(gs, codes)]


def ef_compressed_psum_axis(grads: Sequence[torch.Tensor],
                            errors: Sequence[torch.Tensor], layout: Layout,
                            axis_name: str):
    """The JAX ``ef_compressed_psum(grad, error, axis_name)`` under
    ``shard_map``: ``grads`` and ``errors`` hold one piece per slot of
    ``layout``, on the slot's device; the members of each group along
    ``axis_name`` reduce together.

    Returns ``([reduced float32 of each slot], [new error of each
    slot])``: the members of a group receive the same ``reduced``, bit
    for bit :func:`ef_compressed_psum` of their pieces."""
    if len(grads) != layout.size or len(errors) != layout.size:
        raise ValueError(f"ef_compressed_psum_axis: one gradient and one "
                         f"error buffer per slot ({layout.size})")
    gs = collectives.run_slots(layout, lambda s: _fed(grads[s], errors[s]))
    smax = collectives.pmax(
        collectives.run_slots(layout, lambda s: _scale(gs[s])), layout,
        axis_name)
    codes = collectives.run_slots(layout, lambda s: _codes(gs[s], smax[s]))
    total = collectives.psum(
        collectives.run_slots(layout, lambda s: codes[s].to(torch.int32)),
        layout, axis_name)
    out = collectives.run_slots(layout, lambda s: (
        total[s].float() * smax[s], gs[s] - codes[s] * smax[s]))
    return [r for r, _ in out], [e for _, e in out]
