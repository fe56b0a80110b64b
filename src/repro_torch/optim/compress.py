"""int8 error-feedback gradient compression (a port of
``repro/optim/compress.py``).

Per-tensor symmetric int8 codes with a scale; ``ef_compressed_psum`` is the
arithmetic that the JAX function does under ``shard_map`` over an axis,
written over the sequence of the axis members' gradients and error
buffers: one shared scale (the largest member's), an exact int32 sum of
the codes, and each member's residual carried to its next step (error
feedback). A form over a ``torch.distributed`` process group waits for the
substrate's mesh options (ROADMAP.md queue 1).
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["compress_int8", "decompress_int8", "ef_compressed_psum"]


def compress_int8(x: torch.Tensor):
    """x (float32 / bf16) -> (int8 codes, float32 scale)."""
    xf = x.float()
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return codes, scale


def decompress_int8(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.float() * scale


def ef_compressed_psum(grads: Sequence[torch.Tensor],
                       errors: Sequence[torch.Tensor]):
    """The error-feedback int8 all-reduce of one gradient leaf over the
    axis whose members hold ``grads[i]`` and error buffers ``errors[i]``.

    Returns ``(reduced float32, [new error of each member])``: every
    member receives the same ``reduced``."""
    if len(grads) != len(errors) or not grads:
        raise ValueError("ef_compressed_psum: one gradient and one error "
                         "buffer per axis member")
    gs = [g.float() + e for g, e in zip(grads, errors)]
    smax = torch.stack([torch.clamp(torch.max(torch.abs(g)), min=1e-12)
                        / 127.0 for g in gs]).max()
    codes = [torch.clamp(torch.round(g / smax), -127, 127) for g in gs]
    total = sum(c.to(torch.int32) for c in codes)
    reduced = total.float() * smax
    return reduced, [g - c * smax for g, c in zip(gs, codes)]
