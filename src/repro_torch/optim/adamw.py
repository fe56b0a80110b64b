"""AdamW + global-norm clipping + cosine schedule over parameter trees.

A port of ``repro/optim/adamw.py`` as plain functions over trees of
tensors (:mod:`repro_torch.pytree`), not ``torch.optim``, so that the
state mirrors the parameter tree (m, v in float32) and its checkpoint
keys are the JAX package's. All math is in float32, in the JAX function's
order of operations. Unlike the JAX function, :func:`adamw_update` updates
the parameters, m and v in place (one leaf at a time, so the update needs
no second copy of the model) and returns the same tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..pytree import leaves, tree_map

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule"]


class AdamWState(NamedTuple):
    m: dict
    v: dict
    count: torch.Tensor      # int32, 0-d: the updates taken


def adamw_init(params) -> AdamWState:
    """Zero float32 m and v shaped as the parameters (on their devices),
    count 0."""
    dev = leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def cosine_schedule(step, base_lr=3e-4, warmup=100, total=10_000,
                    min_frac=0.1) -> torch.Tensor:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_frac * base_lr`` at ``total``; float32."""
    step = torch.as_tensor(step).float()
    warm = step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(step < warmup, warm, cos)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    """Returns ``(params, state, {"grad_norm": g})``: the gradients clipped
    to a global norm of ``clip_norm``, bias-corrected moments, decoupled
    weight decay, each parameter written back in its own type. The
    parameters and the state's m and v are updated in place."""
    g32 = [g.float() for g in leaves(grads)]
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in g32))
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state.count + 1
    c = count.float()
    bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
    for g, m, v, p in zip(g32, leaves(state.m), leaves(state.v),
                          leaves(params)):
        g = g * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        p32 = p.float()
        step = lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                     + weight_decay * p32)
        p.copy_((p32 - step).to(p.dtype))
    return params, AdamWState(m=state.m, v=state.v, count=count), \
        {"grad_norm": gnorm}
