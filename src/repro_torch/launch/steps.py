"""Step builder for the LM family: (arch, shape) -> the step function and
its analytic roofline meta.

A port of ``repro/launch/steps.py``'s LM bundle (``_lm_bundle``,
``_lm_meta``). One device, so no shardings, abstract inputs or donation:
a train step takes and returns the parameter tree and the optimizer state
(updated in place), a prefill step an :class:`~..models.transformer.LM`
and tokens, a decode step the model, a token and its cache. The GNN,
recsys and engine families are not ported (ROADMAP.md queue 1, item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .. import configs as config_registry
from ..config import LMConfig, RunOptions, ShapeSpec
from ..models import transformer
from ..optim import adamw_update, cosine_schedule
from ..pytree import leaves, unflatten

__all__ = ["StepBundle", "build_bundle", "lm_bundle", "shape_of"]


@dataclasses.dataclass
class StepBundle:
    arch: str
    shape: str
    kind: str                       # train | prefill | decode
    step_fn: Callable
    cfg: LMConfig
    opts: RunOptions
    meta: dict                      # analytic roofline terms


def shape_of(mod, shape_name: str, overrides: dict | None) -> ShapeSpec:
    """The arch's shape ``shape_name`` with ``overrides`` of its dims."""
    shape = mod.SHAPES[shape_name]
    if overrides:
        shape = ShapeSpec(shape.name, shape.kind,
                          tuple(dict(dict(shape.dims), **overrides).items()))
    return shape


def build_bundle(arch: str, shape_name: str, opts: RunOptions | None = None,
                 reduced: bool = False,
                 overrides: dict | None = None) -> StepBundle:
    opts = RunOptions() if opts is None else opts
    mod = config_registry.get(arch)
    if mod.FAMILY != "lm":
        raise NotImplementedError(
            f"{arch!r}: the {mod.FAMILY} family's steps are not ported "
            f"(ROADMAP.md queue 1, item 7, 'GNN and recsys models')")
    cfg = mod.REDUCED if reduced else mod.CONFIG
    return lm_bundle(arch, cfg, shape_of(mod, shape_name, overrides), opts)


def _lm_meta(cfg: LMConfig, shape: ShapeSpec) -> dict:
    S, B = shape.dim("seq_len"), shape.dim("global_batch")
    N, Na = cfg.param_count(), cfg.active_param_count()
    tokens = B * S if shape.kind in ("train", "prefill") else B
    mult = 6 if shape.kind == "train" else 2
    kv_read = 0
    if shape.kind == "decode":
        kv_read = (cfg.n_layers * B * S * cfg.n_kv_heads * cfg.hd * 2) * 2
    return {
        "family": "lm", "kind": shape.kind,
        "params": N, "active_params": Na,
        "tokens": tokens,
        "model_flops": mult * Na * tokens,
        "weight_bytes": Na * 2,
        "kv_cache_bytes": kv_read,
        "seq_len": S, "global_batch": B,
        "n_layers": cfg.n_layers,
    }


def lm_bundle(arch: str, cfg: LMConfig, shape: ShapeSpec,
              opts: RunOptions) -> StepBundle:
    """The bundle of an LM config (e.g. one cut in depth) at ``shape``."""
    S, B = shape.dim("seq_len"), shape.dim("global_batch")
    meta = _lm_meta(cfg, shape)

    def bundle(step_fn):
        return StepBundle(arch=arch, shape=shape.name, kind=shape.kind,
                          step_fn=step_fn, cfg=cfg, opts=opts, meta=meta)

    if shape.kind == "train":
        transformer.check_trainable(opts)
        A = max(opts.grad_accum, 1)
        if B % A:
            raise ValueError(f"global_batch {B} must divide grad_accum {A}")

        def train_step(params, opt_state, tokens, targets):
            masters = leaves(params)

            def value_and_grad(tk, tg):
                loss = transformer.lm_loss(params, tk, tg, cfg, opts)
                return loss.detach(), torch.autograd.grad(loss, masters)

            if A == 1:
                loss, grads = value_and_grad(tokens, targets)
            else:  # gradient accumulation over A microbatches (f32 sums)
                tks = tokens.reshape(A, B // A, S)
                tgs = targets.reshape(A, B // A, S)
                grads = [torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device) for p in masters]
                loss = torch.zeros((), dtype=torch.float32,
                                   device=tokens.device)
                for a in range(A):
                    la, ga = value_and_grad(tks[a], tgs[a])
                    grads = [g + x.float() for g, x in zip(grads, ga)]
                    loss = loss + la
                grads = [g / A for g in grads]
                loss = loss / A
            lr = cosine_schedule(opt_state.count)
            params, opt_state, m = adamw_update(
                unflatten(params, grads), opt_state, params, lr=lr)
            return params, opt_state, {"loss": loss, **m}

        return bundle(train_step)

    transformer.check_supported(cfg, opts)
    if shape.kind == "prefill":
        return bundle(transformer.prefill)
    return bundle(transformer.decode_step)
