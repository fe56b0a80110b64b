"""Step builder: (arch, shape) -> the step function and its analytic
roofline meta.

A port of ``repro/launch/steps.py``'s LM, GNN and recsys bundles
(``_lm_bundle``, ``_gnn_bundle``, ``_recsys_bundle`` and their meta). One
device, so no shardings, abstract inputs or donation: a train step takes
and returns the parameter tree and the optimizer state (updated in
place), a prefill step an :class:`~..models.transformer.LM` and tokens, a
decode step the model, a token and its cache, a recsys serve step the
parameters, histories and items, a retrieval step the parameters, one
history and the padded candidates. ``StepBundle.inputs`` gives the
batch's padded shapes where the JAX bundle's abstract inputs fix them
(GNN, recsys). The engine's ``path-engine`` bundle is not ported
(ROADMAP.md queue 1, item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from .. import configs as config_registry
from ..config import (GNNConfig, LMConfig, RecsysConfig, RunOptions,
                      ShapeSpec)
from ..models import gnn, recsys, transformer
from ..optim import adamw_update, cosine_schedule
from ..pytree import leaves, unflatten

__all__ = ["StepBundle", "TRAIN_KINDS", "build_bundle", "lm_bundle",
           "gnn_bundle", "recsys_bundle", "gnn_dims", "shape_of"]

# the shape kinds whose bundle is a train step
TRAIN_KINDS = ("train", "gnn_full", "gnn_mini", "gnn_mol", "recsys_train")


@dataclasses.dataclass
class StepBundle:
    arch: str
    shape: str
    kind: str                       # the shape's kind: train | prefill |
                                    # decode | gnn_full | gnn_mini | gnn_mol
                                    # | recsys_train | recsys_serve |
                                    # recsys_retrieval
    step_fn: Callable
    cfg: Union[LMConfig, GNNConfig, RecsysConfig]
    opts: RunOptions
    meta: dict                      # analytic roofline terms
    spec: ShapeSpec                 # the shape, overrides applied
    # the batch's padded input shapes, name -> (shape, dtype) (GNN, recsys)
    inputs: dict = dataclasses.field(default_factory=dict)

    @property
    def dims(self) -> dict:
        return dict(self.spec.dims)


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
    cfg = mod.REDUCED if reduced else mod.CONFIG
    shape = shape_of(mod, shape_name, overrides)
    build = {"lm": lm_bundle, "gnn": gnn_bundle,
             "recsys": recsys_bundle}[mod.FAMILY]
    return build(arch, cfg, shape, opts)


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
                          step_fn=step_fn, cfg=cfg, opts=opts, meta=meta,
                          spec=shape)

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


def _train_step(loss_fn: Callable) -> Callable:
    """The GNN and recsys train step: ``loss_fn(params, batch)``'s value
    and gradients (zeros for a parameter the loss does not reach, as
    SchNet's ``in_proj`` on molecules), AdamW at the JAX bundles' settings
    (cosine schedule at base lr 1e-3, no weight decay)."""
    def train_step(params, opt_state, b):
        loss = loss_fn(params, b)
        grads = torch.autograd.grad(loss, leaves(params),
                                    materialize_grads=True)
        lr = cosine_schedule(opt_state.count, base_lr=1e-3)
        params, opt_state, m = adamw_update(
            unflatten(params, grads), opt_state, params, lr=lr,
            weight_decay=0.0)
        return params, opt_state, {"loss": loss.detach(), **m}
    return train_step


# ======================================================================
# GNN family
# ======================================================================

def gnn_dims(cfg: GNNConfig, shape: ShapeSpec) -> tuple[int, int]:
    """(d_in, d_out) of a GNN config at a shape."""
    d_feat = shape.dim("d_feat", 16)
    if cfg.kind == "graphsage":
        return d_feat, cfg.extra("n_classes", 41)
    return d_feat, cfg.extra("d_out", 3)


def _gnn_batch_shapes(cfg: GNNConfig, shape: ShapeSpec) -> dict:
    """The JAX ``_gnn_batch_abstract``: name -> (shape, dtype) of a graph
    batch of this shape (flat batches padded to multiples of 512)."""
    d_feat, d_out = gnn_dims(cfg, shape)
    rbf = cfg.extra("rbf", 300)
    I32, F32, B8 = torch.int32, torch.float32, torch.bool
    if shape.kind == "gnn_mol":
        B = shape.dim("batch")
        N, E = shape.dim("n_nodes"), shape.dim("n_edges")
        b = {"nodes": ((B, N, d_feat), F32), "edge_src": ((B, E), I32),
             "edge_dst": ((B, E), I32), "edge_mask": ((B, E), B8),
             "node_mask": ((B, N), B8)}
        if cfg.kind == "schnet":
            b.update(atom_types=((B, N), I32), edge_rbf=((B, E, rbf), F32),
                     targets=((B,), F32))
        elif cfg.kind == "graphsage":
            b["labels"] = ((B, N), I32)
        else:
            b.update(edge_feat=((B, E, 4), F32),
                     targets=((B, N, d_out), F32))
        return b
    if shape.kind == "gnn_mini":
        roots, fo = shape.dim("batch_nodes"), shape.dim("fanout")
        n_nodes = min(shape.dim("n_nodes"),
                      roots * (1 + fo[0] + fo[0] * fo[1]))
        n_edges = roots * fo[0] + roots * fo[0] * fo[1]
    else:
        n_nodes, n_edges = shape.dim("n_nodes"), shape.dim("n_edges")
    N = -(-n_nodes // 512) * 512
    E = -(-n_edges // 512) * 512
    b = {"nodes": ((N, d_feat), F32), "edge_src": ((E,), I32),
         "edge_dst": ((E,), I32), "edge_mask": ((E,), B8),
         "node_mask": ((N,), B8)}
    if cfg.kind == "schnet":
        b.update(edge_rbf=((E, rbf), F32), targets=((N,), F32))
    elif cfg.kind == "graphsage":
        b["labels"] = ((N,), I32)
    else:
        b.update(edge_feat=((E, 4), F32), targets=((N, d_out), F32))
    return b


def _gnn_meta(cfg: GNNConfig, shape: ShapeSpec) -> dict:
    n_params = gnn.gnn_param_count(cfg, *gnn_dims(cfg, shape))
    if shape.kind == "gnn_mol":
        E = shape.dim("n_edges") * shape.dim("batch")
        N = shape.dim("n_nodes") * shape.dim("batch")
    elif shape.kind == "gnn_mini":
        roots, fo = shape.dim("batch_nodes"), shape.dim("fanout")
        E = roots * fo[0] + roots * fo[0] * fo[1]
        N = min(shape.dim("n_nodes"), roots * (1 + fo[0] + fo[0] * fo[1]))
    else:
        E, N = shape.dim("n_edges"), shape.dim("n_nodes")
    d = cfg.d_hidden
    # per message-passing block: edge MLP ~ edges x d^2 terms, node MLP ~ nodes
    flops = 6 * cfg.n_layers * (E * (6 * d * d) + N * (6 * d * d))
    return {"family": "gnn", "kind": shape.kind, "params": n_params,
            "edges": E, "nodes": N, "model_flops": flops,
            "weight_bytes": n_params * 4, "n_layers": cfg.n_layers}


def gnn_bundle(arch: str, cfg: GNNConfig, shape: ShapeSpec,
               opts: RunOptions) -> StepBundle:
    """The train bundle of a GNN config at ``shape``: a molecule batch's
    loss is the mean of each molecule's (``gnn.gnn_molecule_loss``)."""
    loss = gnn.gnn_molecule_loss if shape.kind == "gnn_mol" else gnn.gnn_loss
    return StepBundle(
        arch=arch, shape=shape.name, kind=shape.kind,
        step_fn=_train_step(lambda p, b: loss(p, b, cfg)), cfg=cfg,
        opts=opts, meta=_gnn_meta(cfg, shape), spec=shape,
        inputs=_gnn_batch_shapes(cfg, shape))


# ======================================================================
# recsys
# ======================================================================

def _recsys_meta(cfg: RecsysConfig, shape: ShapeSpec) -> dict:
    B = shape.dim("batch")
    mlp_flops = 2 * sum(cfg.tower_mlp[i] * cfg.tower_mlp[i + 1]
                        for i in range(len(cfg.tower_mlp) - 1))
    mlp_flops += 2 * cfg.embed_dim * cfg.tower_mlp[0]
    per_ex = 2 * mlp_flops  # two towers
    if shape.kind == "recsys_train":
        flops = 3 * (B * per_ex + 2 * B * B * cfg.tower_mlp[-1])
    elif shape.kind == "recsys_retrieval":
        Nc = shape.dim("n_candidates")
        flops = Nc * (mlp_flops + 2 * cfg.tower_mlp[-1]) + mlp_flops
    else:
        flops = B * (per_ex + 2 * cfg.tower_mlp[-1])
    emb_bytes = (cfg.n_users + cfg.n_items) * cfg.embed_dim * 4
    return {"family": "recsys", "kind": shape.kind,
            "params": recsys.recsys_param_count(cfg), "batch": B,
            "model_flops": flops, "weight_bytes": emb_bytes}


# the retrieval step's top k, and the multiple its candidates are padded to
RETRIEVAL_K = 100
RETRIEVAL_PAD = 512


def recsys_bundle(arch: str, cfg: RecsysConfig, shape: ShapeSpec,
                  opts: RunOptions) -> StepBundle:
    """The train, serve or retrieval bundle of the two-tower model."""
    B, H = shape.dim("batch"), cfg.n_user_hist
    meta = _recsys_meta(cfg, shape)
    I32, F32 = torch.int32, torch.float32

    def bundle(step_fn, inputs):
        return StepBundle(arch=arch, shape=shape.name, kind=shape.kind,
                          step_fn=step_fn, cfg=cfg, opts=opts, meta=meta,
                          spec=shape, inputs=inputs)

    if shape.kind == "recsys_train":
        return bundle(
            _train_step(lambda p, b: recsys.recsys_loss(p, b, cfg)),
            {"hist_ids": ((B, H), I32), "item_ids": ((B,), I32),
             "sampling_logq": ((B,), F32)})

    if shape.kind == "recsys_serve":
        @torch.no_grad()
        def serve_step(params, hist_ids, item_ids):
            return recsys.score_candidates(params, hist_ids, item_ids)

        return bundle(serve_step, {"hist_ids": ((B, H), I32),
                                   "item_ids": ((B,), I32)})

    # retrieval: 1 query vs n_candidates, padded with -1 ids to a multiple
    # of RETRIEVAL_PAD, masked to -inf before the top k
    Nc = shape.dim("n_candidates")
    Nc_pad = -(-Nc // RETRIEVAL_PAD) * RETRIEVAL_PAD

    @torch.no_grad()
    def retrieval_step(params, hist_ids, cand_ids):
        u = recsys.user_tower(params, hist_ids)
        v = recsys.item_tower(params, torch.clamp(cand_ids, min=0))
        scores = (v @ u[0]).float()
        scores = torch.where(cand_ids >= 0, scores, float("-inf"))
        vals, idx = recsys.topk_stable(scores, RETRIEVAL_K)
        return vals, cand_ids[idx]

    return bundle(retrieval_step, {"hist_ids": ((1, H), I32),
                                   "cand_ids": ((Nc_pad,), I32)})
