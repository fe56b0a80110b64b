"""Two-tower retrieval (YouTube RecSys'19): sampled-softmax retrieval.

Counterpart of ``repro/models/recsys.py``. The embedding bag is a row
gather over the table and a masked mean over the bag (padding ids are
-1), its backward adding each id's gradient rows in a fixed order
(:func:`.segment.gather_rows`); training is an in-batch sampled softmax
with the logQ correction; serving scores (B,) pairs pointwise, and
retrieval scores one query against every candidate and keeps the top k
by a stable descending sort, so ties go to the lower index as in
``jax.lax.top_k``.

Parameters are a tree in the JAX layout (``user_table``, ``item_table``,
``user_mlp`` / ``item_mlp`` with lists ``w``, ``b``) of float32
``nn.Parameter`` leaves. One device: the JAX package's row sharding of
the tables and its sharded top-k combine have no counterpart (the
``constrain`` hook is a sharding hint).
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch
from torch import nn

from ..config import RecsysConfig
from ..kernels.registry import resolve_device
from ..pytree import tree_map
from .segment import gather_rows

__all__ = ["init_recsys_params", "recsys_param_logical",
           "recsys_params_from_jax", "recsys_param_count", "embedding_bag",
           "user_tower", "item_tower", "recsys_loss", "score_candidates",
           "retrieve_topk", "topk_stable"]

DeviceLike = Union[torch.device, str, None]


def _mlp(p, x):
    n = len(p["w"])
    for i in range(n):
        x = x @ p["w"][i] + p["b"][i]
        if i < n - 1:
            x = torch.relu(x)
    return x


def _mlp_dims(cfg: RecsysConfig) -> tuple:
    return (cfg.embed_dim,) + tuple(cfg.tower_mlp)


def recsys_param_count(cfg: RecsysConfig) -> int:
    d = _mlp_dims(cfg)
    mlp = sum(d[i] * d[i + 1] + d[i + 1] for i in range(len(d) - 1))
    return (cfg.n_users + cfg.n_items) * cfg.embed_dim + 2 * mlp


def init_recsys_params(cfg: RecsysConfig, *, generator: torch.Generator,
                       device: DeviceLike = None) -> dict:
    """Random float32 parameters (``nn.Parameter`` leaves) with the law of
    the JAX ``init_recsys_params``: tables ``normal * 0.02``, tower
    matrices ``normal / sqrt(fan_in)``, biases zeros."""
    dev = resolve_device(device)

    def normal(shape, scale):
        if dev.type == "meta":                  # the dry run: shapes only
            return nn.Parameter(torch.empty(shape, device=dev))
        return nn.Parameter(torch.randn(shape, generator=generator,
                                        device=dev).mul_(scale))

    def mlp(dims):
        return {"w": [normal((dims[i], dims[i + 1]), 1.0 / np.sqrt(dims[i]))
                      for i in range(len(dims) - 1)],
                "b": [nn.Parameter(torch.zeros(dims[i + 1], device=dev))
                      for i in range(len(dims) - 1)]}

    dim = cfg.embed_dim
    return {"user_table": normal((cfg.n_users, dim), 0.02),
            "item_table": normal((cfg.n_items, dim), 0.02),
            "user_mlp": mlp(_mlp_dims(cfg)),
            "item_mlp": mlp(_mlp_dims(cfg))}


def recsys_params_from_jax(tree, cfg: RecsysConfig, *,
                           device: DeviceLike = None) -> dict:
    """The port's parameter tree carrying a JAX ``init_recsys_params``
    tree's weights (leaves as numpy arrays), float32 ``nn.Parameter``
    leaves on ``device``."""
    dev = resolve_device(device)
    want = {"user_table", "item_table", "user_mlp", "item_mlp"}
    if set(tree) != want:
        raise ValueError(f"{cfg.name}: parameter names {sorted(tree)}, "
                         f"expected {sorted(want)}")
    return tree_map(lambda a: nn.Parameter(torch.from_numpy(
        np.array(a, dtype=np.float32)).to(dev)), tree)


def recsys_param_logical(params) -> dict:
    """The JAX package's logical axes: tables row-sharded over "cells",
    the towers replicated (one device: no sharding)."""
    return {"user_table": ("cells", None), "item_table": ("cells", None),
            "user_mlp": tree_map(lambda p: tuple(None for _ in p.shape),
                                 params["user_mlp"]),
            "item_mlp": tree_map(lambda p: tuple(None for _ in p.shape),
                                 params["item_mlp"])}


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  mode: str = "mean") -> torch.Tensor:
    """ids: (..., H) int with -1 padding -> (..., dim): the sum, or the
    mean over the bag's valid ids (an empty bag gives 0)."""
    valid = ids >= 0
    emb = gather_rows(table, torch.clamp(ids, min=0))
    s = (emb * valid[..., None]).sum(-2)
    if mode == "sum":
        return s
    return s / torch.clamp(valid.sum(-1, keepdim=True).to(s.dtype), min=1.0)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-6)


def user_tower(params, hist_ids: torch.Tensor) -> torch.Tensor:
    """hist_ids: (B, H) item-interaction history (bag) -> (B, d), unit
    rows."""
    return _unit(_mlp(params["user_mlp"],
                      embedding_bag(params["user_table"], hist_ids)))


def item_tower(params, item_ids: torch.Tensor) -> torch.Tensor:
    return _unit(_mlp(params["item_mlp"],
                      gather_rows(params["item_table"], item_ids)))


def recsys_loss(params, batch: dict, cfg: RecsysConfig,
                temperature: float = 0.05) -> torch.Tensor:
    """In-batch sampled softmax with logQ correction: the mean over the B
    users of minus the log-probability of their own item among the
    batch's items."""
    u = user_tower(params, batch["hist_ids"])          # (B, d)
    v = item_tower(params, batch["item_ids"])          # (B, d)
    logits = (u @ v.T) / temperature                   # (B, B)
    logq = batch.get("sampling_logq")
    if logq is not None:                               # logQ correction
        logits = logits - logq[None, :]
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.diagonal(logp))


def score_candidates(params, hist_ids, item_ids) -> torch.Tensor:
    """Pointwise serve: score (B,) pairs."""
    return torch.sum(user_tower(params, hist_ids)
                     * item_tower(params, item_ids), dim=-1)


def topk_stable(scores: torch.Tensor, k: int):
    """The k largest scores and their indices, ties to the lower index (a
    stable descending sort, as ``jax.lax.top_k``)."""
    vals, idx = torch.sort(scores, descending=True, stable=True)
    return vals[:k], idx[:k]


def retrieve_topk(params, hist_ids, cand_ids, k: int = 100):
    """1 query vs n_candidates: batched dot + top-k."""
    u = user_tower(params, hist_ids)                   # (1, d)
    v = item_tower(params, cand_ids)                   # (Nc, d)
    vals, idx = topk_stable((v @ u[0]).float(), k)
    return vals, cand_ids[idx]
