"""Config system: model/arch configs, input shapes, run options.

A copy of ``repro/config.py`` (plain dataclasses, no JAX). Every LM, GNN
and recsys architecture has a module in ``repro_torch/configs/<id>.py``
defining ``CONFIG`` (the exact published config), ``REDUCED`` (a small
same-family config for CPU tests) and its shape table, resolved through
``repro_torch.configs.get``. The port reads ``LMConfig``, ``MoEConfig``,
``GNNConfig``, ``RecsysConfig``, ``ShapeSpec`` and ``RunOptions``;
``PathEngineConfig`` is kept as plain data for its slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = ["MoEConfig", "LMConfig", "GNNConfig", "RecsysConfig",
           "PathEngineConfig", "ShapeSpec", "RunOptions"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    head_dim: Optional[int] = None
    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Approximate parameter count (used for 6ND model FLOPs)."""
        d, hd = self.d_model, self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.moe is not None:
            ffn = 3 * d * self.moe.d_ff_expert * self.moe.n_experts + d * self.moe.n_experts
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + d

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        hd = self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        ffn = 3 * d * self.moe.d_ff_expert * self.moe.top_k + d * self.moe.n_experts
        per_layer = attn + ffn + 2 * d
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + d


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                   # meshgraphnet | graphcast | schnet | graphsage
    n_layers: int
    d_hidden: int
    aggregator: str = "sum"
    mlp_layers: int = 2
    extras: tuple = ()          # (key, value) pairs, hashable
    dtype: str = "float32"

    def extra(self, key: str, default: Any = None) -> Any:
        return dict(self.extras).get(key, default)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    embed_dim: int
    tower_mlp: tuple[int, ...]
    interaction: str = "dot"
    n_users: int = 5_000_000
    n_items: int = 2_000_000
    n_user_hist: int = 20       # multi-hot history ids per user (EmbeddingBag)
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class PathEngineConfig:
    """The paper's engine as a dry-run 'architecture' (billion-scale spec)."""
    name: str
    n_vertices: int
    avg_degree: int
    n_queries: int
    k: int
    ell_cap: int = 64


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                   # train | prefill | decode | gnn_full | gnn_mini
                                # | gnn_mol | recsys_train | recsys_serve
                                # | recsys_retrieval | engine_batch
    dims: tuple                 # (key, value) pairs, hashable

    def dim(self, key: str, default=None):
        return dict(self.dims).get(key, default)


@dataclasses.dataclass(frozen=True)
class RunOptions:
    mesh: str = "pod"           # "pod" (16x16) | "multipod" (2x16x16) | "host"
    remat: bool = True
    seq_parallel: bool = True   # Megatron-SP residual stream (train/prefill)
    kernel_backend: str = "jnp"  # dry-run lowers jnp; TPU uses pallas
    loss_chunk: int = 512
    attn_chunk: int = 1024
    moe_groups: int = 16
    layer_group: int = 1
    grad_accum: int = 1
    cast_params_early: bool = False  # bf16-cast before scan: fsdp gathers move bf16
    remat_policy: str = "nothing"   # "nothing" | "dots" (save matmul outputs)
    serve_param_sharding: str = "2d"  # "2d" (fsdp x tp) | "tp_only" (replicated over data)
    kv_cache_dtype: str = "bf16"    # "bf16" | "f8" (float8_e4m3 quantized KV)
    engine_frontier_shard: str = "cells"  # "cells" | "split" (V->data, W->model)
    flash_decode: bool = False      # shard_map flash-decoding over seq-sharded KV
    use_ring_gnn: bool = True
    seed: int = 0
