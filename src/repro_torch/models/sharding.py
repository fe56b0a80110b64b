"""Logical-axis rules: the counterpart of ``repro/models/sharding.py``.

Model code names each array dimension by a *logical* axis; the rules map
it to the axes of a layout (``launch/mesh.py``):

  * "batch", "fsdp"       -> ("pod", "data") or ("data",)   data parallel
  * "tensor", "expert"    -> "model"                        tensor / expert
  * "seq", "seq_kv"       -> "model"                        sequence
  * "cells", "seq_kv_wide"-> every axis, flattened          rows of a graph,
                                                            a batch-1 cache

``spec`` is the counterpart of a ``PartitionSpec``: a tuple with, per
dimension, ``None`` (replicated), one axis name, or a tuple of names.
:meth:`Rules.shard` cuts a tensor into one piece per slot of the layout,
as ``jax.device_put`` with a ``NamedSharding`` places its shards, and
:meth:`Rules.assemble` puts the pieces back together;
:func:`shard_tree` and :func:`assemble_tree` do the same for a tree of
tensors named by a tree of logical axes (the JAX ``in_shardings`` of a
parameter tree, ``launch/steps.py``'s ``_spec_tree``). The LM serving
path cuts its parameters so (``transformer.lm_param_logical``, under
:func:`serve_logical`); the other programs over a layout
(``flash_decode``'s cache, ``gnn.ring_aggregate``,
``ef_compressed_psum_axis``) shard their own inputs.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from ..launch.mesh import Layout

__all__ = ["Rules", "shard_tree", "assemble_tree", "serve_logical",
           "SERVE_PARAM_SHARDINGS"]

# RunOptions.serve_param_sharding: rows over the data axes and columns
# over model ("2d", FSDP x tensor), or replicated over the data axes
SERVE_PARAM_SHARDINGS = ("2d", "tp_only")


class Rules:
    def __init__(self, layout: Layout):
        self.layout = layout
        names = layout.axis_names
        dp = ("pod", "data") if "pod" in names else ("data",)
        self.map = {
            "batch": dp,
            "fsdp": dp,
            "tensor": ("model",),
            "expert": ("model",),
            "cells": tuple(names),
            "seq": ("model",),             # sequence-parallel residual stream
            "seq_kv": ("model",),
            "seq_kv_wide": tuple(names),   # batch=1 long-context decode
            None: None,
        }
        self.axis_sizes = layout.axis_sizes

    def size(self, logical: Optional[str]) -> int:
        """Devices a dimension of this logical axis is split over."""
        axes = self.map.get(logical, None)
        if not axes:
            return 1
        out = 1
        for a in axes:
            out *= self.axis_sizes.get(a, 1)
        return out

    def spec(self, *logical: Optional[str]) -> tuple:
        """Per dimension: ``None``, a layout axis or a tuple of them."""
        parts = []
        for name in logical:
            m = self.map.get(name, None) if name is not None else None
            if m is None:
                parts.append(None)
            elif len(m) == 1:
                parts.append(m[0])
            else:
                parts.append(m)
        return tuple(parts)

    def local_shape(self, shape: tuple, *logical: Optional[str]) -> tuple:
        """The per-device shape of a global ``shape`` whose dimensions are
        named ``logical``: each divided by its axis's size (which must
        divide it)."""
        if len(logical) != len(shape):
            raise ValueError(f"{len(shape)} dimensions, {len(logical)} "
                             f"logical axes")
        out = []
        for n, name in zip(shape, logical):
            k = self.size(name)
            if n % k:
                raise ValueError(f"dimension {n} of axis {name!r} does not "
                                 f"split over {k} devices")
            out.append(n // k)
        return tuple(out)

    def axes(self, name: Optional[str]) -> tuple:
        """The layout axes a dimension of logical axis ``name`` is split
        over (those of its rule the layout has)."""
        m = self.map.get(name, None) if name is not None else None
        return tuple(a for a in (m or ()) if a in self.axis_sizes)

    def blocks(self, slot: int, *logical: Optional[str]) -> tuple:
        """Per dimension, ``(block, blocks)``: which of the dimension's
        ``blocks`` equal parts slot ``slot`` holds."""
        out = []
        for name in logical:
            axes = self.axes(name)
            out.append((self.layout.axis_index(slot, axes),
                        self.layout.axis_size(axes)) if axes else (0, 1))
        return tuple(out)

    def shard(self, x: torch.Tensor, *logical: Optional[str]) -> list:
        """One piece of ``x`` per slot: each dimension cut into its
        logical axis's blocks, the slot's block taken; the piece is on
        the slot's device, a view of ``x`` where that device is ``x``'s
        own (no copy), a copy otherwise."""
        local = self.local_shape(tuple(x.shape), *logical)
        pieces = []
        for s in range(self.layout.size):
            p = x
            for d, ((i, _), n) in enumerate(zip(self.blocks(s, *logical),
                                                local)):
                if n != x.shape[d]:
                    p = p.narrow(d, i * n, n)
            pieces.append(p.to(self.layout.device(s)))
        return pieces

    def assemble(self, pieces: Sequence[torch.Tensor],
                 *logical: Optional[str], device=None) -> torch.Tensor:
        """The inverse of :meth:`shard`: the global tensor on ``device``
        (default the first piece's), each block copied once from the
        first slot that holds it (the others hold replicas)."""
        if len(pieces) != self.layout.size:
            raise ValueError(f"assemble: one piece per slot, "
                             f"{self.layout.size} slots, got {len(pieces)}")
        p0 = pieces[0]
        if len(logical) != p0.dim():
            raise ValueError(f"{p0.dim()} dimensions, {len(logical)} "
                             f"logical axes")
        counts = [n for _, n in self.blocks(0, *logical)]
        out = torch.empty([k * n for k, n in zip(p0.shape, counts)],
                          dtype=p0.dtype,
                          device=p0.device if device is None else device)
        done = set()
        for s, p in enumerate(pieces):
            key = tuple(i for i, _ in self.blocks(s, *logical))
            if key in done:
                continue
            if tuple(p.shape) != tuple(p0.shape):
                raise ValueError(f"assemble: piece {s} is "
                                 f"{tuple(p.shape)}, piece 0 "
                                 f"{tuple(p0.shape)}")
            done.add(key)
            view = out
            for d, i in enumerate(key):
                if counts[d] > 1:
                    view = view.narrow(d, i * p0.shape[d], p0.shape[d])
            view.copy_(p)
        return out


def shard_tree(rules: Rules, tree: dict, logical: dict) -> list:
    """One piece tree a slot: every tensor of ``tree`` (nested dicts)
    cut by :meth:`Rules.shard` under the logical axes at the same place
    of ``logical`` (a tuple a tensor). A piece on the tensor's own device
    is a view of it."""
    if isinstance(tree, dict):
        cut = {k: shard_tree(rules, v, logical[k]) for k, v in tree.items()}
        return [{k: pieces[s] for k, pieces in cut.items()}
                for s in range(rules.layout.size)]
    return rules.shard(tree, *logical)


def assemble_tree(rules: Rules, pieces: Sequence[Any], logical: dict,
                  device=None) -> Any:
    """The inverse of :func:`shard_tree`: the global tree on ``device``
    (default each tensor's first piece's) from one piece tree a slot."""
    if isinstance(logical, dict):
        return {k: assemble_tree(rules, [p[k] for p in pieces], logical[k],
                                 device) for k in pieces[0]}
    return rules.assemble(pieces, *logical, device=device)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def serve_logical(logical: Any, opts) -> Any:
    """A parameter tree's logical axes for serving under
    ``opts.serve_param_sharding``: as they are under ``"2d"``; under
    ``"tp_only"`` (weight-stationary serving) ``"fsdp"`` becomes ``None``,
    the weights replicated over the data axes, as the JAX ``_lm_bundle``
    maps them."""
    mode = opts.serve_param_sharding
    if mode not in SERVE_PARAM_SHARDINGS:
        raise ValueError(f"serve_param_sharding={mode!r}: one of "
                         f"{SERVE_PARAM_SHARDINGS}")
    if mode == "2d":
        return logical
    if _is_axes(logical):
        return tuple(None if a == "fsdp" else a for a in logical)
    return {k: serve_logical(v, opts) for k, v in logical.items()}
