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
No array is sharded yet (DTensor waits for the substrate's mesh options):
on ``host`` every size is 1 and :meth:`Rules.local_shape` is the global
shape.
"""
from __future__ import annotations

from typing import Optional

from ..launch.mesh import Layout

__all__ = ["Rules"]


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
