"""Named device layouts: the counterpart of ``repro/launch/mesh.py``.

A layout is plain data (its axis names, its shape and, for ``cells``, the
CUDA devices it is made of); nothing here starts ``torch.distributed`` or
a process group.

  host      (1, 1)        ("data", "model")          one device
  cells     (n,)          ("cells",)                 n CUDA devices, the list
                                                     ``ShardedExecutor`` takes
  pod       (16, 16)      ("data", "model")          256 devices, as a shape
  multipod  (2, 16, 16)   ("pod", "data", "model")   512 devices, as a shape

``pod`` and ``multipod`` name the JAX package's production meshes; no
sharded model code runs on them yet (the substrate's mesh options).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

__all__ = ["Layout", "make_host_mesh", "make_production_mesh",
           "make_cells_mesh", "mesh_by_name", "MESH_NAMES"]

MESH_NAMES = ("host", "cells", "pod", "multipod")


@dataclasses.dataclass(frozen=True)
class Layout:
    """A named device layout: ``shape`` along ``axis_names``, and the
    devices it is made of (``None`` where the layout names no device)."""
    name: str
    axis_names: tuple
    shape: tuple
    devices: Optional[tuple] = None

    @property
    def size(self) -> int:
        """The number of devices."""
        return math.prod(self.shape)

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))


def make_host_mesh() -> Layout:
    """One device: the CPU tests', one card's, the dry run's."""
    return Layout("host", ("data", "model"), (1, 1))


def make_production_mesh(*, multi_pod: bool = False) -> Layout:
    """The JAX package's production meshes, as shapes with axis names."""
    if multi_pod:
        return Layout("multipod", ("pod", "data", "model"), (2, 16, 16))
    return Layout("pod", ("data", "model"), (16, 16))


def make_cells_mesh(n_devices: int = 0) -> Layout:
    """1-D ``cells`` layout over the first ``n_devices`` visible CUDA
    devices (0: all of them), the device list the sharded engine takes."""
    have = torch.cuda.device_count()
    n = have if not n_devices else int(n_devices)
    if n < 1 or n > have:
        raise ValueError(f"asked for {n} CUDA devices, have {have}")
    return Layout("cells", ("cells",), (n,),
                  tuple(torch.device("cuda", i) for i in range(n)))


def mesh_by_name(name: str) -> Layout:
    if name == "pod":
        return make_production_mesh(multi_pod=False)
    if name == "multipod":
        return make_production_mesh(multi_pod=True)
    if name == "host":
        return make_host_mesh()
    if name == "cells":
        return make_cells_mesh()
    raise KeyError(f"unknown mesh {name!r}; known: {list(MESH_NAMES)}")
