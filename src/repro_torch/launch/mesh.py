"""Named device layouts: the counterpart of ``repro/launch/mesh.py``.

A layout is plain data: its axis names, its shape and the device of each
slot, slots numbered row-major over the axes as ``jax.make_mesh`` orders
its devices. Nothing here starts ``torch.distributed`` or a process
group: the programs over a layout (``launch/collectives.py``) are
single-controller, like JAX's, and run each slot's work on that slot's
CUDA stream.

  host      (data, model) ("data", "model")          data x model slots;
                                                     (1, 1) by default
  cells     (n,)          ("cells",)                 n CUDA devices, the list
                                                     ``ShardedExecutor`` takes
  pod       (16, 16)      ("data", "model")          256 devices, as a shape
  multipod  (2, 16, 16)   ("pod", "data", "model")   512 devices, as a shape

A slot's device may repeat: ``make_host_mesh(2, 4)`` on one card is eight
slots of ``cuda:0``, each on its own stream. ``pod`` and ``multipod`` name
the JAX package's production meshes and hold no devices: the LM serving
path runs over a host layout of slots (``transformer.LM(..., mesh=...)``),
and the dry run on these shapes waits for the sharded train step and the
GNN and recsys parameter splits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import torch

__all__ = ["Layout", "make_host_mesh", "make_production_mesh",
           "make_cells_mesh", "mesh_by_name", "MESH_NAMES"]

MESH_NAMES = ("host", "cells", "pod", "multipod")

DeviceLike = Union[torch.device, str]


@dataclasses.dataclass(frozen=True)
class Layout:
    """A named device layout: ``shape`` along ``axis_names``, and the
    device of each slot in row-major order (``None`` where the layout
    names no device). The devices are of one type: a list that mixes CPU
    and CUDA slots raises ``ValueError``."""
    name: str
    axis_names: tuple
    shape: tuple
    devices: Optional[tuple] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"layout {self.name!r}: {len(self.shape)} "
                             f"dimensions, {len(self.axis_names)} axis names")
        if self.devices is None:
            return
        devs = tuple(_indexed(torch.device(d)) for d in self.devices)
        if len(devs) != self.size:
            raise ValueError(f"layout {self.name!r} of shape {self.shape} "
                             f"has {self.size} slots, got {len(devs)} "
                             f"devices")
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"layout {self.name!r} mixes device types "
                             f"{sorted({d.type for d in devs})}: its slots "
                             f"are all CPU or all CUDA")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        """The number of slots."""
        return math.prod(self.shape)

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    def device(self, slot: int) -> torch.device:
        """The device of ``slot``; ``ValueError`` where the layout names
        none (``pod``, ``multipod``, or ``host`` made without a card)."""
        if self.devices is None:
            raise ValueError(f"layout {self.name!r} names no devices: pass "
                             f"devices= (e.g. ['cpu'] * {self.size})")
        return self.devices[slot]

    def coords(self, slot: int) -> tuple:
        """The coordinates of ``slot`` along the axes (row-major)."""
        out = []
        for n in reversed(self.shape):
            slot, c = divmod(slot, n)
            out.append(c)
        return tuple(reversed(out))

    def _axes(self, axes: Union[str, Sequence[str]]) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"layout {self.name!r} has axes "
                                 f"{self.axis_names}, not {a!r}")
        return axes

    def axis_index(self, slot: int, axes: Union[str, Sequence[str]]) -> int:
        """``jax.lax.axis_index``: the position of ``slot`` along ``axes``
        (one name, or several flattened row-major in the layout's
        order)."""
        axes = self._axes(axes)
        c = self.coords(slot)
        i = 0
        for a, n, x in zip(self.axis_names, self.shape, c):
            if a in axes:
                i = i * n + x
        return i

    def axis_size(self, axes: Union[str, Sequence[str]]) -> int:
        return math.prod(self.axis_sizes[a] for a in self._axes(axes))

    def groups(self, axes: Union[str, Sequence[str]]) -> list:
        """The slots along ``axes`` as groups: the slots that share their
        coordinates on every other axis, each group ordered by
        :meth:`axis_index` (the members of one collective), the groups in
        the order of their first slot."""
        axes = self._axes(axes)
        keyed = {}
        for s in range(self.size):
            c = self.coords(s)
            key = tuple(x for a, x in zip(self.axis_names, c)
                        if a not in axes)
            keyed.setdefault(key, []).append(s)
        return [sorted(g, key=lambda s: self.axis_index(s, axes))
                for g in keyed.values()]


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so that slots compare equal to
    their tensors' devices."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _devices(n: int, devices: Optional[Sequence[DeviceLike]]):
    """``devices`` as a tuple, or the first visible CUDA device repeated
    ``n`` times (``None`` where there is no card: the layout then names
    no device, as the dry run's ``host`` on ``meta``)."""
    if devices is not None:
        return tuple(devices)
    if torch.cuda.is_available():
        return (torch.device("cuda", 0),) * n
    return None


def make_host_mesh(data: int = 1, model: int = 1,
                   devices: Optional[Sequence[DeviceLike]] = None) -> Layout:
    """``data x model`` slots over ``("data", "model")``, row-major as
    ``jax.make_mesh((data, model), ("data", "model"))`` orders its
    devices. ``devices``: one per slot, repeats allowed (``["cpu"] * 8``
    in the CPU tests; default the first visible CUDA device repeated, so
    that one card holds every slot, each on its own stream)."""
    if data < 1 or model < 1:
        raise ValueError(f"make_host_mesh({data}, {model}): sizes must be "
                         f">= 1")
    return Layout("host", ("data", "model"), (int(data), int(model)),
                  _devices(data * model, devices))


def make_production_mesh(*, multi_pod: bool = False) -> Layout:
    """The JAX package's production meshes, as shapes with axis names."""
    if multi_pod:
        return Layout("multipod", ("pod", "data", "model"), (2, 16, 16))
    return Layout("pod", ("data", "model"), (16, 16))


def make_cells_mesh(n_devices: int = 0,
                    devices: Optional[Sequence[DeviceLike]] = None) -> Layout:
    """1-D ``cells`` layout: over ``devices`` where given (repeats
    allowed), else over the first ``n_devices`` visible CUDA devices (0:
    all of them), the device list the sharded engine takes."""
    if devices is not None:
        return Layout("cells", ("cells",), (len(devices),), tuple(devices))
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
