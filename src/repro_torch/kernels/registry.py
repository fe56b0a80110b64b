"""Kernel arms and the rule that picks one.

Every ported op has two interchangeable implementations:

  ``torch`` -- the plain PyTorch version (runs on the CPU; the CPU tests
               compare it with the JAX package's ``ref.py`` and Pallas
               interpret mode)
  ``cuda``  -- the hand-written CUDA C++ kernel in ``repro_torch/csrc``

and the ops a step bundle reaches (``msbfs_step``, ``expand_level``,
``flash_attention`` and ``flash_attention_bwd``) a third, for the dry run
(``launch/dryrun.py``), which traces a step on ``meta`` tensors:

  ``meta``  -- empty outputs of the kernel's shapes and types; nothing is
               computed or launched. It tells the listeners of
               :func:`meta_launch` (``launch/op_analysis.py``'s census) of
               the call and its analytic operations and bytes.

The arm follows the tensor's device: a CPU tensor takes ``torch``, a CUDA
tensor takes ``cuda``, a meta tensor ``meta``. An explicit choice that contradicts the device
raises ``ValueError`` (``torch`` for a CUDA tensor, ``cuda`` for a CPU
tensor), and so does an unknown name, listing the valid ones. There is no
environment variable and no "auto" rule: nothing routes a CUDA tensor to
the plain version, so a kernel that fails to build or launch raises
instead of silently running the plain path.

``LAUNCHES`` counts the CUDA launches of each kernel (plain integers),
and, beside a wrapper's count, the launches of each route of a wrapper
that picks among kernels by shape (``ROUTE_COUNTS``). Wrappers add to it
through :func:`count_launch`, under one lock: the sharded executor's
replica threads launch concurrently, and a bare ``+= 1`` (read, add,
store) could lose a count.
"""
from __future__ import annotations

import contextlib
import enum
import threading
from typing import Callable, Union

import torch

__all__ = ["KernelArm", "ArmLike", "resolve_arm", "resolve_device",
           "check_tensor", "KERNELS", "ROUTE_COUNTS", "LAUNCHES",
           "count_launch", "reset_launches", "meta_launch",
           "add_meta_listener", "remove_meta_listener"]

# the hand-written kernels; each wrapper adds one to its LAUNCHES entry
# where it launches its kernel, and nowhere else, so a run can show that
# the main path went through the kernels
KERNELS = ("msbfs_step", "pairwise_popcount", "gamma_pack", "path_member",
           "rowwise_overlap", "ell_spmm", "msbfs_expand", "path_overlap",
           "flash_attention", "flash_attention_bwd")
# the routes of flash_attention (``attn_`` and a name of its ops.ROUTES;
# one count per launch of the route's kernel, or of its pair for
# attn_splitk and attn_splitk_f8, the split-K kernel on a float8 KV cache)
# and of flash_attention_bwd (``bwd_`` and a name of ops.BWD_ROUTES),
# ell_spmm's F = 1 kernel, and the fused passes that carry path_member
# (one expand level) and rowwise_overlap (one join) on the engine's path
# (each also counted under its kernel's name)
ROUTE_COUNTS = ("attn_wgmma", "attn_splitk", "attn_splitk_f8", "attn_mma",
                "attn_scalar", "bwd_wgmma", "bwd_mma", "bwd_scalar",
                "ell_gather_f1", "level_fused", "join_fused")
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS + ROUTE_COUNTS, 0)
_LAUNCHES_LOCK = threading.Lock()


def count_launch(*names: str) -> None:
    """Add one launch to each of ``names``, atomically across threads."""
    with _LAUNCHES_LOCK:
        for name in names:
            LAUNCHES[name] += 1


def reset_launches() -> None:
    """Set every kernel's and every route's launch count to 0."""
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


class KernelArm(str, enum.Enum):
    """Typed kernel-arm selector (str subclass: compares to its value)."""

    TORCH = "torch"
    CUDA = "cuda"
    META = "meta"

    @classmethod
    def coerce(cls, value: Union["KernelArm", str]) -> "KernelArm":
        if isinstance(value, cls):
            return value
        try:
            return cls(str(value).lower())
        except ValueError:
            raise ValueError(
                f"unknown kernel arm {value!r}; valid arms: "
                f"{' | '.join(a.value for a in cls)}") from None

    def __str__(self) -> str:
        return self.value


ArmLike = Union[KernelArm, str, None]

_ARM_OF_DEVICE = {"cpu": KernelArm.TORCH, "cuda": KernelArm.CUDA,
                  "meta": KernelArm.META}

# the listeners of kernel calls on the meta arm: callables taking
# (name, operations, bytes) and returning a context manager that is open
# while the meta version builds its outputs
_META_LISTENERS: list[Callable] = []


def add_meta_listener(listener: Callable) -> None:
    _META_LISTENERS.append(listener)


def remove_meta_listener(listener: Callable) -> None:
    _META_LISTENERS.remove(listener)


@contextlib.contextmanager
def meta_launch(name: str, ops: float, nbytes: float):
    """Open around a meta version's output allocation: one call of kernel
    ``name`` whose work is ``ops`` operations and ``nbytes`` bytes moved
    (the bound rules of ``PERF.md`` section 6, from the shapes alone)."""
    with contextlib.ExitStack() as stack:
        for listener in tuple(_META_LISTENERS):
            stack.enter_context(listener(name, ops, nbytes))
        yield


def resolve_arm(device: Union[torch.device, str],
                arm: ArmLike = None) -> KernelArm:
    """The arm for tensors on ``device``; an explicit ``arm`` must agree.

    Raises ``ValueError`` for an unknown arm name, for an arm that
    contradicts the device, and for a device type with no arm.
    """
    dev_type = torch.device(device).type
    if dev_type not in _ARM_OF_DEVICE:
        raise ValueError(f"no kernel arm for device type {dev_type!r}; "
                         f"supported: {sorted(_ARM_OF_DEVICE)}")
    native = _ARM_OF_DEVICE[dev_type]
    if arm is None:
        return native
    chosen = KernelArm.coerce(arm)
    if chosen is not native:
        raise ValueError(
            f"kernel arm {chosen.value!r} cannot run on a {dev_type} tensor "
            f"(the {dev_type} arm is {native.value!r})")
    return chosen


def resolve_device(device: Union[torch.device, str, None]) -> torch.device:
    """The device of an entry point: ``None`` means ``"cuda"``; a CUDA
    device without CUDA raises. The entry points never carry on on the CPU
    unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "kernel versions on the CPU")
    return dev


def check_tensor(name: str, x: torch.Tensor, dtype: torch.dtype,
                 ndim: int, *, strided_rows: bool = False) -> None:
    """Shared argument check of the CUDA wrappers: dtype, rank, a CUDA
    device, and contiguity -- full, or of the last dimension only where
    the kernel takes a row stride (``strided_rows``)."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape "
                         f"{tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, "
                         f"got one on {x.device}")
    ok = (x.numel() == 0 or x.stride(-1) == 1) if strided_rows \
        else x.is_contiguous()
    if not ok:
        raise ValueError(f"{name}: not contiguous (shape {tuple(x.shape)}, "
                         f"strides {x.stride()})")
