"""Hand-written CUDA kernels for the engine's hot spots, the kernel ops
API (``msbfs_hop_packed``, ``path_overlap`` and the join-validity
matrices) and the transformer's attention (``flash_attention``), each
beside its plain PyTorch version.

Each op package has one ``ops`` module holding the plain version, the
wrapper of the CUDA kernel in ``repro_torch/csrc`` and the function that
picks between them by the tensors' device (:mod:`.registry`). The kernels
build with ``nvcc`` at first use (:mod:`.build`).
"""
from .registry import (KERNELS, LAUNCHES, ROUTE_COUNTS,  # noqa: F401
                       KernelArm, count_launch, reset_launches, resolve_arm)

__all__ = ["KernelArm", "resolve_arm", "KERNELS", "ROUTE_COUNTS",
           "LAUNCHES", "count_launch", "reset_launches"]
