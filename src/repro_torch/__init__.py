"""repro_torch: batch HC-s-t path query processing in PyTorch + CUDA.

The PyTorch/CUDA counterpart of the ``repro`` package, built beside it
slice by slice. It imports ``torch`` and never ``jax``, and nothing of
``repro``: where it needs code from a numpy-only module there, it keeps
its own copy. The layout mirrors ``repro`` (``core/``, ``kernels/<op>/``)
so each counterpart is found by path.

Entry points (:class:`~repro_torch.core.engine.BatchPathEngine`,
:class:`~repro_torch.core.session.PathSession`) run on the CUDA device
unless the caller passes ``device="cpu"``; they never fall back to the CPU
on their own. The hand-written kernels live in ``csrc/`` and build with
``nvcc`` at first use (see :mod:`repro_torch.kernels.build`).
"""
__version__ = "0.1.0"
