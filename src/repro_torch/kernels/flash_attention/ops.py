"""Causal GQA attention (``flash_attention``) for the transformer.

Counterpart of ``repro/kernels/flash_attention``: ``flash_attention_ref``
is the plain PyTorch version (exact softmax attention in float32, the
scores materialised, as ``ref.py``), ``flash_attention_cuda`` the wrapper
of ``csrc/flash_attention.cu`` (which says what it replaces, what bounds
it and how it is designed), and ``gqa_attention`` picks the arm from the
tensors' device.

Both arms keep the model's layout, ``q (B, Sq, Hq, hd)`` and
``k, v (B, Skv, Hkv, hd)`` in and ``(B, Sq, Hq, hd)`` out, and index
kv-head ``h // (Hq // Hkv)`` for q-head ``h``: K and V are never expanded
per q-head. Two arguments widen the JAX kernel's contract:

* ``q_offset``: the absolute position of ``q[:, 0]``. Causal key ``j`` is
  visible to query ``i`` iff ``j <= q_offset + i``. The default,
  ``Skv - Sq``, aligns the queries to the end of the keys, as ``ref.py``
  and the Pallas kernel do.
* ``kv_valid_len``: keys at or beyond it are masked (a KV cache's unwritten
  tail, as in the JAX package's ``chunked_attention``). Neither arm reads
  them: the kernel's key loop stops there. Default ``Skv``.

A row that sees no key gives zeros in both arms (``ref.py`` would average
V over all keys there; with the default ``q_offset`` and ``Sq <= Skv``
every row sees key 0, so the two agree).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import build
from ..registry import LAUNCHES, ArmLike, KernelArm, resolve_arm

__all__ = ["gqa_attention", "flash_attention_ref", "flash_attention_cuda",
           "MAX_HEAD_DIM"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"flash_attention_launch":
               [_P, _P, _P, _P] + [_I] * 5 + [_L] * 9 + [_I] * 5 + [_P]}

MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)


def _shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Check the ranks and the GQA grouping; (B, Sq, Hq, Skv, Hkv, hd)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q, k, v must be 4-D (B, S, H, "
                         f"hd), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k and v must be (B, Skv, Hkv, "
                         f"hd) = ({B}, Skv, Hkv, {hd}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv != 0:
        raise ValueError(f"flash_attention: Hq = {Hq} is not a multiple of "
                         f"Hkv = {Hkv}")
    return B, Sq, Hq, Skv, Hkv, hd


def _window(Sq: int, Skv: int, q_offset: Optional[int],
            kv_valid_len: Optional[int]) -> tuple[int, int]:
    q_offset = Skv - Sq if q_offset is None else int(q_offset)
    valid = Skv if kv_valid_len is None else int(kv_valid_len)
    return q_offset, max(0, min(valid, Skv))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, *,
                        q_offset: Optional[int] = None,
                        kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """Plain version: exact softmax attention in float32 over the first
    ``kv_valid_len`` keys (the ``(B, Hkv, G, Sq, kv_valid_len)`` scores
    are materialised), cast to ``q``'s type."""
    B, Sq, Hq, Skv, Hkv, hd = _shapes(q, k, v)
    q_offset, valid = _window(Sq, Skv, q_offset, kv_valid_len)
    G = Hq // Hkv
    k, v = k[:, :valid].float(), v[:, :valid].float()   # the tail is unread
    qf = q.float().reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k) / (hd ** 0.5)
    if causal:
        kv_pos = torch.arange(valid, device=q.device)
        q_pos = torch.arange(Sq, device=q.device) + q_offset
        s = s.masked_fill(kv_pos[None, :] > q_pos[:, None], float("-inf"))
    # a row with no visible key: softmax gives NaN, the kernel gives 0
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, *,
                         q_offset: Optional[int] = None,
                         kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` (contract of
    :func:`flash_attention_ref`). q, k, v: float32 or bfloat16, one type,
    one CUDA device, the last dimension contiguous (any other strides, e.g.
    a layer of the KV cache), ``hd <= 256``."""
    B, Sq, Hq, Skv, Hkv, hd = _shapes(q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one type of "
                        f"{_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"flash_attention: the CUDA kernel needs q, k, v on "
                         f"one CUDA device, got {q.device}, {k.device}, "
                         f"{v.device}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} outside "
                         f"1..{MAX_HEAD_DIM}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.numel() and x.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s last dimension is "
                             f"not contiguous (strides {x.stride()})")
    q_offset, valid = _window(Sq, Skv, q_offset, kv_valid_len)
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    vec = int(q.dtype == torch.bfloat16 and hd % 8 == 0
              and all(s % 8 == 0 for s in strides)
              and all(x.data_ptr() % 16 == 0 for x in (q, k, v)))
    lib = build.load("flash_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Hq, Hkv, hd, *strides, int(bool(causal)), q_offset, valid,
        _DTYPES.index(q.dtype), vec, stream)
    build.check(lib, rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, *, q_offset: Optional[int] = None,
                  kv_valid_len: Optional[int] = None,
                  arm: ArmLike = None) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd), Hq % Hkv == 0.

    Returns (B, Sq, Hq, hd) in q's type, on the arm of the tensors'
    device: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.
    """
    if resolve_arm(q.device, arm) is KernelArm.CUDA:
        return flash_attention_cuda(q, k, v, causal, q_offset=q_offset,
                                    kv_valid_len=kv_valid_len)
    return flash_attention_ref(q, k, v, causal, q_offset=q_offset,
                               kv_valid_len=kv_valid_len)
