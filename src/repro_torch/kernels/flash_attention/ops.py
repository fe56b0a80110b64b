"""Causal GQA attention (``flash_attention``) for the transformer.

Counterpart of ``repro/kernels/flash_attention``: ``flash_attention_ref``
is the plain PyTorch version (exact softmax attention in float32, the
scores materialised, as ``ref.py``), ``flash_attention_splitk_ref`` the
same function computed as the decode route computes it (per-chunk
partials merged by log-sum-exp), ``flash_attention_cuda`` the wrapper of
``csrc/flash_attention.cu`` (which says what it replaces, what bounds it
and how it is designed), and ``gqa_attention`` picks the arm from the
tensors' device.

The wrapper picks one of four kernels by shape alone
(:func:`attention_route`): in bf16 ``splitk`` for decode rows,
``wgmma`` for more rows at hd 64 or 128, ``mma`` for the other shapes;
``scalar`` for float32. ``LAUNCHES["flash_attention"]`` counts its calls and
``LAUNCHES["attn_<route>"]`` each route's.

A float8 KV cache (``torch.float8_e4m3fn`` k and v beside a bf16 or
float32 q): the plain version dequantises the keys and values to bf16 and
rounds p to bf16 before the PV product, as the JAX ``chunked_attention``
does with such a cache (its ``"jnp"`` arm, whatever q's type). On the
card a bf16 q with decode rows takes ``splitk_f8``, the split-K kernel
reading the one-byte cache itself; any other pair (more rows, or a
float32 q) first converts the visible keys and values to q's type (an
explicit copy of ``[:kv_valid_len]``, exact: every e4m3 value is a bf16
and a float32 value) and takes that type's route. The bf16 routes round p
to bf16 for their tensor cores anyway; the float32 route (``scalar``) is
told to (``round_p``): it finds each row's max in a first pass over the
keys and rounds ``p = exp(s - max)`` as the plain version does, so a
float32 model over a float8 cache keeps the reference's rounding on the
card too. The two then differ only where a score's last bit, summed in
another order, moves p across a bf16 rounding boundary.

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

The gradient (no TPU counterpart: the JAX package trains through its
``jnp`` arm). ``return_lse=True`` makes either forward also return each
row's log-sum-exp ``m + log l`` (float32, ``(B, Hq, Sq)``; every CUDA route
writes it from its epilogue, the output unchanged).
``flash_attention_bwd_ref`` is the plain backward (the formulas in
float32), ``flash_attention_bwd_cuda`` the wrapper of
``csrc/flash_attention_bwd.cu`` (``LAUNCHES["flash_attention_bwd"]``; by
:func:`bwd_route`, in bf16 the wgmma kernels at hd 64 or 128 with
16-byte-aligned inputs and a GQA group of at most 64 q-heads,
``LAUNCHES["bwd_wgmma"]``, ``mma.sync`` ones for the other shapes up to
hd 128, ``["bwd_mma"]``, CUDA-core ones otherwise, ``["bwd_scalar"]``),
and
``flash_attention_bwd`` picks by device. ``gqa_attention`` goes through a
``torch.autograd.Function`` whenever grad mode is on and q, k or v needs a
gradient: its forward saves the lse, its backward is the kernel on a CUDA
tensor and the plain backward on a CPU one, never the plain version on
the card. On ``meta`` tensors (the dry run) both go to their meta versions,
which give the outputs' shapes and the work of ``PERF.md`` section 6's
bounds, and compute nothing.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import build
from ..registry import (ArmLike, KernelArm, count_launch, meta_launch,
                        resolve_arm)

__all__ = ["gqa_attention", "attention_partial", "flash_attention_ref",
           "flash_attention_splitk_ref", "flash_attention_cuda",
           "flash_attention_bwd", "flash_attention_bwd_ref", "flash_attention_bwd_cuda",
           "flash_attention_meta", "flash_attention_bwd_meta",
           "visible_pairs", "attention_route", "attention_plan", "splitk_chunks",
           "splitk_stages", "bwd_route",
           "bwd_plan", "bwd_row_tiles", "ROUTES", "BWD_ROUTES",
           "MAX_HEAD_DIM", "F8"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"flash_attention_launch":
               [_P, _P, _P, _P] + [_I] * 5 + [_L] * 9 + [_I] * 10 + [_P] * 4}
_BWD_SIGNATURES = {"flash_attention_bwd_launch":
                   [_P] * 10 + [_I] * 6 + [_L] * 9 + [_I] * 6 + [_L, _P]}
# the backward's kernels by their number in flash_attention_bwd_launch
BWD_ROUTES = ("scalar", "mma", "wgmma")
# the wgmma backward's row tiles: 64 rows, whole positions of a GQA group
BWD_TILE_ROWS = 64

MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)
# the float8 KV cache's type (RunOptions(kv_cache_dtype="f8"))
F8 = torch.float8_e4m3fn
# the kernel of each route, by its number in flash_attention_launch;
# splitk_f8 is attn_splitk_kernel reading float8 keys and values
ROUTES = ("scalar", "mma", "wgmma", "splitk", "splitk_f8")
# attn_wgmma_kernel: its head dims
WGMMA_HEAD_DIMS = (64, 128)
# attn_splitk_kernel: the most rows (Sq * G) of one (kv-head, batch), the
# keys of a warp's tile, the warps of a block (a chunk is whole rounds of
# their tiles), the blocks an SM holds with a float8 hd-128 ring (a wave)
SPLITK_MAX_ROWS = 16
SPLITK_TILE = 32
SPLITK_WARPS = 4
SPLITK_ROUND = SPLITK_TILE * SPLITK_WARPS
SPLITK_BLOCKS_PER_SM = 2
H100_SMS = 132
# the shared memory of a block's rings (csrc/flash_attention.cu,
# SplitGeom): as many stages (2..4) as let two blocks share an SM, else as
# many (at least 1) as one block holds
_SPLITK_RING_TWO, _SPLITK_RING_ONE = 96 * 1024, 200 * 1024


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def attention_route(rows: int, hd: int, dtype: torch.dtype,
                    vec: bool, kv_f8: bool = False) -> str:
    """The kernel for ``rows = Sq * Hq / Hkv`` GQA rows of head dim ``hd``
    (``vec``: 16-byte loads allowed, i.e. hd and every batch / sequence /
    head stride a multiple of 8 and the tensors 16-byte aligned):
    ``scalar`` for float32; in bf16 ``splitk`` for decode rows
    (``rows <= 16``; ``splitk_f8`` with a float8 cache, ``kv_f8``),
    ``wgmma`` for more rows at hd 64 or 128 with ``vec``, ``mma`` for the
    rest (other head dims, unaligned inputs). By shape only. The decode
    routes are bound by the cache's bytes (one read of the valid keys and
    values): their rows ride padded in a 16-row tensor-core tile, whose
    operations stay far below the bytes' time."""
    if dtype == torch.float32:
        return "scalar"
    if rows <= SPLITK_MAX_ROWS:
        return "splitk_f8" if kv_f8 else "splitk"
    if hd in WGMMA_HEAD_DIMS and vec:
        return "wgmma"
    return "mma"


def splitk_chunks(B: int, Hkv: int, key_end: int,
                  sms: int = H100_SMS) -> tuple[int, int]:
    """``(chunk, splits)`` of the decode route: the keys ``[0, key_end)``
    cut into ``splits`` chunks of ``chunk`` keys (the last one shorter), a
    chunk whole rounds of the block's ``SPLITK_WARPS`` warps' 32-key tiles
    (``SPLITK_ROUND`` keys a round). As many splits as keep the ``B * Hkv
    * splits`` blocks within one wave of ``SPLITK_BLOCKS_PER_SM * sms``,
    and no more than give every warp a tile; then the fewest rounds a
    chunk that cover the keys in that many, and the fewest splits that
    take those chunks. A short cache (granite-8b's decode over 544 keys,
    B 4, Hkv 8) thus gets one tile a warp in 5 chunks of 128 keys (160
    blocks: a latency of one tile and the merge, not bytes); a long one
    (32,768 keys) 8 chunks of 4,096 keys (256 blocks, 32 tiles a warp:
    bytes). The plan is the same for the bf16 and the float8 cache, so
    both routes merge the same partials in the same order."""
    tiles = max(1, -(-key_end // SPLITK_TILE))
    pairs = max(1, B * Hkv)
    wave = SPLITK_BLOCKS_PER_SM * sms
    splits = max(1, min(-(-tiles // SPLITK_WARPS), wave // pairs))
    rounds = -(-tiles // (splits * SPLITK_WARPS))      # a chunk's rounds
    chunk = rounds * SPLITK_ROUND
    return chunk, -(-max(key_end, 1) // chunk)


def splitk_stages(hd: int, kv_bytes: int,
                  chunk: Optional[int] = None) -> int:
    """The ring stages of each warp of the decode kernel at head dim
    ``hd`` over a cache of ``kv_bytes`` bytes a value (2 bf16, 1 float8):
    its ``SplitGeom<HDP, KVB>::STAGES`` (HDP = hd rounded up to 16, 32, 64,
    128 or 256), or 1 for a ``chunk`` of at most one round of the warps'
    tiles (no warp has a second tile; the smaller ring lets more blocks
    share an SM). They set the bytes in flight, not the arithmetic: the
    plan and the result do not depend on them."""
    if chunk is not None and chunk <= SPLITK_ROUND:
        return 1
    hdp = next(p for p in (16, 32, 64, 128, 256) if hd <= p)
    per_stage = SPLITK_WARPS * 2 * SPLITK_TILE * hdp * kv_bytes
    fit2 = _SPLITK_RING_TWO // per_stage
    if fit2 >= 2:
        return min(fit2, 4)
    return max(1, min(4, _SPLITK_RING_ONE // per_stage))


def _aligned(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """16-byte loads allowed: bf16, hd and every batch / sequence / head
    stride a multiple of 8 values (of 16 for float8 keys and values, 16 of
    which a load carries), each tensor 16-byte aligned."""
    per16 = 16 // k.element_size()
    return (q.dtype == torch.bfloat16 and q.shape[3] % per16 == 0
            and all(s % 8 == 0 for s in q.stride()[:3])
            and all(s % per16 == 0 for x in (k, v) for s in x.stride()[:3])
            and all(x.data_ptr() % 16 == 0 for x in (q, k, v)))


def attention_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, *, q_offset: Optional[int] = None,
                   kv_valid_len: Optional[int] = None,
                   sms: int = H100_SMS) -> tuple[str, int, int]:
    """What :func:`flash_attention_cuda` launches for these tensors:
    ``(route, chunk, splits)``, the last two 0 except for ``splitk``,
    whose chunks cut the keys up to the last one any row sees."""
    B, Sq, Hq, Skv, Hkv, hd = _shapes(q, k, v)
    q_offset, valid = _window(Sq, Skv, q_offset, kv_valid_len)
    kv_f8 = k.dtype == F8
    route = attention_route(Sq * (Hq // Hkv), hd, q.dtype,
                            _aligned(q, k, v), kv_f8)
    if kv_f8 and route != "splitk_f8":
        # the route of the copies _f8_to_q_type makes: contiguous, fresh
        # (aligned), in q's type, so 16-byte loads follow q's own layout
        route = attention_route(Sq * (Hq // Hkv), hd, q.dtype,
                                _aligned(q, q, q))
    if not route.startswith("splitk"):
        return route, 0, 0
    key_end = max(0, min(valid, q_offset + Sq)) if causal else valid
    return (route, *splitk_chunks(B, Hkv, key_end, sms))


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


def _scores(q: torch.Tensor, k: torch.Tensor, Hkv: int, causal: bool,
            q_offset: int) -> torch.Tensor:
    """The float32 scores ``q.k / sqrt(hd)``, (B, Hkv, G, Sq, keys), of q
    (B, Sq, Hq, hd) against the keys k (B, keys, Hkv, hd); -inf where the
    causal mask hides a key."""
    B, Sq, Hq, hd = q.shape
    qf = q.float().reshape(B, Sq, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) / (hd ** 0.5)
    if causal:
        kv_pos = torch.arange(k.shape[1], device=q.device)
        q_pos = torch.arange(Sq, device=q.device) + q_offset
        s = s.masked_fill(kv_pos[None, :] > q_pos[:, None], float("-inf"))
    return s


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, *,
                        q_offset: Optional[int] = None,
                        kv_valid_len: Optional[int] = None,
                        return_lse: bool = False,
                        out_dtype: Optional[torch.dtype] = None):
    """Plain version: exact softmax attention in float32 over the first
    ``kv_valid_len`` keys (the ``(B, Hkv, G, Sq, kv_valid_len)`` scores
    are materialised), cast to ``q``'s type; with ``return_lse`` also each
    row's log-sum-exp, float32 (B, Hq, Sq), -inf where no key is seen;
    ``out_dtype`` float32 keeps the output unrounded (a slot's partial,
    :func:`attention_partial`). Float8 k and v (a float8 KV cache) are dequantised to bf16 and p is
    rounded to bf16 before the PV product, as the JAX
    ``chunked_attention`` does over such a cache; the row sums add the
    unrounded p."""
    B, Sq, Hq, Skv, Hkv, hd = _shapes(q, k, v)
    q_offset, valid = _window(Sq, Skv, q_offset, kv_valid_len)
    kv_f8 = k.dtype == F8
    k, v = k[:, :valid], v[:, :valid]                      # the tail unread
    if kv_f8:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    s = _scores(q, k, Hkv, causal, q_offset)
    if kv_f8 and valid:
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m.nan_to_num(0.0, neginf=0.0))   # 0 where masked
        l = p.sum(-1)[..., None].permute(0, 3, 1, 2, 4)    # (B, Sq, Hkv, G)
        acc = torch.einsum("bhgqk,bkhd->bqhgd", p.bfloat16().float(),
                           v.float())
        out = torch.where(l > 0, acc / l.clamp_min(
            torch.finfo(torch.float32).tiny), torch.zeros_like(acc))
    else:
        # a row with no visible key: softmax gives NaN, the kernel gives 0
        p = torch.softmax(s, dim=-1).nan_to_num(0.0)
        out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    out = out.reshape(B, Sq, Hq, hd).to(out_dtype or q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(s, dim=-1).reshape(B, Hq, Sq)


def flash_attention_splitk_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, causal: bool = True, *,
                               q_offset: Optional[int] = None,
                               kv_valid_len: Optional[int] = None,
                               chunk: int = SPLITK_ROUND) -> torch.Tensor:
    """Plain version of the decode route: the key axis cut into chunks of
    ``chunk`` (keys at or past ``kv_valid_len`` masked and never read);
    each chunk's partial softmax state (row max ``m``, row sum ``l``,
    unnormalised ``acc``) in float32, a chunk that sees no key giving
    ``m = -inf, l = 0, acc = 0``; then the merge
    ``sum_c e^(m_c - M) acc_c / sum_c e^(m_c - M) l_c`` with ``M`` the
    largest ``m_c`` (zeros where no chunk sees a key). The same function
    as :func:`flash_attention_ref`, cast to ``q``'s type."""
    B, Sq, Hq, Skv, Hkv, hd = _shapes(q, k, v)
    q_offset, valid = _window(Sq, Skv, q_offset, kv_valid_len)
    if chunk < 1:
        raise ValueError(f"flash_attention: chunk must be >= 1, got {chunk}")
    G = Hq // Hkv
    n = max(1, -(-Skv // chunk))
    pad = n * chunk - valid
    k = torch.nn.functional.pad(k[:, :valid].float(), (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v[:, :valid].float(), (0, 0, 0, 0, 0, pad))
    qf = q.float().reshape(B, Sq, Hkv, G, hd)
    # (B, Hkv, G, Sq, n, chunk)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k) / (hd ** 0.5)
    s = s.reshape(B, Hkv, G, Sq, n, chunk)
    kv_pos = torch.arange(n * chunk, device=q.device).reshape(n, chunk)
    masked = (kv_pos >= valid).expand(Sq, n, chunk)
    if causal:
        q_pos = torch.arange(Sq, device=q.device) + q_offset
        masked = masked | (kv_pos[None] > q_pos[:, None, None])
    s = s.masked_fill(masked, float("-inf"))
    m = s.amax(-1, keepdim=True)                        # -inf: no key seen
    p = torch.exp(s - m.nan_to_num(0.0, neginf=0.0))    # 0 where masked
    l = p.sum(-1)                                       # (..., Sq, n)
    acc = torch.einsum("bhgqnk,bnkhd->bhgqnd", p,
                       v.reshape(B, n, chunk, Hkv, hd))
    m = m[..., 0]
    M = m.amax(-1, keepdim=True)
    w = torch.exp(m - M.nan_to_num(0.0, neginf=0.0))   # 0 for m = -inf
    L = (w * l).sum(-1)
    out = (w[..., None] * acc).sum(-2)
    out = torch.where(L[..., None] > 0, out / L[..., None].clamp_min(
        torch.finfo(torch.float32).tiny), torch.zeros_like(out))
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, *,
                         q_offset: Optional[int] = None,
                         kv_valid_len: Optional[int] = None,
                         return_lse: bool = False,
                         out_dtype: Optional[torch.dtype] = None):
    """Launch ``csrc/flash_attention.cu`` (contract of
    :func:`flash_attention_ref`). q, k, v: float32 or bfloat16, one type,
    or float8 k and v (``F8``) beside either, one CUDA device, the last
    dimension contiguous (any other strides, e.g. a layer of the KV cache),
    ``hd <= 256``. ``out_dtype`` float32 beside a bf16 q is taken by the
    split-K routes only (their merge writes the unrounded output)."""
    B, Sq, Hq, Skv, Hkv, hd = _shapes(q, k, v)
    if q.dtype not in _DTYPES or k.dtype != v.dtype \
            or k.dtype not in (q.dtype, F8):
        raise TypeError(f"flash_attention: q, k, v must share one type of "
                        f"{_DTYPES}, or k and v be {F8}; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
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
    route, chunk, splits = attention_plan(
        q, k, v, causal, q_offset=q_offset, kv_valid_len=valid,
        sms=_sm_count(q.device))
    out_dtype = out_dtype or q.dtype
    out_f32 = out_dtype != q.dtype
    if out_f32 and not (out_dtype == torch.float32
                        and route.startswith("splitk")):
        raise ValueError(f"flash_attention: out_dtype {out_dtype} beside a "
                         f"{q.dtype} q: only the split-K routes write "
                         f"float32 (this shape takes {route!r})")
    out = torch.empty((B, Sq, Hq, hd), dtype=out_dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    round_p = k.dtype == F8 and route == "scalar"
    if k.dtype == F8 and route != "splitk_f8":
        k, v = _f8_to_q_type(q, k, v, valid)
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    part_o = part_ml = None
    if route.startswith("splitk"):
        # the partials (B, Hkv, splits, rows, hd), then their (m, l)
        n = B * Hkv * splits * Sq * (Hq // Hkv)
        scratch = torch.empty(n * (hd + 2), dtype=torch.float32,
                              device=q.device)
        part_o = scratch.data_ptr()
        part_ml = part_o + 4 * n * hd
    lib = build.load("flash_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Hq, Hkv, hd, *strides, int(bool(causal)), q_offset, valid,
        _DTYPES.index(q.dtype), int(_aligned(q, k, v)), ROUTES.index(route),
        chunk, splits, int(round_p), int(out_f32),
        part_o, part_ml, None if lse is None else lse.data_ptr(), stream)
    build.check(lib, rc, "flash_attention")
    count_launch("flash_attention", f"attn_{route}")
    return (out, lse) if return_lse else out


def _f8_to_q_type(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The visible keys and values ``[:, :valid]`` of a float8 cache as
    contiguous copies in q's type (exact: every e4m3 value is a bf16 and a
    float32 value), for the routes that read one type: more than
    ``SPLITK_MAX_ROWS`` rows, or a float32 q. The decode route never takes
    this copy: it reads the float8 cache in place (``splitk_f8``)."""
    return (k[:, :valid].to(q.dtype, memory_format=torch.contiguous_format),
            v[:, :valid].to(q.dtype, memory_format=torch.contiguous_format))


def visible_pairs(Sq: int, q_offset: int, valid: int, causal: bool) -> int:
    """The (query, key) pairs one (batch, q-head) sees: query ``i`` sees
    keys ``0 .. min(q_offset + i, valid - 1)`` when causal, all ``valid``
    keys otherwise."""
    if not causal:
        return Sq * valid

    def upto(n):          # sum of min(x, valid) over x = 1 .. n
        n = max(n, 0)
        m = min(n, valid)
        return m * (m + 1) // 2 + (n - m) * valid

    return upto(q_offset + Sq) - upto(q_offset)


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, *,
                         q_offset: Optional[int] = None,
                         kv_valid_len: Optional[int] = None,
                         return_lse: bool = False,
                         out_dtype: Optional[torch.dtype] = None):
    """The meta arm (the dry run): the forward's outputs, empty. Work by
    ``PERF.md`` section 6's rule: 4 hd operations a visible pair and
    q-head; q, the valid keys and values read once (one byte a value from
    a float8 cache), the output (and lse) written once."""
    B, Sq, Hq, Skv, Hkv, hd = _shapes(q, k, v)
    q_offset, valid = _window(Sq, Skv, q_offset, kv_valid_len)
    pairs = visible_pairs(Sq, q_offset, valid, causal)
    nbytes = q.element_size() * 2 * B * Sq * Hq * hd \
        + k.element_size() * 2 * B * valid * Hkv * hd \
        + (4 * B * Hq * Sq if return_lse else 0)
    with meta_launch("flash_attention", ops=4 * hd * pairs * B * Hq,
                     nbytes=nbytes):
        out = torch.empty((B, Sq, Hq, hd), dtype=out_dtype or q.dtype,
                          device=q.device)
        if not return_lse:
            return out
        return out, torch.empty((B, Hq, Sq), dtype=torch.float32,
                                device=q.device)


def flash_attention_bwd_meta(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True, *,
                             q_offset: Optional[int] = None,
                             kv_valid_len: Optional[int] = None):
    """The meta arm of the backward: ``(dq, dk, dv)``, empty. Work by
    ``PERF.md`` section 6's rule: 10 hd operations a visible pair and
    q-head; q, o, dout, dq and k, v, dk, dv each moved once, lse read."""
    B, Sq, Hq, Skv, Hkv, hd = _shapes(q, k, v)
    q_offset, valid = _window(Sq, Skv, q_offset, kv_valid_len)
    pairs = visible_pairs(Sq, q_offset, valid, causal)
    es = q.element_size()
    nbytes = es * (4 * B * Sq * Hq * hd + 4 * B * Skv * Hkv * hd) \
        + 4 * B * Hq * Sq
    with meta_launch("flash_attention_bwd", ops=10 * hd * pairs * B * Hq,
                     nbytes=nbytes):
        return (torch.empty_like(q, memory_format=torch.contiguous_format),
                torch.empty_like(k, memory_format=torch.contiguous_format),
                torch.empty_like(v, memory_format=torch.contiguous_format))


def bwd_route(group: int, hd: int, dtype: torch.dtype, vec: bool) -> str:
    """The backward's kernels for a GQA group of ``group`` q-heads a
    kv-head at head dim ``hd`` (``vec`` as for :func:`attention_route`):
    ``scalar`` (CUDA cores) for float32 and head dims above 128; in bf16
    ``wgmma`` at hd 64 or 128 with ``vec`` and ``group <= 64`` (a row tile
    is 64 rows of whole positions), ``mma`` for the rest. By shape only."""
    if dtype == torch.float32 or hd > 128:
        return "scalar"
    if hd in WGMMA_HEAD_DIMS and vec and group <= BWD_TILE_ROWS:
        return "wgmma"
    return "mma"


def bwd_row_tiles(Sq: int, group: int) -> tuple[int, int]:
    """``(P, tiles)`` of the wgmma backward: a row tile holds
    ``P = 64 // group`` whole positions of the group's q-heads, and
    ``tiles = ceil(Sq / P)`` of them cover the queries of one (batch,
    kv-head). At G 4: 16 positions, 64 rows; at G 5: 12, 60 rows."""
    P = BWD_TILE_ROWS // group
    return P, -(-Sq // P)


def bwd_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             o: torch.Tensor, dout: torch.Tensor) -> str:
    """The route :func:`flash_attention_bwd_cuda` launches for these
    tensors (``o`` and ``dout`` contiguous, as it passes them on)."""
    return bwd_route(q.shape[2] // k.shape[2], q.shape[3], q.dtype,
                     _bwd_vec(q, k, v, o, dout))


def _bwd_vec(q, k, v, o, dout) -> bool:
    """16-byte loads allowed for the backward: q, k, v as for the forward,
    ``o`` and ``dout`` aligned."""
    return _aligned(q, k, v) and all(x.data_ptr() % 16 == 0
                                     for x in (o, dout))


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor,
                            causal: bool = True, *,
                            q_offset: Optional[int] = None,
                            kv_valid_len: Optional[int] = None):
    """Plain backward, in float32: with ``P = exp(q.k / sqrt(hd) - lse)``
    over the visible keys (0 elsewhere and in a row whose lse is -inf),
    ``D = rowsum(dout * o)`` and ``dS = P * (dout.v - D)``,
    ``dV = P^T dout``, ``dK = dS^T q / sqrt(hd)``, ``dQ = dS k / sqrt(hd)``,
    the q-heads of a GQA group summed into their kv-head; keys at or past
    ``kv_valid_len`` get 0. ``o`` is the forward's output, ``lse`` its
    (B, Hq, Sq) log-sum-exp. Returns ``(dq, dk, dv)`` in the types of q,
    k and v."""
    B, Sq, Hq, Skv, Hkv, hd = _shapes(q, k, v)
    q_offset, valid = _window(Sq, Skv, q_offset, kv_valid_len)
    G = Hq // Hkv
    kf, vf = k[:, :valid].float(), v[:, :valid].float()
    s = _scores(q, kf, Hkv, causal, q_offset)
    m = lse.float().reshape(B, Hkv, G, Sq, 1)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    gf = dout.float().reshape(B, Sq, Hkv, G, hd)
    delta = (gf * o.float().reshape(B, Sq, Hkv, G, hd)).sum(-1)
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", gf, vf)
              - delta.permute(0, 2, 3, 1)[..., None])
    qf = q.float().reshape(B, Sq, Hkv, G, hd)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) / (hd ** 0.5)
    pad = (0, 0, 0, 0, 0, Skv - valid)
    dk = torch.nn.functional.pad(
        torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) / (hd ** 0.5), pad)
    dv = torch.nn.functional.pad(
        torch.einsum("bhgqk,bqhgd->bkhd", p, gf), pad)
    return (dq.reshape(B, Sq, Hq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True, *,
                             q_offset: Optional[int] = None,
                             kv_valid_len: Optional[int] = None):
    """Launch ``csrc/flash_attention_bwd.cu`` (contract of
    :func:`flash_attention_bwd_ref`): q, k, v as for the forward kernel,
    ``o`` and ``dout`` (B, Sq, Hq, hd) of their type (made contiguous),
    ``lse`` float32 (B, Hq, Sq)."""
    B, Sq, Hq, Skv, Hkv, hd = _shapes(q, k, v)
    dt = q.dtype
    if dt not in _DTYPES or any(x.dtype != dt for x in (k, v, o, dout)):
        raise TypeError(f"flash_attention_bwd: q, k, v, o, dout must share "
                        f"one type of {_DTYPES}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}, {o.dtype}, {dout.dtype}")
    tensors = (q, k, v, o, lse, dout)
    if q.device.type != "cuda" or any(x.device != q.device for x in tensors):
        raise ValueError("flash_attention_bwd: the CUDA kernel needs q, k, "
                         "v, o, lse and dout on one CUDA device")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd: head dim {hd} outside "
                         f"1..{MAX_HEAD_DIM}")
    if o.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o and dout must be "
                         f"{tuple(q.shape)}, got {tuple(o.shape)} and "
                         f"{tuple(dout.shape)}")
    if lse.dtype != torch.float32 or lse.shape != (B, Hq, Sq):
        raise ValueError(f"flash_attention_bwd: lse must be float32 "
                         f"{(B, Hq, Sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.numel() and x.stride(3) != 1:
            raise ValueError(f"flash_attention_bwd: {name}'s last dimension "
                             f"is not contiguous (strides {x.stride()})")
    o, dout, lse = o.contiguous(), dout.contiguous(), lse.contiguous()
    q_offset, valid = _window(Sq, Skv, q_offset, kv_valid_len)
    dq = torch.empty((B, Sq, Hq, hd), dtype=dt, device=q.device)
    dk = torch.empty((B, Skv, Hkv, hd), dtype=dt, device=q.device)
    dv = torch.empty((B, Skv, Hkv, hd), dtype=dt, device=q.device)
    if dq.numel() == 0 and dk.numel() == 0:
        return dq, dk, dv
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    vec = _bwd_vec(q, k, v, o, dout)
    route = bwd_route(Hq // Hkv, hd, dt, vec)
    # D (B, Hq, Sq); on wgmma the row tiles' lse * log2 e, then their D
    # (the launch refuses a shorter scratch)
    n = (2 * B * Hkv * bwd_row_tiles(Sq, Hq // Hkv)[1] * BWD_TILE_ROWS
         if route == "wgmma" else B * Hq * Sq)
    delta = torch.empty(n, dtype=torch.float32, device=q.device)
    lib = build.load("flash_attention_bwd", _BWD_SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, Hq, Hkv, hd, *strides,
        int(bool(causal)), q_offset, valid, _DTYPES.index(dt),
        BWD_ROUTES.index(route), int(vec), delta.numel(), stream)
    build.check(lib, rc, "flash_attention_bwd")
    count_launch("flash_attention_bwd", f"bwd_{route}")
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, dout, causal: bool = True, *,
                        q_offset: Optional[int] = None,
                        kv_valid_len: Optional[int] = None,
                        arm: ArmLike = None):
    """``(dq, dk, dv)`` on the arm of the tensors' device: the CUDA kernel
    for CUDA tensors, the plain backward for CPU tensors (and the meta
    version for meta ones)."""
    fn = {KernelArm.CUDA: flash_attention_bwd_cuda,
          KernelArm.META: flash_attention_bwd_meta}.get(
        resolve_arm(q.device, arm), flash_attention_bwd_ref)
    return fn(q, k, v, o, lse, dout, causal, q_offset=q_offset,
              kv_valid_len=kv_valid_len)


# the forward of each arm that is not the plain version
_FORWARD = {KernelArm.CUDA: flash_attention_cuda,
            KernelArm.META: flash_attention_meta}


class _Attention(torch.autograd.Function):
    """Attention with a gradient: the forward of the tensors' arm, saving
    its row log-sum-exp, and :func:`flash_attention_bwd` of the same arm."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_valid_len):
        fwd = _FORWARD.get(resolve_arm(q.device), flash_attention_ref)
        out, lse = fwd(q, k, v, causal, q_offset=q_offset,
                       kv_valid_len=kv_valid_len, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = (causal, q_offset, kv_valid_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, kv_valid_len = ctx.window
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, causal,
                                         q_offset=q_offset,
                                         kv_valid_len=kv_valid_len)
        return dq, dk, dv, None, None, None


def attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_valid_len: int, arm: ArmLike = None):
    """One slot's share of attention over a cache cut along its keys
    (``flash_decode``): non-causal attention of q over the first
    ``kv_valid_len`` keys of k and v, as ``(out float32, lse)``, on the
    arm of the tensors' device (on the card the split-K route for a bf16
    q, whose merge writes the unrounded output, and ``scalar`` for a
    float32 one). A slot that sees no key gives zeros and an lse of -inf.
    Merging the slots' partials by their lse gives the attention over the
    whole cache."""
    fwd = _FORWARD.get(resolve_arm(q.device, arm), flash_attention_ref)
    return fwd(q, k, v, False, q_offset=0, kv_valid_len=kv_valid_len,
               return_lse=True, out_dtype=torch.float32)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, *, q_offset: Optional[int] = None,
                  kv_valid_len: Optional[int] = None,
                  arm: ArmLike = None) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd), Hq % Hkv == 0.

    Returns (B, Sq, Hq, hd) in q's type, on the arm of the tensors'
    device: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Where grad mode is on and q, k or v needs a gradient, through
    the ``torch.autograd.Function`` whose backward is
    :func:`flash_attention_bwd` on the same arm.
    """
    chosen = resolve_arm(q.device, arm)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, causal, q_offset, kv_valid_len)
    return _FORWARD.get(chosen, flash_attention_ref)(
        q, k, v, causal, q_offset=q_offset, kv_valid_len=kv_valid_len)
