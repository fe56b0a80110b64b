"""The port's attention against the JAX package's, on the CPU.

The same numpy inputs go through JAX ``gqa_attention`` (its ``jnp``
reference and the Pallas kernel in interpret mode) and through the port's
``gqa_attention``, whose CPU tensors take the plain arm. Tolerances are the
JAX kernel tests' (``tests/test_kernels.py``): 3e-5 absolute / 1e-4
relative in float32, 3e-2 in bf16. The ``q_offset`` / ``kv_valid_len``
widening is held against the JAX package's ``chunked_attention``, which
takes both. The CUDA kernel itself is tested on the card
(``tests/test_torch_cuda.py``).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.models.transformer import chunked_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402

F32_TOL = dict(atol=3e-5, rtol=1e-4)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)

# the shapes of tests/test_kernels.py::TestFlashAttention::test_sweep
SHAPES = [(1, 16, 16, 2, 1, 8, True), (2, 64, 64, 4, 2, 32, True),
          (2, 64, 64, 4, 4, 32, False), (1, 1, 128, 8, 2, 16, True),
          (3, 33, 65, 6, 3, 24, True)]


def _qkv(seed, B, Sq, Skv, Hq, Hkv, hd):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal(s).astype(np.float32)
                 for s in ((B, Sq, Hq, hd), (B, Skv, Hkv, hd),
                           (B, Skv, Hkv, hd)))


@pytest.mark.parametrize("backend", ["jnp", "interpret"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_arm_matches_jax(shape, backend):
    *dims, causal = shape
    q, k, v = _qkv(1, *dims)
    want = jops.gqa_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                              backend=backend)
    got = ops.gqa_attention(*map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("backend", ["jnp", "interpret"])
def test_plain_arm_matches_jax_in_bf16(backend):
    q, k, v = _qkv(2, 2, 32, 32, 4, 2, 16)
    want = jops.gqa_attention(*(jnp.asarray(x, jnp.bfloat16)
                                for x in (q, k, v)), backend=backend)
    got = ops.gqa_attention(*(torch.from_numpy(x).bfloat16()
                              for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


# (B, Sq, Skv, Hq, Hkv, hd, causal, q_offset, kv_valid_len): a decode row
# in a half-filled cache, a prefix chunk, the default alignment, and a
# non-causal read of a cache prefix
WINDOWS = [(2, 1, 64, 8, 2, 16, True, 20, 21),
           (2, 3, 40, 8, 2, 16, True, 10, 13),
           (2, 5, 32, 6, 3, 24, True, 27, 32),
           (1, 7, 48, 5, 1, 12, False, 0, 30)]


@pytest.mark.parametrize("case", WINDOWS, ids=str)
def test_offset_and_valid_len_match_chunked_attention(case):
    *dims, causal, q_offset, valid = case
    q, k, v = _qkv(3, *dims)
    want = chunked_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                             q_offset=q_offset, chunk=16, kv_valid_len=valid)
    got = ops.gqa_attention(*map(torch.from_numpy, (q, k, v)), causal,
                            q_offset=q_offset, kv_valid_len=valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_keys_past_valid_len_are_never_read():
    q, k, v = map(torch.from_numpy, _qkv(4, 2, 1, 32, 4, 2, 8))
    k2, v2 = k.clone(), v.clone()
    k2[:, 9:], v2[:, 9:] = float("nan"), float("nan")
    a = ops.gqa_attention(q, k, v, q_offset=8, kv_valid_len=9)
    b = ops.gqa_attention(q, k2, v2, q_offset=8, kv_valid_len=9)
    c = ops.gqa_attention(q, k[:, :9], v[:, :9])
    assert torch.equal(a, b) and torch.allclose(a, c, **F32_TOL)


def test_a_row_that_sees_no_key_gives_zeros():
    q, k, v = map(torch.from_numpy, _qkv(5, 1, 4, 8, 2, 1, 8))
    assert not ops.gqa_attention(q, k, v, kv_valid_len=0).any()
    out = ops.gqa_attention(q, k, v, q_offset=-2)
    assert not out[:, :2].any() and out[:, 2:].abs().sum() > 0


def test_arm_errors():
    q, k, v = map(torch.from_numpy, _qkv(6, 1, 4, 4, 2, 1, 8))
    with pytest.raises(ValueError, match="cannot run on a cpu tensor"):
        ops.gqa_attention(q, k, v, arm="cuda")
    with pytest.raises(ValueError, match="valid arms: torch | cuda"):
        ops.gqa_attention(q, k, v, arm="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention_cuda(q, k, v)
    assert torch.equal(ops.gqa_attention(q, k, v, arm="torch"),
                       ops.flash_attention_ref(q, k, v))


def test_shape_errors():
    q, k, v = map(torch.from_numpy, _qkv(7, 1, 4, 4, 3, 2, 8))
    with pytest.raises(ValueError, match="multiple"):
        ops.gqa_attention(q, k, v)
    with pytest.raises(ValueError, match="4-D"):
        ops.gqa_attention(q[0], k, v)
    with pytest.raises(ValueError, match="k and v"):
        ops.gqa_attention(q, k, v[..., :4])


def test_module_imports_without_nvcc():
    mod = importlib.reload(ops)
    assert mod.MAX_HEAD_DIM == 256
    from repro_torch.kernels import KERNELS, LAUNCHES, build
    assert "flash_attention" in build.SOURCES
    assert "flash_attention" in KERNELS and "flash_attention" in LAUNCHES
    assert (build.CSRC_DIR / "flash_attention.cu").exists()


# ----------------------------------------------------------------------
# the decode route's plain version and the wrapper's choice of kernel
# ----------------------------------------------------------------------

# (B, Sq, Skv, Hq, Hkv, hd, causal, q_offset, kv_valid_len): a decode row
# whose cache tail holds chunks entirely past kv_valid_len, decode rows of
# granite-8b's and qwen2.5-14b's groups (G 4 and 5), rows that see no key
# (q_offset < 0), an empty cache, and non-causal reads
SPLITK_CASES = [(2, 1, 200, 8, 2, 16, True, 20, 21),
                (1, 1, 96, 8, 2, 24, True, 70, 71),
                (2, 1, 64, 10, 2, 8, True, 40, 41),
                (1, 4, 40, 4, 1, 8, True, -2, 40),
                (1, 3, 16, 4, 2, 8, True, 5, 0),
                (2, 3, 50, 6, 3, 12, False, None, 37),
                (2, 5, 32, 6, 3, 24, True, 27, 32)]


@pytest.mark.parametrize("chunk", [1, 7, 64, 1000])
@pytest.mark.parametrize("case", SPLITK_CASES, ids=str)
def test_splitk_plain_version_matches_plain_and_chunked_attention(case,
                                                                  chunk):
    *dims, causal, q_offset, valid = case
    q, k, v = map(torch.from_numpy, _qkv(8, *dims))
    k[:, max(valid, 0):] = float("nan")       # the tail is never read
    v[:, max(valid, 0):] = float("nan")
    got = ops.flash_attention_splitk_ref(q, k, v, causal, q_offset=q_offset,
                                         kv_valid_len=valid, chunk=chunk)
    want = ops.flash_attention_ref(q, k, v, causal, q_offset=q_offset,
                                   kv_valid_len=valid)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **F32_TOL)
    # the JAX package's chunked_attention, on the rows that see a key (it
    # does not give zeros where a row sees none)
    Sq, Skv = q.shape[1], k.shape[1]
    qo = Skv - Sq if q_offset is None else q_offset
    sees = np.array([min(valid, qo + i + 1) > 0 if causal else valid > 0
                     for i in range(Sq)])
    assert not got[:, ~sees].any()
    if sees.any():
        jax_want = chunked_attention(
            *(jnp.asarray(x[:, :valid].numpy()) if i else
              jnp.asarray(x.numpy()) for i, x in enumerate((q, k, v))),
            causal=causal, q_offset=qo, chunk=16, kv_valid_len=valid)
        np.testing.assert_allclose(got.numpy()[:, sees],
                                   np.asarray(jax_want)[:, sees], **F32_TOL)


def test_splitk_plain_version_rows_that_see_no_key_give_zeros():
    q, k, v = map(torch.from_numpy, _qkv(9, 1, 4, 8, 2, 1, 8))
    out = ops.flash_attention_splitk_ref(q, k, v, q_offset=-2, chunk=3)
    assert not out[:, :2].any() and out[:, 2:].abs().sum() > 0
    assert not ops.flash_attention_splitk_ref(q, k, v, kv_valid_len=0,
                                              chunk=2).any()
    with pytest.raises(ValueError, match="chunk"):
        ops.flash_attention_splitk_ref(q, k, v, chunk=0)


@pytest.mark.parametrize("rows,hd,dtype,vec,route", [
    (1, 128, torch.bfloat16, True, "splitk"),     # decode, granite-8b G 4
    (4, 128, torch.bfloat16, True, "splitk"),
    (5, 128, torch.bfloat16, True, "splitk"),     # decode, qwen2.5-14b G 5
    (16, 12, torch.bfloat16, False, "splitk"),    # any hd, unaligned
    (17, 128, torch.bfloat16, True, "wgmma"),     # a prompt chunk
    (63, 128, torch.bfloat16, True, "wgmma"),
    (64, 128, torch.bfloat16, True, "wgmma"),
    (32, 96, torch.bfloat16, True, "mma"),
    (32, 128, torch.bfloat16, False, "mma"),
    (65, 64, torch.bfloat16, True, "wgmma"),      # Sq 13 at G 5
    (8192, 128, torch.bfloat16, True, "wgmma"),   # the prefill
    (8192, 128, torch.bfloat16, False, "mma"),    # unaligned strides
    (8192, 96, torch.bfloat16, True, "mma"),      # hd not 64 or 128
    (8192, 256, torch.bfloat16, True, "mma"),
    (4, 128, torch.float32, True, "scalar"),
    (8192, 128, torch.float32, True, "scalar"),
])
def test_attention_route_thresholds(rows, hd, dtype, vec, route):
    assert ops.attention_route(rows, hd, dtype, vec) == route


@pytest.mark.parametrize("B,Hkv,key_end,want", [
    (4, 8, 544, (128, 5)),       # granite-8b decode: a tile a warp, 160 blocks
    (4, 8, 300, (128, 3)),       # mid-cache: one round of the warps a chunk
    (1, 8, 32768, (1024, 32)),   # a long cache: 256 blocks
    (4, 8, 0, (128, 1)),         # an empty cache still writes its zeros
    (2, 2, 71, (128, 1)),
    (1, 1, 10 ** 6, (3840, 261)),
    (4, 16, 160, (128, 2)),      # moonshot's decode (G 1): 128 blocks
    (4, 8, 513, (128, 5)),       # one key past 16 tiles
    (4, 8, 32768, (4096, 8)),    # decode_32k's cache at batch 4
])
def test_splitk_chunks(B, Hkv, key_end, want):
    chunk, splits = ops.splitk_chunks(B, Hkv, key_end, sms=132)
    assert (chunk, splits) == want
    assert chunk % ops.SPLITK_ROUND == 0 and splits >= 1
    assert (splits - 1) * chunk < max(key_end, 1) <= splits * chunk
    # at most one wave of blocks (two an SM), unless one split a (kv-head,
    # batch) already exceeds it
    wave = ops.SPLITK_BLOCKS_PER_SM * 132
    assert B * Hkv * splits <= max(wave, B * Hkv)
    tiles = -(-key_end // ops.SPLITK_TILE)
    if tiles <= ops.SPLITK_WARPS * (wave // (B * Hkv)):
        # a short cache: every warp has at most one tile
        assert chunk == ops.SPLITK_ROUND
    else:
        # a long one fills the wave to within a round of each split
        assert B * Hkv * splits >= 0.9 * wave


@pytest.mark.parametrize("hd,kv_bytes,stages", [
    (16, 1, 4), (16, 2, 4), (24, 1, 4), (64, 1, 4), (64, 2, 3),
    (96, 1, 3), (128, 1, 3), (128, 2, 3), (256, 1, 3), (256, 2, 1)])
def test_splitk_stages_fit_the_card(hd, kv_bytes, stages):
    """The decode kernel's ring stages (csrc SplitGeom): a block's rings and
    Q fit its 227 KB; float8 hd 128 (granite-8b, moonshot) keeps two
    blocks an SM (96 KB of rings each)."""
    assert ops.splitk_stages(hd, kv_bytes) == stages
    hdp = next(p for p in (16, 32, 64, 128, 256) if hd <= p)
    ring = ops.SPLITK_WARPS * stages * 2 * ops.SPLITK_TILE * hdp * kv_bytes
    assert ring + 16 * (hdp + 8) * 2 <= 227 * 1024
    if (hd, kv_bytes) == (128, 1):
        assert ring <= 96 * 1024
    # a chunk of one round of the warps' tiles: one stage
    assert ops.splitk_stages(hd, kv_bytes, ops.SPLITK_ROUND) == 1
    assert ops.splitk_stages(hd, kv_bytes, 2 * ops.SPLITK_ROUND) == stages


def _bf16_qkv(B, Sq, Skv, Hq, Hkv, hd):
    return tuple(torch.from_numpy(x).bfloat16()
                 for x in _qkv(10, B, Sq, Skv, Hq, Hkv, hd))


def test_attention_plan_follows_shape_and_layout():
    # granite-8b decode and prefill, qwen2.5-14b (G 5) decode
    q, k, v = _bf16_qkv(4, 1, 544, 32, 8, 128)
    assert ops.attention_plan(q, k, v, q_offset=543, kv_valid_len=544) \
        == ("splitk", 128, 5)
    assert ops.attention_plan(q, k, v, q_offset=299, kv_valid_len=300) \
        == ("splitk", 128, 3)
    q, k, v = _bf16_qkv(1, 1, 40, 40, 8, 128)
    assert ops.attention_plan(q, k, v)[0] == "splitk"
    q, k, v = _bf16_qkv(1, 13, 40, 40, 8, 128)        # 65 rows at G 5
    assert ops.attention_plan(q, k, v) == ("wgmma", 0, 0)
    q, k, v = _bf16_qkv(2, 64, 64, 32, 8, 128)
    assert ops.attention_plan(q, k, v) == ("wgmma", 0, 0)
    # a causal split-K cuts only up to the last key a row sees
    q, k, v = _bf16_qkv(1, 2, 500, 8, 2, 64)
    assert ops.attention_plan(q, k, v, q_offset=100)[1:] == (128, 1)
    assert ops.attention_plan(q, k, v, False, q_offset=100)[1:] == (128, 4)
    # unaligned: a head stride of 12 values, a pointer 2 bytes in
    q, k, v = _bf16_qkv(2, 64, 64, 32, 8, 128)
    wide = torch.zeros((2, 64, 8, 140), dtype=torch.bfloat16)[..., :128]
    assert ops.attention_plan(q, wide, wide)[0] == "mma"
    shifted = torch.zeros(k.numel() + 1, dtype=torch.bfloat16)[1:] \
        .view(k.shape)
    assert ops.attention_plan(q, shifted, v)[0] == "mma"
    assert ops.attention_plan(q.float(), k.float(), v.float())[0] \
        == "scalar"


def test_route_counters_are_registered():
    from repro_torch.kernels import LAUNCHES, ROUTE_COUNTS, reset_launches
    assert {r for r in ROUTE_COUNTS if r.startswith("attn_")} \
        == {f"attn_{route}" for route in ops.ROUTES}
    assert "ell_gather_f1" in ROUTE_COUNTS
    assert set(ROUTE_COUNTS) <= set(LAUNCHES)
    LAUNCHES["attn_wgmma"] += 3
    reset_launches()
    assert not any(LAUNCHES.values())


# ---------------------------------------------------------------------
# the gradient: flash_attention_bwd_ref and the autograd Function
# ---------------------------------------------------------------------

# (B, Sq, Skv, Hq, Hkv, hd, causal, q_offset, kv_valid_len)
BWD_CASES = [(2, 12, 12, 4, 2, 16, True, None, None),
             (1, 9, 9, 6, 2, 12, True, 0, None),
             (2, 5, 11, 4, 4, 8, True, 3, 9),
             (1, 7, 10, 8, 2, 16, False, None, 8),
             (1, 6, 6, 2, 1, 8, True, -2, None)]      # rows that see no key


def _grad_inputs(seed, B, Sq, Skv, Hq, Hkv, hd):
    q, k, v = _qkv(seed, B, Sq, Skv, Hq, Hkv, hd)
    dout = np.random.default_rng(seed + 1).standard_normal(
        (B, Sq, Hq, hd)).astype(np.float32)
    return q, k, v, dout


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_bwd_ref_matches_autograd_through_the_plain_forward(case):
    """The formulas against torch.autograd of flash_attention_ref, in
    float32 at 1e-5: GQA sums, the causal window, q_offset, keys past
    kv_valid_len (gradient 0) and rows that see no key."""
    *dims, causal, q_offset, valid = case
    q, k, v, dout = map(torch.from_numpy, _grad_inputs(3, *dims))
    kw = dict(q_offset=q_offset, kv_valid_len=valid)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention_ref(*leaves, causal, **kw)
    want = torch.autograd.grad(out, leaves, dout)
    o, lse = ops.flash_attention_ref(q, k, v, causal, return_lse=True, **kw)
    torch.testing.assert_close(o, out.detach(), atol=0, rtol=0)
    assert lse.shape == (dims[0], dims[3], dims[1]) and \
        lse.dtype == torch.float32
    got = ops.flash_attention_bwd_ref(q, k, v, o, lse, dout, causal, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    if valid is not None:
        assert not got[1][:, valid:].any() and not got[2][:, valid:].any()
    # the Function: the same gradients, and the same forward
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out2 = ops.gqa_attention(*leaves, causal, **kw)
    torch.testing.assert_close(out2.detach(), out.detach(), atol=0, rtol=0)
    for g, w in zip(torch.autograd.grad(out2, leaves, dout), got):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("case", [(2, 32, 32, 4, 2, 16), (1, 24, 24, 6, 2, 8),
                                  (2, 16, 16, 4, 4, 32)], ids=str)
def test_bwd_ref_matches_jax_vjp_of_chunked_attention(case):
    """The JAX package trains through chunked_attention (causal,
    q_offset 0): its jax.vjp is the reference, at 1e-5 in float32; the
    forward's lse equals its m + log l."""
    q, k, v, dout = _grad_inputs(7, *case)
    B, Sq, Skv, Hq, Hkv, hd = case

    def f(q_, k_, v_):
        return chunked_attention(q_, k_, v_, causal=True, q_offset=0,
                                 chunk=8)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    acc, m, l = chunked_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                  q_offset=0, chunk=8, return_stats=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = ops.flash_attention_ref(tq, tk, tv, True, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(m + jnp.log(l)),
                               atol=1e-5, rtol=1e-5)
    got = ops.flash_attention_bwd(tq, tk, tv, o, lse, torch.from_numpy(dout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_bwd_in_bf16_keeps_types_and_tracks_float32():
    q, k, v, dout = (torch.from_numpy(x) for x in
                     _grad_inputs(9, 2, 16, 16, 4, 2, 16))
    o, lse = ops.flash_attention_ref(q, k, v, True, return_lse=True)
    want = ops.flash_attention_bwd_ref(q, k, v, o, lse, dout)
    bf = [x.bfloat16() for x in (q, k, v)]
    ob, lseb = ops.flash_attention_ref(*bf, True, return_lse=True)
    got = ops.flash_attention_bwd_ref(*bf, ob, lseb, dout.bfloat16())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        rel = float((g.float() - w).norm() / w.norm())
        assert rel < 3e-2, rel


def test_gradient_path_is_taken_only_where_a_gradient_is_needed():
    q, k, v, dout = (torch.from_numpy(x) for x in
                     _grad_inputs(4, 1, 8, 8, 4, 2, 8))
    out = ops.gqa_attention(q, k, v)
    assert out.grad_fn is None
    kr = k.clone().requires_grad_()
    out = ops.gqa_attention(q, kr, v)
    assert type(out.grad_fn).__name__ == "_AttentionBackward"
    with torch.no_grad():
        assert ops.gqa_attention(q, kr, v).grad_fn is None
    (dk,) = torch.autograd.grad(out, [kr], dout)
    assert dk.shape == k.shape
    with pytest.raises(ValueError, match="cannot run"):
        ops.flash_attention_bwd(q, k, v, out.detach(), torch.zeros(1, 4, 8),
                                dout, arm="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention_bwd_cuda(q, k, v, out.detach(),
                                     torch.zeros(1, 4, 8), dout)


@pytest.mark.parametrize("group,hd,dtype,vec,route", [
    (4, 128, torch.bfloat16, False, "mma"),
    (4, 12, torch.bfloat16, True, "mma"),
    (1, 129, torch.bfloat16, True, "scalar"),
    (4, 256, torch.bfloat16, True, "scalar"),
    (4, 128, torch.float32, True, "scalar"),
    (1, 16, torch.float32, False, "scalar"),
    # the wgmma kernels: hd 64 or 128, aligned, whole positions a row tile
    (4, 128, torch.bfloat16, True, "wgmma"),
    (1, 64, torch.bfloat16, True, "wgmma"),
    (5, 128, torch.bfloat16, True, "wgmma"),
    (64, 64, torch.bfloat16, True, "wgmma"),
    (4, 96, torch.bfloat16, True, "mma"),       # another head dim
    (1, 64, torch.bfloat16, False, "mma"),      # unaligned input
    (65, 128, torch.bfloat16, True, "mma")])    # no whole position a tile
def test_bwd_route_by_type_and_head_dim(group, hd, dtype, vec, route):
    from repro_torch.kernels import LAUNCHES
    assert ops.bwd_route(group, hd, dtype, vec) == route
    assert f"bwd_{route}" in LAUNCHES and route in ops.BWD_ROUTES


@pytest.mark.parametrize("offset,route", [(0, "wgmma"), (1, "mma")])
def test_bwd_plan_reads_alignment_from_the_tensors(offset, route):
    """A q whose rows start one value into their buffer (2 bytes: no
    16-byte loads, no TMA) takes ``mma``; the aligned one ``wgmma``."""
    big = torch.zeros(2, 8, 4, 128 + 8, dtype=torch.bfloat16)
    q = big[..., offset:offset + 128]
    k = v = torch.zeros(2, 8, 1, 128, dtype=torch.bfloat16)
    o = dout = torch.zeros(2, 8, 4, 128, dtype=torch.bfloat16)
    assert ops.bwd_plan(q, k, v, o, dout) == route
    assert ops.bwd_plan(q.float(), k.float(), v.float(), o.float(),
                        dout.float()) == "scalar"


@pytest.mark.parametrize("Sq,group,want", [
    (4096, 4, (16, 256)), (4096, 1, (64, 64)), (33, 5, (12, 3)),
    (130, 1, (64, 3)), (5, 64, (1, 5)), (1, 3, (21, 1))])
def test_bwd_row_tiles_hold_whole_positions(Sq, group, want):
    P, tiles = ops.bwd_row_tiles(Sq, group)
    assert (P, tiles) == want
    assert P * group <= ops.BWD_TILE_ROWS < (P + 1) * group
    assert (tiles - 1) * P < Sq <= tiles * P
