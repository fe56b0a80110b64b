"""The float8 KV cache (``RunOptions(kv_cache_dtype="f8")``) against the
JAX package's, on the CPU, and its decode kernel on the card.

* ``quantize_f8`` against JAX ``astype(float8_e4m3fn)``: every one of the
  65,536 bf16 bit patterns and float32 values around 448, 464 and 480
  (the largest finite value, the tie that rounds to it, the NaN pattern's
  value) and the subnormals, bit for bit with NaN compared as a class
  (torch's own cast saturates where JAX gives NaN);
* the plain attention over float8 keys and values against the JAX
  ``chunked_attention`` over the same bytes (one chunk: the JAX function
  rounds p against each chunk's running max), float32 q at 1e-4 (q.k is
  scaled before the product in JAX, after it here: p's bf16 rounding can
  move by one step), bf16 q at 2e-2 (JAX rounds ``q / sqrt(hd)`` to bf16
  first, about 2**-9 of each q value);
* ``decode_step`` at ``REDUCED`` granite-8b (GQA) and moonshot-v1-16b-a3b
  (MoE) into a float8 cache against the JAX ``decode_step`` (``"jnp"``
  arm) on ``init_cache(dtype=float8_e4m3fn)``: the cache bytes equal, the
  logits within ``test_torch_transformer.py``'s decode tolerance (1e-4);
* the meta arm's byte count (keys and values at one byte) and the routes;
* ``flash_attention_splitk_ref`` cut at the decode kernel's plan over
  float8 caches with NaN tails, against the JAX ``chunked_attention``
  (valid lengths around the kernel's tile and its warps' round, G 1, 4
  and 5, hd 64 to 256);
* on the card (marked ``gpu``, skipped here with the reason): the
  ``attn_splitk_f8`` route against its plain version at the bf16
  tolerance of ``tests/test_torch_cuda.py``, and a float32 q's scalar
  route, which rounds p to bf16 as the plain version does, held closer
  to it than the unrounded function is; and ``attn_splitk_f8`` equal bit
  for bit to ``attn_splitk`` on the cache's dequantised bf16 copy.

JAX is imported inside the CPU tests, so the card's test runs where JAX
is not installed.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tcr  # noqa: E402
from repro_torch.config import RunOptions  # noqa: E402
from repro_torch.kernels import LAUNCHES, build, registry  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

F8 = torch.float8_e4m3fn
DECODE_TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 12


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _nan_as_class(got: np.ndarray, want: np.ndarray) -> None:
    """uint8 codes equal, except that any NaN (0x7f / 0xff) equals any."""
    gnan, wnan = (got & 0x7F) == 0x7F, (want & 0x7F) == 0x7F
    np.testing.assert_array_equal(gnan, wnan)
    np.testing.assert_array_equal(got[~wnan], want[~wnan])


def test_quantize_f8_matches_jax_on_every_bf16_pattern():
    jax, jnp = _jax()
    bits = np.arange(1 << 16, dtype=np.uint16)
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    got = tt.quantize_f8(x)
    assert got.dtype == F8 and got.shape == x.shape
    want = np.asarray(jnp.asarray(bits).view(jnp.bfloat16)
                      .astype(jnp.float8_e4m3fn)).view(np.uint8)
    _nan_as_class(got.view(torch.uint8).numpy(), want)
    # torch's own cast saturates: the reason for the quantiser
    big = torch.tensor([480.0, float("inf")], dtype=torch.bfloat16)
    assert big.to(F8).view(torch.uint8).tolist() == [0x7E, 0x7E]
    assert torch.isnan(tt.quantize_f8(big).float()).all()


def _float32_edges() -> np.ndarray:
    """float32 values at and one ulp around 448, 464 and 480, the ties
    between neighbouring e4m3 values near them, the smallest normal
    (2**-6), the subnormals' step (2**-9) and its ties, inf and NaN, both
    signs; and 100,000 seeded values over magnitudes 1e-4..600."""
    f = np.float32
    centres = [448, 456, 464, 472, 480, 416, 432, 2.0 ** -6, 2.0 ** -7,
               2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -10, 5 * 2.0 ** -10,
               2.0 ** -6 - 2.0 ** -10, 1.0625, 1.1875]
    vals = []
    for c in centres:
        c = f(c)
        vals += [np.nextafter(c, f(-np.inf)), c, np.nextafter(c, f(np.inf))]
    vals += [np.inf, np.nan, 1e30, 0.0, 1e-30]
    r = np.random.default_rng(0)
    mag = 10.0 ** r.uniform(-4, np.log10(600), 100_000)
    out = np.concatenate([np.array(vals, np.float32),
                          (mag * r.choice([-1, 1], mag.size))
                          .astype(np.float32)])
    return np.concatenate([out, -out])


def test_quantize_f8_matches_jax_on_float32_edges_and_ties():
    jax, jnp = _jax()
    f = _float32_edges()
    got = tt.quantize_f8(torch.from_numpy(f)).view(torch.uint8).numpy()
    want = np.asarray(jnp.asarray(f).astype(jnp.float8_e4m3fn)) \
        .view(np.uint8)
    _nan_as_class(got, want)
    # the boundaries, by value: 464 rounds (tie, to even) to 448, above
    # it NaN; the smallest subnormal's half rounds to 0
    at = {448.0: 448.0, 464.0: 448.0, 2.0 ** -10: 0.0}
    for x, y in at.items():
        assert float(tt.quantize_f8(torch.tensor([x])).float()) == y
    assert torch.isnan(tt.quantize_f8(
        torch.tensor([np.nextafter(np.float32(464), np.float32(500))]))
        .float()).all()


def _f8_qkv(seed, dims, q_dtype):
    """q (numpy float32 rounded to q's type) and k, v as float8 bytes,
    quantised by JAX: the same bits go to both packages."""
    _, jnp = _jax()
    Bq, Sq, Skv, Hq, Hkv, hd = dims
    r = np.random.default_rng(seed)
    q = r.standard_normal((Bq, Sq, Hq, hd)).astype(np.float32)
    kv = [np.asarray(jnp.asarray(3 * r.standard_normal(
        (Bq, Skv, Hkv, hd)).astype(np.float32)).astype(jnp.float8_e4m3fn))
        for _ in range(2)]
    jq = jnp.asarray(q, q_dtype)
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32)))
    if q_dtype == "bfloat16":
        tq = tq.bfloat16()
    tk, tv = (torch.from_numpy(x.view(np.uint8).copy()).view(F8)
              for x in kv)
    return (jq, *map(jnp.asarray, kv)), (tq, tk, tv)


# (B, Sq, Skv, Hq, Hkv, hd, q_offset, kv_valid_len): decode rows of a
# granite-like GQA group, a one-head group with the cache's tail unread,
# prompt chunks of 3 and 2 queries (a row that sees no key is left out:
# JAX averages V over the masked keys there, the port gives zeros)
F8_CASES = [(2, 1, 16, 8, 2, 16, 15, 16), (1, 1, 40, 4, 4, 32, 22, 23),
            (2, 3, 24, 6, 3, 8, 10, 13), (1, 2, 8, 4, 2, 16, 0, 8)]


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", F8_CASES, ids=str)
def test_plain_f8_attention_matches_jax_chunked_attention(case, q_dtype):
    from repro.models.transformer import chunked_attention
    *dims, q_offset, valid = case
    (jq, jk, jv), (tq, tk, tv) = _f8_qkv(4, dims, q_dtype)
    want = chunked_attention(jq, jk, jv, causal=True, q_offset=q_offset,
                             kv_valid_len=valid, chunk=dims[2])
    got = ops.gqa_attention(tq, tk, tv, True, q_offset=q_offset,
                            kv_valid_len=valid)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = DECODE_TOL if q_dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(np.float32)), **tol)


def test_plain_f8_attention_rounds_p_to_bf16():
    """Over float8 keys and values p is rounded to bf16 before the PV
    product (the JAX arm's ``p.astype(vq.dtype)``); over the same values
    in float32 it is not, so the two differ, by less than bf16's step."""
    (_, _, _), (tq, tk, tv) = _f8_qkv(5, (1, 1, 64, 4, 1, 32), "float32")
    f8 = ops.flash_attention_ref(tq, tk, tv)
    f32 = ops.flash_attention_ref(tq, tk.float(), tv.float())
    assert not torch.equal(f8, f32)
    torch.testing.assert_close(f8, f32, atol=2e-2, rtol=2e-2)
    # an empty cache (no valid key): zeros, as over any other cache
    empty = ops.flash_attention_ref(tq, tk, tv, q_offset=0, kv_valid_len=0)
    assert empty.shape == tq.shape and not empty.any()


# (B, Hq, Hkv, hd, Skv, kv_valid_len): one decode query over a float8
# cache whose keys past kv_valid_len are NaN. kv_valid_len at 1, one key
# before, at and past the decode kernel's 32-key tile, at and past a round
# of its four warps' tiles (128 keys, a chunk's step), at and past the
# reach of a warp's ring at hd 128 (3 stages x 4 warps x 32 keys); G 1, 4
# and 5; hd 64, 96, 128 and 256
SPLITK_F8_CASES = [(2, 8, 2, 64, 40, 1), (1, 16, 16, 128, 48, 31),
                   (1, 10, 2, 96, 48, 32), (2, 4, 1, 256, 48, 33),
                   (1, 10, 2, 128, 160, 128), (1, 16, 16, 64, 160, 129),
                   (1, 8, 2, 128, 400, 384), (1, 5, 1, 256, 420, 385)]


@pytest.mark.parametrize("geometry", ["plan", "plan_4_sms", "tile"])
@pytest.mark.parametrize("case", SPLITK_F8_CASES, ids=str)
def test_splitk_plain_version_at_the_plan_matches_jax_on_f8(case, geometry):
    """``flash_attention_splitk_ref`` cut as the decode kernel cuts the
    keys (its plan on the H100, the plan on a 4-SM card, where short
    caches split too, and the kernel's 32-key tile, the finest partial it
    merges), over float8 keys and values with a NaN tail, against the JAX
    ``chunked_attention`` over the float32 values of the same bytes up to
    the valid length at ``DECODE_TOL`` (neither rounds p), and over the
    float8 bytes themselves at 2e-2 (JAX rounds p to bf16 there, about
    2**-9 of each p)."""
    _, jnp = _jax()
    from repro.models.transformer import chunked_attention
    Bq, Hq, Hkv, hd, Skv, valid = case
    (jq, jk, jv), (tq, tk, tv) = _f8_qkv(6, (Bq, 1, Skv, Hq, Hkv, hd),
                                         "float32")
    for x in (tk, tv):
        x.view(torch.uint8)[:, valid:] = 0x7F          # e4m3 NaN
    if geometry == "tile":
        chunk = ops.SPLITK_TILE
    else:
        sms = 132 if geometry == "plan" else 4
        chunk, splits = ops.splitk_chunks(Bq, Hkv, valid, sms=sms)
        assert (splits - 1) * chunk < valid <= splits * chunk
    kw = dict(causal=True, q_offset=valid - 1, kv_valid_len=valid)
    got = ops.flash_attention_splitk_ref(tq, tk, tv, chunk=chunk, **kw)
    assert torch.isfinite(got).all()
    k32, v32 = (x[:, :valid].astype(jnp.float32) for x in (jk, jv))
    want = chunked_attention(jq, k32, v32, chunk=chunk, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DECODE_TOL)
    want8 = chunked_attention(jq, jk[:, :valid], jv[:, :valid], chunk=chunk,
                              **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want8), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("arch", ["granite-8b", "moonshot-v1-16b-a3b"])
def test_decode_step_into_an_f8_cache_matches_jax(arch):
    """Six steps into a float8 cache of 16 (one attention chunk in JAX):
    the cache's bytes equal after each step, the logits at 1e-4."""
    jax, jnp = _jax()
    from repro import configs as jcr
    from repro.config import RunOptions as JaxRunOptions
    from repro.models import transformer as jt
    cfg = jcr.get(arch).REDUCED
    tree = jax.tree.map(np.asarray,
                        jt.init_lm_params(jax.random.PRNGKey(0), cfg, tp=1))
    opts = RunOptions(kv_cache_dtype="f8")
    model = tt.params_from_jax(tree, tcr.get(arch).REDUCED, device="cpu",
                               opts=opts)
    jopts = JaxRunOptions(kernel_backend="jnp", attn_chunk=16,
                          seq_parallel=False, kv_cache_dtype="f8")
    params = jax.tree.map(jnp.asarray, tree)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    jc = jt.init_cache(cfg, B, 16, jnp.float8_e4m3fn)
    tc = model.init_cache(B, 16)
    assert tc["k"].dtype == tc["v"].dtype == F8
    assert tc["k"].shape == jc["k"].shape
    for i in range(6):
        want, jc = jt.decode_step(params, jnp.asarray(toks[:, i:i + 1]), jc,
                                  cfg, jopts, lambda x, axes: x)
        got, tc = model.decode_step(toks[:, i:i + 1], tc)
        for name in ("k", "v"):
            np.testing.assert_array_equal(
                tc[name].view(torch.uint8).numpy(),
                np.asarray(jc[name]).view(np.uint8))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **DECODE_TOL)
    assert tc["pos"] == 6


def test_f8_cache_types_and_refusals():
    cfg = tcr.get("granite-8b").REDUCED
    gen = torch.Generator().manual_seed(0)
    model = tt.LM(cfg, generator=gen, device="cpu",
                  opts=RunOptions(kv_cache_dtype="f8"))
    cache = model.init_cache(2, 8)
    assert cache["k"].dtype == F8 and cache["k"].element_size() == 1
    assert tt.init_cache(cfg, 2, 8, device="cpu")["k"].dtype == torch.float32
    assert tt.init_cache(cfg, 2, 8, dtype=F8, device="cpu")["v"].dtype == F8
    logits, cache = model.decode_step([[1], [2]], cache)
    assert torch.isfinite(logits).all() and cache["pos"] == 1
    assert cache["k"][:, :, 0].float().abs().sum() > 0
    mixed = {"k": cache["k"], "v": cache["v"].float(), "pos": 1}
    with pytest.raises(ValueError, match="differs"):
        model.decode_step([[1], [2]], mixed)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tt.LM(cfg, generator=gen, device="cpu",
              opts=RunOptions(kv_cache_dtype="fp8"))


def test_f8_routes_and_plans():
    """A bf16 q's decode rows take splitk_f8 over a float8 cache; more
    rows, and a float32 q, take the route of the keys and values copied
    to q's type."""
    q = torch.zeros((4, 1, 32, 128), dtype=torch.bfloat16)
    cache = torch.zeros((2, 4, 544, 8, 128), dtype=F8)
    k, v = cache[1], cache[0]
    assert ops.attention_plan(q, k, v, q_offset=543, kv_valid_len=544) \
        == ("splitk_f8", 128, 5)
    assert ops.attention_plan(q, k.bfloat16(), v.bfloat16(), q_offset=543,
                              kv_valid_len=544) == ("splitk", 128, 5)
    chunk = torch.zeros((4, 8, 32, 128), dtype=torch.bfloat16)
    assert ops.attention_plan(chunk, k, v, q_offset=292,
                              kv_valid_len=300)[0] == "wgmma"
    assert ops.attention_plan(q.float(), k, v)[0] == "scalar"
    assert ops.attention_route(16, 128, torch.bfloat16, True, True) \
        == "splitk_f8"
    assert ops.attention_route(17, 96, torch.bfloat16, True, True) == "mma"
    assert "splitk_f8" in ops.ROUTES
    assert "attn_splitk_f8" in registry.ROUTE_COUNTS
    # a float8 cache whose strides are not multiples of 16 values loads
    # by bytes
    odd = torch.zeros((4, 40, 8, 136), dtype=F8)[..., :128]
    assert ops._aligned(q, odd, odd) is False
    assert ops._aligned(q, k, v) is True


def test_meta_counts_f8_keys_and_values_at_one_byte():
    calls = []

    def listener(name, n_ops, nbytes):
        calls.append((name, n_ops, nbytes))
        return contextlib.nullcontext()

    meta = torch.device("meta")
    Bq, Skv, Hq, Hkv, hd, valid = 4, 544, 32, 8, 128, 300
    q = torch.empty((Bq, 1, Hq, hd), dtype=torch.bfloat16, device=meta)
    registry.add_meta_listener(listener)
    try:
        for dt in (F8, torch.bfloat16):
            kv = torch.empty((Bq, Skv, Hkv, hd), dtype=dt, device=meta)
            out = ops.gqa_attention(q, kv, kv, q_offset=valid - 1,
                                    kv_valid_len=valid)
            assert out.shape == q.shape and out.dtype == torch.bfloat16
    finally:
        registry.remove_meta_listener(listener)
    q_bytes = 2 * 2 * Bq * Hq * hd                   # q read, out written
    assert calls == [
        ("flash_attention", 4 * hd * valid * Bq * Hq,
         q_bytes + 1 * 2 * Bq * valid * Hkv * hd),
        ("flash_attention", 4 * hd * valid * Bq * Hq,
         q_bytes + 2 * 2 * Bq * valid * Hkv * hd)]


def test_dry_run_decode_cell_follows_kv_cache_dtype():
    """The decode bundle's cache follows ``kv_cache_dtype``: on ``meta``
    the float8 cell's arguments hold a one-byte cache and its attention
    reads one byte a key and value (``REDUCED`` granite-8b is float32:
    four bytes a value otherwise); ``kv_cache_bytes`` keeps the JAX meta's
    2 bytes a value either way."""
    from repro_torch.launch.dryrun import dryrun_cell
    rec = {kv: dryrun_cell("granite-8b", "decode_32k", "host",
                           RunOptions(kv_cache_dtype=kv), reduced=True)
           for kv in ("bf16", "f8")}
    cfg = tcr.get("granite-8b").REDUCED
    S, Bd = (dict(tcr.get("granite-8b").SHAPES["decode_32k"].dims)[k]
             for k in ("seq_len", "global_batch"))
    values = 2 * cfg.n_layers * Bd * S * cfg.n_kv_heads * cfg.hd
    args = {kv: r["memory"]["argument_bytes"] for kv, r in rec.items()}
    assert args["bf16"] - args["f8"] == (4 - 1) * values
    att = {kv: r["census"]["kernels"]["flash_attention"]
           for kv, r in rec.items()}
    assert att["bf16"]["ops"] == att["f8"]["ops"]
    assert att["bf16"]["bytes"] - att["f8"]["bytes"] == (4 - 1) * values
    assert rec["f8"]["meta"]["kv_cache_bytes"] == \
        rec["bf16"]["meta"]["kv_cache_bytes"] == 2 * values


# ---------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    build.build(["flash_attention"])
    return torch.device("cuda")


# (B, Sq, Skv, Hq, Hkv, hd, q_offset, kv_valid_len): granite-8b's decode,
# moonshot's (G 1), qwen2.5-14b's G 5, hd 24 (not a multiple of 16: byte
# loads), hd 256, a prompt chunk of 3 queries, an empty cache; the valid
# length at 1, one key before, at and past the kernel's 32-key tile, at
# and past a round of its four warps' tiles (128), at and past the reach
# of a warp's ring at hd 128 (3 stages x 4 warps x 32 = 384), and
# decode_32k's cache at batch 4
F8_CUDA_CASES = [(4, 1, 544, 32, 8, 128, 543, 544),
                 (4, 1, 160, 16, 16, 128, 120, 121),
                 (2, 1, 77, 40, 8, 128, 76, 77),
                 (2, 1, 300, 8, 2, 24, 250, 251),
                 (1, 1, 700, 8, 1, 256, 699, 700),
                 (2, 3, 300, 8, 2, 64, 100, 103),
                 (1, 1, 16, 4, 1, 64, 0, 0),
                 (2, 1, 64, 32, 8, 128, 0, 1),
                 (2, 1, 64, 32, 8, 128, 30, 31),
                 (2, 1, 64, 40, 8, 128, 31, 32),
                 (2, 1, 64, 16, 16, 128, 32, 33),
                 (1, 1, 200, 32, 8, 128, 127, 128),
                 (1, 1, 200, 40, 8, 96, 128, 129),
                 (1, 1, 400, 8, 2, 128, 383, 384),
                 (1, 1, 400, 8, 8, 128, 384, 385),
                 (4, 1, 32768, 32, 8, 128, 32767, 32768)]


# a float32 q over a float8 cache: the card's relative L2 error from the
# plain version, as a share of the error of not rounding p at all
F8_F32_SHARE = 0.3


@pytest.mark.gpu
@pytest.mark.parametrize("case", F8_CUDA_CASES, ids=str)
def test_splitk_f8_kernel_matches_plain(dev, case):
    """bf16 q over a float8 cache layer slice (the tail past the valid
    length NaN): one ``attn_splitk_f8`` launch, equal to the plain version
    at 1e-2 elementwise and 2e-2 relative L2 a row (p and the output
    rounded to bf16). A float32 q: one ``attn_scalar`` launch that rounds
    p as the plain version does."""
    Bq, Sq, Skv, Hq, Hkv, hd, q_offset, valid = case
    gen = torch.Generator(device=dev).manual_seed(Skv + hd)
    q = torch.randn((Bq, Sq, Hq, hd), generator=gen, device=dev) \
        .bfloat16()
    cache = tt.quantize_f8(3 * torch.randn((2, Bq, Skv, Hkv, hd),
                                           generator=gen, device=dev))
    cache[:, :, valid:] = tt.quantize_f8(
        torch.full((1,), float("nan"), device=dev))
    k, v = cache[1], cache[0]
    kw = dict(q_offset=q_offset, kv_valid_len=valid)
    plan = ops.attention_plan(q, k, v, True, **kw)
    assert plan[0] == "splitk_f8"
    before = {r: LAUNCHES[f"attn_{r}"] for r in ops.ROUTES}
    got = ops.gqa_attention(q, k, v, True, **kw)
    torch.cuda.synchronize()
    assert {r: LAUNCHES[f"attn_{r}"] - c for r, c in before.items()} \
        == {r: int(r == "splitk_f8") for r in ops.ROUTES}
    want = ops.flash_attention_ref(q, k, v, True, **kw).float()
    got = got.float()
    torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-2)
    rel = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    assert float(rel.max()) <= 2e-2, float(rel.max())
    # a float32 q takes the copy to float32 and the scalar route, which
    # rounds p to bf16 against each row's max as the plain version does;
    # where a score's last bit (summed in another order) moves p across a
    # bf16 boundary the two differ by a step of p, so the whole output's
    # relative L2 error is held to F8_F32_SHARE of the error that leaving
    # p unrounded makes (the plain version over float32 copies)
    q32 = q.float()
    before = LAUNCHES["attn_scalar"]
    got32 = ops.gqa_attention(q32, k, v, True, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["attn_scalar"] - before == 1
    want32 = ops.flash_attention_ref(q32, k, v, True, **kw)
    if valid == 0:
        assert not got32.any() and not want32.any()
        return
    torch.testing.assert_close(got32, want32, atol=1e-2, rtol=1e-2)
    unrounded = ops.flash_attention_ref(q32, k.float(), v.float(), True,
                                        **kw)
    err = float((got32 - want32).norm() / want32.norm())
    gap = float((unrounded - want32).norm() / want32.norm())
    assert err <= F8_F32_SHARE * gap, (err, gap)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [96, 128])
@pytest.mark.parametrize("G", [1, 4, 5])
def test_splitk_f8_equals_bf16_route_on_the_dequantised_copy(dev, G, hd):
    """The two instantiations of the decode kernel (float8 and bf16 K/V)
    build the same bf16 fragments and run the same MMAs in the same
    order: ``attn_splitk_f8`` over a float8 cache equals ``attn_splitk``
    over its bf16 copy bit for bit, at valid lengths that end inside a
    tile, on a tile, past a round of the warps, and after several chunks
    (the tail past the valid length NaN in the float8 cache)."""
    Bq, Hkv, Skv = 2, 4, 4200
    gen = torch.Generator(device=dev).manual_seed(G * 1000 + hd)
    q = torch.randn((Bq, 1, Hkv * G, hd), generator=gen, device=dev) \
        .bfloat16()
    cache = tt.quantize_f8(3 * torch.randn((2, Bq, Skv, Hkv, hd),
                                           generator=gen, device=dev))
    for valid in (5, 64, 129, 4097):
        c = cache.clone()
        c[:, :, valid:] = tt.quantize_f8(
            torch.full((1,), float("nan"), device=dev))
        k, v = c[1], c[0]
        kw = dict(q_offset=valid - 1, kv_valid_len=valid)
        before = {r: LAUNCHES[f"attn_{r}"] for r in ("splitk", "splitk_f8")}
        got = ops.gqa_attention(q, k, v, True, **kw)
        same = ops.gqa_attention(q, k.bfloat16(), v.bfloat16(), True, **kw)
        torch.cuda.synchronize()
        assert {r: LAUNCHES[f"attn_{r}"] - n for r, n in before.items()} \
            == {"splitk": 1, "splitk_f8": 1}
        assert torch.isfinite(got.float()).all()
        assert torch.equal(got.view(torch.int16), same.view(torch.int16)), \
            (valid, float((got.float() - same.float()).abs().max()))
