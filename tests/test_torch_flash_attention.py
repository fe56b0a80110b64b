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
