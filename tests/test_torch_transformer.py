"""The port's transformer serving path against the JAX package's, on the CPU.

granite-8b, qwen1.5-110b and qwen2.5-14b ``REDUCED`` (both qwen: QKV
bias; qwen1.5 hd 16, 2:1 heads; qwen2.5 hd 12, 5:1 heads), and the MoE
archs olmoe-1b-7b and moonshot-v1-16b-a3b ``REDUCED`` (8 experts top-2,
the dispatch grouped by ``moe_groups`` 16 in both packages). The JAX
parameter tree (``init_lm_params``, seed 0) is carried into the port with
``params_from_jax``; the same numpy tokens go through both.
``lm_forward`` and ``prefill`` are held against both JAX attention arms
(``jnp`` and the Pallas kernel in interpret mode), ``decode_step`` against
the ``jnp`` arm only: the JAX package's Pallas arm drops ``q_offset`` and
``kv_valid_len`` at decode (``transformer._attention``) and attends over
the unwritten cache tail. Tolerance: 1e-4 absolute and relative, in
float32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcr  # noqa: E402
from repro.config import RunOptions as JaxRunOptions  # noqa: E402
from repro.data.lm_data import TokenStream as JaxTokenStream  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs as tcr  # noqa: E402
from repro_torch.config import RunOptions  # noqa: E402
from repro_torch.data.lm_data import TokenStream  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCHS = ["granite-8b", "qwen1.5-110b", "qwen2.5-14b", "olmoe-1b-7b",
         "moonshot-v1-16b-a3b"]
LM_ARCHS = ["granite-8b", "qwen1.5-110b", "qwen2.5-14b",
            "moonshot-v1-16b-a3b", "olmoe-1b-7b"]
TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 12


def ident(x, axes):
    return x


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These models are tiny: torch's thread pool only contends with the
    other test workers (a reduced train step takes 20 ms on one thread and
    1-2 s on eight of a loaded machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jopts(backend):
    return JaxRunOptions(kernel_backend=backend, attn_chunk=16,
                         seq_parallel=False)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(cfg, JAX params, port LM, tokens) for one reduced arch."""
    arch = request.param
    cfg = jcr.get(arch).REDUCED
    tree = jax.tree.map(np.asarray,
                        jt.init_lm_params(jax.random.PRNGKey(0), cfg, tp=1))
    model = tt.params_from_jax(tree, tcr.get(arch).REDUCED, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    return cfg, jax.tree.map(jnp.asarray, tree), model, toks


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_config_registry_matches_jax(arch):
    j, t = jcr.get(arch), tcr.get(arch)
    assert dataclasses.asdict(t.CONFIG) == dataclasses.asdict(j.CONFIG)
    assert dataclasses.asdict(t.REDUCED) == dataclasses.asdict(j.REDUCED)
    assert t.FAMILY == j.FAMILY == "lm"
    assert {k: dataclasses.asdict(v) for k, v in t.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in j.SHAPES.items()}
    assert tcr.shapes_for(arch) is t.SHAPES
    assert t.CONFIG.param_count() == j.CONFIG.param_count()


def test_run_options_and_non_lm_archs():
    assert dataclasses.asdict(RunOptions()) == \
        dataclasses.asdict(JaxRunOptions())
    assert set(tcr.ARCHS) == set(jcr.ARCHS) and tcr.ASSIGNED == jcr.ASSIGNED
    for arch in set(tcr.ARCHS) - set(LM_ARCHS):
        got, want = tcr.get(arch), jcr.get(arch)   # GNN, recsys, engine
        assert got.FAMILY == want.FAMILY
        for name in ("CONFIG", "REDUCED"):
            assert dataclasses.asdict(getattr(got, name)) == \
                dataclasses.asdict(getattr(want, name))
        assert {k: dataclasses.asdict(v) for k, v in got.SHAPES.items()} \
            == {k: dataclasses.asdict(v) for k, v in want.SHAPES.items()}
    with pytest.raises(KeyError):
        tcr.get("gpt-5")


def test_token_stream_copy_matches_jax():
    a, b = TokenStream(49152, 4, 64, seed=0), JaxTokenStream(49152, 4, 64,
                                                            seed=0)
    for step in (0, 3):
        for x, y in zip(a.batch_at(step), b.batch_at(step)):
            np.testing.assert_array_equal(x, y)


def test_params_from_jax_carries_weights_exactly(pair):
    cfg, params, model, _ = pair
    for name in ("embed", "final_norm", "unembed"):
        np.testing.assert_array_equal(getattr(model, name).numpy(),
                                      np.asarray(params[name]))
    assert len(model.layers) == cfg.n_layers
    for name, stacked in params["layers"].items():
        for i, lp in enumerate(model.layers):
            got = getattr(lp, name)
            assert got.dtype == torch.float32 and not got.requires_grad
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(stacked[i]))
    assert model.param_count() == sum(
        np.asarray(x).size for x in jax.tree.leaves(params))


def test_rmsnorm_and_rope_agree(pair):
    cfg, params, model, _ = pair
    r = np.random.default_rng(3)
    x = r.standard_normal((B, S, cfg.n_heads, cfg.hd)).astype(np.float32)
    w = r.standard_normal(cfg.hd).astype(np.float32)
    pos = r.integers(0, 500, (B, S)).astype(np.int32)
    np.testing.assert_allclose(
        tt.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jt.rmsnorm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    np.testing.assert_allclose(
        tt.rope(torch.from_numpy(x), torch.from_numpy(pos),
                cfg.rope_theta).numpy(),
        np.asarray(jt.rope(jnp.asarray(x), jnp.asarray(pos),
                           cfg.rope_theta)), **TOL)


@pytest.mark.parametrize("backend", ["jnp", "interpret"])
def test_lm_forward_and_prefill_match_jax(pair, backend):
    cfg, params, model, toks = pair
    x, _ = jt.lm_forward(params, jnp.asarray(toks), cfg, _jopts(backend),
                         ident)
    np.testing.assert_allclose(model(toks).numpy(), np.asarray(x), **TOL)
    want = jt.prefill(params, jnp.asarray(toks), cfg, _jopts(backend), ident)
    got = model.prefill(toks)
    assert got.shape == (B, 1, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_step_matches_jax_jnp_arm(pair):
    """Six steps into a cache of 16: kv_valid_len masks the zero tail."""
    cfg, params, model, toks = pair
    jc = jt.init_cache(cfg, B, 16, jnp.float32)
    tc = model.init_cache(B, 16)
    for i in range(6):
        want, jc = jt.decode_step(params, jnp.asarray(toks[:, i:i + 1]), jc,
                                  cfg, _jopts("jnp"), ident)
        got, tc = model.decode_step(toks[:, i:i + 1], tc)
        assert tc["pos"] == i + 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), **TOL)


def test_decode_equals_teacher_forced_forward_in_port(pair):
    """A decode step's MoE groups hold one token each (capacity >= 1, no
    drop), so the teacher-forced forward is held to it with one token a
    group too: a larger group may drop assignments past its capacity."""
    cfg, params, model, toks = pair
    if cfg.moe is not None:
        model = tt.params_from_jax(jax.tree.map(np.asarray, params),
                                   model.cfg, device="cpu",
                                   opts=RunOptions(moe_groups=B * S))
    full = (model(toks) @ model.unembed_weight()).float()
    cache = model.init_cache(B, S + 3)
    steps = []
    for i in range(S):
        logits, cache = model.decode_step(toks[:, i:i + 1], cache)
        steps.append(logits)
    torch.testing.assert_close(torch.cat(steps, 1), full, atol=2e-5,
                               rtol=2e-5)
    with pytest.raises(ValueError, match="cannot take"):
        for i in range(4):
            _, cache = model.decode_step(toks[:, :1], cache)


def test_random_init_follows_the_jax_law():
    cfg = tcr.get("qwen2.5-14b").REDUCED
    model = tt.LM(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    tree = jt.init_lm_params(jax.random.PRNGKey(0), jcr.get(
        "qwen2.5-14b").REDUCED)
    assert model.embed.shape == tree["embed"].shape
    for name, stacked in tree["layers"].items():
        got = torch.stack([getattr(lp, name) for lp in model.layers])
        assert got.shape == stacked.shape, name
        if name in ("attn_norm", "ffn_norm"):
            assert bool((got == 1).all())
        elif name in tt.BIAS_PARAMS:
            assert not got.any()
        else:                                 # normal / sqrt(fan_in)
            std = float(got.std()) * np.sqrt(got.shape[-2])
            assert 0.9 < std < 1.1, (name, std)
    again = tt.LM(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    assert torch.equal(again.layers[1].w_up, model.layers[1].w_up)
    with pytest.raises(ValueError, match="Generator"):
        tt.LM(cfg, device="cpu")


def test_unported_options_raise():
    cfg = tcr.get("granite-8b").REDUCED
    gen = torch.Generator()
    for arch in ("olmoe-1b-7b", "moonshot-v1-16b-a3b"):     # ported now
        assert tt.LM(tcr.get(arch).REDUCED, generator=gen,
                     device="cpu").layers[0].e_gate.dim() == 3
    # ported now: remat_policy="dots" trains, kv_cache_dtype="f8" serves
    loss = tt.lm_loss(tt.train_params(cfg, generator=gen, device="cpu"),
                      torch.zeros((1, 4), dtype=torch.long),
                      torch.zeros((1, 4), dtype=torch.long), cfg,
                      RunOptions(remat_policy="dots"))
    assert bool(torch.isfinite(loss))
    # ported now: flash_decode, here on one slot against the JAX
    # decode_step(flash_decode=True) on the (1, 1) host mesh
    from repro.launch.mesh import make_host_mesh, use_mesh
    jcfg = jcr.get("granite-8b").REDUCED
    tree = jax.tree.map(np.asarray,
                        jt.init_lm_params(jax.random.PRNGKey(0), jcfg, tp=1))
    flash = tt.params_from_jax(tree, cfg, device="cpu",
                               opts=RunOptions(flash_decode=True))
    jopts = JaxRunOptions(flash_decode=True, attn_chunk=4,
                          seq_parallel=False)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 5))
    jc, tc = jt.init_cache(jcfg, 2, 8, jnp.float32), flash.init_cache(2, 8)
    with use_mesh(make_host_mesh()):
        step = jax.jit(lambda p, t, c: jt.decode_step(p, t, c, jcfg, jopts,
                                                      ident))
        for i in range(5):
            want, jc = step(tree, jnp.asarray(toks[:, i:i + 1], jnp.int32),
                            jc)
            got, tc = flash.decode_step(toks[:, i:i + 1], tc)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    f8 = tt.LM(cfg, generator=gen, device="cpu",
               opts=RunOptions(kv_cache_dtype="f8"))
    assert f8.init_cache(1, 8)["k"].dtype == torch.float8_e4m3fn
    model = tt.LM(cfg, generator=gen, device="cpu")
    assert model.init_cache(1, 8)["k"].dtype == torch.float32
    bf16 = tt.init_cache(dataclasses.replace(cfg, dtype="bfloat16"), 1, 8,
                         device="cpu")
    with pytest.raises(ValueError, match="differs"):
        model.decode_step([[1]], bf16)
