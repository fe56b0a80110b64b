"""The port's MoE FFN against the JAX package's, on the CPU.

``repro_torch.models.moe.moe_ffn`` and ``moe_ffn_dense_ref`` against
``repro.models.moe`` on the same numpy inputs, at the ``REDUCED`` configs
of olmoe-1b-7b and moonshot-v1-16b-a3b (float32): outputs, the aux loss
and, through ``jax.vjp``, the gradients. Groups 1, 4 and 16, a capacity
that drops tokens, and router logits with forced ties. Tolerance: 1e-5
absolute and relative (the expert products sum in another order; the
dispatch, the drops and the combine's order are the JAX function's).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcr  # noqa: E402
from repro.models import moe as jm  # noqa: E402
from repro_torch import configs as tcr  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402

ARCHS = ["olmoe-1b-7b", "moonshot-v1-16b-a3b"]
TOL = dict(atol=1e-5, rtol=1e-5)
NAMES = ("router", "e_gate", "e_up", "e_down")


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


def _cfgs(arch, capacity_factor=None):
    j, t = jcr.get(arch).REDUCED, tcr.get(arch).REDUCED
    if capacity_factor is not None:
        j = dataclasses.replace(j, moe=dataclasses.replace(
            j.moe, capacity_factor=capacity_factor))
        t = dataclasses.replace(t, moe=dataclasses.replace(
            t.moe, capacity_factor=capacity_factor))
    return j, t


def _inputs(cfg, seed, B=2, S=24, tie=False):
    r = np.random.default_rng(seed)
    D, E, Fe = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    lp = {"router": r.standard_normal((D, E)) / np.sqrt(D),
          "e_gate": r.standard_normal((E, D, Fe)) / np.sqrt(D),
          "e_up": r.standard_normal((E, D, Fe)) / np.sqrt(D),
          "e_down": r.standard_normal((E, Fe, D)) / np.sqrt(Fe)}
    if tie:
        # experts 1 and 2 (and 5 and 6) get the same router column, so
        # every token's logits tie between them
        lp["router"][:, 2] = lp["router"][:, 1]
        lp["router"][:, 6] = lp["router"][:, 5]
    lp = {k: v.astype(np.float32) for k, v in lp.items()}
    h = r.standard_normal((B, S, D)).astype(np.float32)
    return h, lp


def _both(h, lp, jcfg, tcfg, groups):
    want, waux = jm.moe_ffn(jnp.asarray(h),
                            {k: jnp.asarray(v) for k, v in lp.items()},
                            jcfg, ident, groups=groups)
    got, aux = tm.moe_ffn(torch.from_numpy(h),
                          {k: torch.from_numpy(v) for k, v in lp.items()},
                          tcfg, groups=groups)
    return (np.asarray(want), float(waux)), (got.numpy(), float(aux))


@pytest.mark.parametrize("groups", [1, 4, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, groups):
    jcfg, tcfg = _cfgs(arch)
    h, lp = _inputs(jcfg, 3)
    (want, waux), (got, aux) = _both(h, lp, jcfg, tcfg, groups)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(aux, waux, **TOL)


@pytest.mark.parametrize("groups", [1, 4, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_drops_as_jax_does(arch, groups):
    """capacity_factor 0.5: a fifth to two thirds of the assignments are
    past their expert's capacity and give 0, in both packages alike."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=0.5)
    h, lp = _inputs(jcfg, 4)
    (want, waux), (got, aux) = _both(h, lp, jcfg, tcfg, groups)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(aux, waux, **TOL)
    share = tm.dropped_share(torch.from_numpy(h),
                             {k: torch.from_numpy(v) for k, v in lp.items()},
                             tcfg, groups)
    assert 0.15 < share < 0.8, share
    full = tm.moe_ffn_dense_ref(torch.from_numpy(h), {
        k: torch.from_numpy(v) for k, v in lp.items()}, tcfg).numpy()
    assert not np.allclose(got, full, atol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_break_toward_the_lower_expert(arch):
    jcfg, tcfg = _cfgs(arch)
    h, lp = _inputs(jcfg, 5, tie=True)
    probs = torch.softmax(torch.from_numpy(h).reshape(-1, jcfg.d_model)
                          @ torch.from_numpy(lp["router"]), -1)
    assert bool((probs[:, 1] == probs[:, 2]).all())
    vals, idx = tm.top_k(probs, jcfg.moe.top_k)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), jcfg.moe.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    chosen = idx.numpy()
    both = ((chosen == 1).any(-1) & (chosen == 2).any(-1)).sum()
    one = ((chosen == 1).any(-1) ^ (chosen == 2).any(-1)).sum()
    assert one > 0 or both > 0
    for groups in (1, 4):
        (want, waux), (got, aux) = _both(h, lp, jcfg, tcfg, groups)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(aux, waux, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_ref_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    h, lp = _inputs(jcfg, 6)
    want = jm.moe_ffn_dense_ref(jnp.asarray(h), {
        k: jnp.asarray(v) for k, v in lp.items()}, jcfg)
    got = tm.moe_ffn_dense_ref(torch.from_numpy(h), {
        k: torch.from_numpy(v) for k, v in lp.items()}, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_no_drop_equals_the_dense_oracle(arch):
    """One token a group (a decode step): C >= 1, nothing is dropped, and
    the dispatch equals evaluating every expert densely."""
    jcfg, tcfg = _cfgs(arch)
    h, lp = _inputs(jcfg, 7, B=4, S=1)
    t = {k: torch.from_numpy(v) for k, v in lp.items()}
    assert tm.capacity(4, tcfg, 16) == (4, 1, 1)
    assert tm.dropped_share(torch.from_numpy(h), t, tcfg, 16) == 0.0
    got, _ = tm.moe_ffn(torch.from_numpy(h), t, tcfg, groups=16)
    torch.testing.assert_close(
        got, tm.moe_ffn_dense_ref(torch.from_numpy(h), t, tcfg), **TOL)


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_gradients_match_jax(arch, groups):
    """jax.vjp of (out, aux) against torch.autograd, for h and every
    expert weight, with drops (capacity_factor 1.0)."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=1.0)
    h, lp = _inputs(jcfg, 8)
    r = np.random.default_rng(9)
    gout = r.standard_normal(h.shape).astype(np.float32)
    gaux = np.float32(0.7)

    def f(h_, lp_):
        return jm.moe_ffn(h_, lp_, jcfg, ident, groups=groups)

    _, vjp = jax.vjp(f, jnp.asarray(h),
                     {k: jnp.asarray(v) for k, v in lp.items()})
    jh, jlp = vjp((jnp.asarray(gout), jnp.asarray(gaux)))
    th = torch.from_numpy(h).requires_grad_()
    tlp = {k: torch.from_numpy(v).requires_grad_() for k, v in lp.items()}
    out, aux = tm.moe_ffn(th, tlp, tcfg, groups=groups)
    ((out * torch.from_numpy(gout)).sum() + aux * float(gaux)).backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jh), **TOL)
    for name in NAMES:
        np.testing.assert_allclose(tlp[name].grad.numpy(),
                                   np.asarray(jlp[name]), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("T,groups", [(48, 16), (48, 5), (7, 16), (4, 0)])
def test_capacity_matches_the_jax_arithmetic(T, groups):
    import math
    cfg = tcr.get("olmoe-1b-7b").CONFIG
    G = math.gcd(T, max(groups, 1))
    Tg = T // G
    C = max(int(Tg * cfg.moe.top_k / cfg.moe.n_experts
                * cfg.moe.capacity_factor), 1)
    assert tm.capacity(T, cfg, groups) == (G, Tg, C)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_logits_match_jax_at_1e5(arch):
    """The whole REDUCED model in float32, prefill and six decode steps,
    against the JAX package's jnp arm at 1e-5 absolute and relative."""
    from repro.config import RunOptions as JaxRunOptions
    from repro.models import transformer as jt
    from repro_torch.models import transformer as tt
    jcfg, tcfg = _cfgs(arch)
    tree = jax.tree.map(np.asarray,
                        jt.init_lm_params(jax.random.PRNGKey(0), jcfg, tp=1))
    params = jax.tree.map(jnp.asarray, tree)
    model = tt.params_from_jax(tree, tcfg, device="cpu")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 12)) \
        .astype(np.int32)
    opts = JaxRunOptions(kernel_backend="jnp", attn_chunk=16,
                         seq_parallel=False)
    want = jt.prefill(params, jnp.asarray(toks), jcfg, opts, ident)
    np.testing.assert_allclose(model.prefill(toks).numpy(),
                               np.asarray(want), **TOL)
    jc, tc = jt.init_cache(jcfg, 2, 8, jnp.float32), model.init_cache(2, 8)
    for i in range(6):
        want, jc = jt.decode_step(params, jnp.asarray(toks[:, i:i + 1]), jc,
                                  jcfg, opts, ident)
        got, tc = model.decode_step(toks[:, i:i + 1], tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
