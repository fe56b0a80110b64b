"""The port's LM training path against the JAX package's, on the CPU.

The same JAX parameter tree (``init_lm_params``, seed 0) and the same
numpy batches go through both packages at the ``REDUCED`` configs of
granite-8b (dense), olmoe-1b-7b and moonshot-v1-16b-a3b (MoE), in
float32. Held to the JAX package:

* ``lm_loss`` and every gradient (``jax.value_and_grad``), remat on and
  off, ``remat_policy="dots"``, ``layer_group`` 2 and
  ``cast_params_early``: 1e-5 relative to each leaf's largest gradient,
  the loss at 1e-6 relative; the ``"dots"`` policy's loss and gradients
  equal the ``"nothing"`` policy's and no remat's bit for bit, and an op
  count shows its backward recompute no ``aten.mm``;
* one train step of the step bundle (loss, grad norm, updated parameters
  and AdamW state), ``grad_accum`` 1 and 2, and ``adamw_update`` over
  three steps: 1e-5;
* int8 compression (exact on the codes, 1e-7 on the floats) and
  ``ef_compressed_psum`` (against the JAX function under a jitted
  ``shard_map``: 1e-6 of the largest gradient so far);
* checkpoints: written by either package, restored by the other, exact;
* ``run_training``'s loss history: 1e-5 relative; the port's own
  crash-resume: exact.

The attention of the training path is the autograd Function whose
backward, on these CPU tensors, is ``flash_attention_bwd_ref``
(``tests/test_torch_flash_attention.py`` holds it to ``jax.vjp``).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcr  # noqa: E402
from repro.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro.config import RunOptions as JaxRunOptions  # noqa: E402
from repro.launch.mesh import mesh_by_name, use_mesh  # noqa: E402
from repro.launch.steps import build_bundle as j_build_bundle  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
from repro.models import recsys as jr  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.sharding import Rules  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro_torch import configs as tcr  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa
                                    restore_checkpoint, save_checkpoint)
from repro_torch.config import RunOptions  # noqa: E402
from repro_torch.ft import DriverConfig, FailureInjector, TrainDriver  # noqa
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.dryrun import dryrun_cell  # noqa: E402
from repro_torch.launch.train import (make_init_and_batches,  # noqa: E402
                                      run_training)
from repro_torch.models import gnn as tg  # noqa: E402
from repro_torch.models import recsys as tr  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim import (adamw_init, adamw_update,  # noqa: E402
                               compress_int8, cosine_schedule,
                               decompress_int8, ef_compressed_psum)

ARCHS = ["granite-8b", "olmoe-1b-7b", "moonshot-v1-16b-a3b"]
B, S = 2, 16
TOL = dict(atol=1e-5, rtol=1e-5)


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


def _tree(arch, seed=0):
    cfg = jcr.get(arch).REDUCED
    return jax.tree.map(np.asarray, jt.init_lm_params(
        jax.random.PRNGKey(seed), cfg, tp=1))


def _batch(cfg, seed=3, b=B, s=S):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _opts(cls, **kw):
    base = dict(kernel_backend="jnp", attn_chunk=16, seq_parallel=False,
                loss_chunk=8, moe_groups=4)
    base.update(kw)
    return cls(**base)


def _assert_tree_close(got, want, rel=1e-5, what=""):
    """Each leaf within ``rel`` of its own largest magnitude."""
    for (path, g), (_, w) in zip(pytree.flatten(got), pytree.flatten(want)):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else \
            np.asarray(g)
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, (what, path, err, scale)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch, opt):
    """JAX's loss and gradients of the seed-0 tree on ``_batch``."""
    jcfg = jcr.get(arch).REDUCED
    tok, tgt = _batch(jcfg)
    opts = _opts(JaxRunOptions, **dict(opt))
    fn = jax.jit(jax.value_and_grad(
        lambda p, tk, tg: jt.lm_loss(p, tk, tg, jcfg, opts, ident)))
    return fn(jax.tree.map(jnp.asarray, _tree(arch)), jnp.asarray(tok),
              jnp.asarray(tgt))


@pytest.mark.parametrize("opt", [
    {"remat": False}, {"remat": True},
    {"remat": True, "layer_group": 2, "cast_params_early": True},
    {"remat": True, "remat_policy": "dots"}],
    ids=["remat-off", "remat-on", "grouped-early-cast", "remat-dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_every_gradient_match_jax(arch, opt):
    jcfg, tcfg = jcr.get(arch).REDUCED, tcr.get(arch).REDUCED
    tree = _tree(arch)
    tok, tgt = _batch(jcfg)
    jloss, jgrads = _jax_value_and_grad(arch, tuple(sorted(opt.items())))
    params = tt.train_params(tcfg, tree, device="cpu")
    loss = tt.lm_loss(params, torch.from_numpy(tok), torch.from_numpy(tgt),
                      tcfg, _opts(RunOptions, **opt))
    grads = torch.autograd.grad(loss, pytree.leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    _assert_tree_close(pytree.unflatten(params, grads), jgrads,
                       what=(arch, opt))


class _OpCount(TorchDispatchMode):
    """Counts the ATen ops that reach the dispatcher while it is on."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _loss_grads_and_backward_ops(arch, **opt):
    """lm_loss of the seed-0 tree on ``_batch`` under ``opt``: (loss,
    gradients, the backward's op counts)."""
    cfg = tcr.get(arch).REDUCED
    params = tt.train_params(cfg, _tree(arch), device="cpu")
    tok, tgt = map(torch.from_numpy, _batch(cfg))
    loss = tt.lm_loss(params, tok, tgt, cfg, _opts(RunOptions, **opt))
    with _OpCount() as ops:
        grads = torch.autograd.grad(loss, pytree.leaves(params))
    return loss.detach(), grads, ops.n


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_policy_equals_nothing_and_no_remat_bitwise(arch):
    """``remat_policy="dots"`` changes what the backward keeps, not what
    it computes: the loss and every gradient equal those of the
    ``"nothing"`` policy and of no remat, bit for bit."""
    want_loss, want, _ = _loss_grads_and_backward_ops(arch, remat=False)
    for policy in ("nothing", "dots"):
        loss, grads, _ = _loss_grads_and_backward_ops(
            arch, remat=True, remat_policy=policy)
        assert torch.equal(loss, want_loss), policy
        assert all(torch.equal(g, w) for g, w in zip(grads, want)), policy


@pytest.mark.parametrize("arch", ["granite-8b", "moonshot-v1-16b-a3b"])
def test_dots_policy_saves_every_mm_and_recomputes_the_rest(arch):
    """JAX's ``dots_with_no_batch_dims_saveable`` on the port: the
    backward under ``"dots"`` runs as many ``aten.mm`` as without remat
    (it recomputes none: the projections, the SwiGLU and the router are
    saved), under ``"nothing"`` it runs the forward's again (all but the
    last of a layer where nothing after it is needed: the non-reentrant
    checkpoint stops its recompute there), and both recompute the batched
    products (``aten.bmm``: the attention and the MoE experts, which JAX's
    policy does not save either)."""
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    cfg = tcr.get(arch).REDUCED
    params = tt.train_params(cfg, _tree(arch), device="cpu")
    tok = torch.from_numpy(_batch(cfg)[0])
    with _OpCount() as fwd:
        tt.forward_hidden(params, tok, cfg, _opts(RunOptions, remat=False))
    n = {policy: _loss_grads_and_backward_ops(arch, **opt)[2]
         for policy, opt in (("off", dict(remat=False)),
                             ("nothing", dict(remat=True)),
                             ("dots", dict(remat=True, remat_policy="dots")))}
    assert fwd.n[mm] > 0 and fwd.n[bmm] > 0
    assert n["dots"][mm] == n["off"][mm]
    again = n["nothing"][mm] - n["off"][mm]
    assert fwd.n[mm] - cfg.n_layers <= again <= fwd.n[mm]
    assert n["dots"][bmm] == n["nothing"][bmm] > n["off"][bmm]


def test_remat_policy_is_checked():
    cfg = tcr.get("granite-8b").REDUCED
    params = tt.train_params(cfg, _tree("granite-8b"), device="cpu")
    tok = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="remat_policy"):
        tt.forward_hidden(params, tok, cfg, RunOptions(remat_policy="all"))
    # remat off: the policy is not read, as in the JAX package
    tt.forward_hidden(params, tok, cfg,
                      RunOptions(remat=False, remat_policy="all"))


def test_train_params_are_float32_masters():
    cfg = tcr.get("olmoe-1b-7b").REDUCED
    params = tt.train_params(cfg, _tree("olmoe-1b-7b"), device="cpu")
    for leaf in pytree.leaves(params):
        assert isinstance(leaf, torch.nn.Parameter) and leaf.requires_grad
        assert leaf.dtype == torch.float32
    assert params["layers"]["e_gate"].shape[:2] == (cfg.n_layers,
                                                    cfg.moe.n_experts)
    drawn = tt.train_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert {p: x.shape for p, x in pytree.flatten(drawn)} == \
        {p: x.shape for p, x in pytree.flatten(params)}
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    x, aux = tt.forward_hidden(params, torch.zeros((1, 8), dtype=torch.long),
                               bf, RunOptions(remat=False))
    assert x.dtype == torch.bfloat16 and aux.dtype == torch.float32
    with pytest.raises(ValueError, match="do not match"):
        tt.train_params(cfg, _tree("granite-8b"), device="cpu")


def _jax_step(arch, shape_over, accum, tree, tok, tgt):
    mesh = mesh_by_name("host")
    opts = _opts(JaxRunOptions, grad_accum=accum)
    bundle = j_build_bundle(arch, "train_4k", Rules(mesh), opts,
                            reduced=True, overrides=shape_over)
    params = jax.tree.map(jnp.asarray, tree)
    with use_mesh(mesh):
        return jax.jit(bundle.step_fn)(params, jadamw.adamw_init(params),
                                       jnp.asarray(tok), jnp.asarray(tgt))


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["granite-8b", "olmoe-1b-7b"])
def test_train_step_matches_jax(arch, accum):
    over = {"seq_len": S, "global_batch": 4}
    tree = _tree(arch)
    tok, tgt = _batch(jcr.get(arch).REDUCED, seed=5, b=4)
    jp, jo, jm = _jax_step(arch, over, accum, tree, tok, tgt)
    bundle = tsteps.build_bundle(arch, "train_4k",
                                 _opts(RunOptions, grad_accum=accum),
                                 reduced=True, overrides=over)
    assert bundle.kind == "train" and bundle.meta["tokens"] == 4 * S
    params = tt.train_params(bundle.cfg, tree, device="cpu")
    p, o, m = bundle.step_fn(params, adamw_init(params),
                             torch.from_numpy(tok), torch.from_numpy(tgt))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               **TOL)
    _assert_tree_close(p, jp, what="params")
    _assert_tree_close(o.m, jo.m, what="m")
    _assert_tree_close(o.v, jo.v, rel=1e-4, what="v")
    assert int(o.count) == int(jo.count) == 1


def test_adamw_matches_jax_over_three_steps():
    r = np.random.default_rng(0)
    tree = {"w": r.standard_normal((8, 5)).astype(np.float32),
            "inner": {"b": r.standard_normal((5,)).astype(np.float32),
                      "a": r.standard_normal((3, 2)).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jadamw.adamw_init(jp)
    tp = pytree.tree_map(lambda a: torch.tensor(a), tree)
    to = adamw_init(tp)
    for step in range(3):
        grads = jax.tree.map(
            lambda a: (r.standard_normal(a.shape) * 3).astype(np.float32),
            tree)
        kw = dict(weight_decay=0.1, clip_norm=1.0 if step != 1 else 100.0)
        jlr = jadamw.cosine_schedule(jo.count, warmup=2, total=10)
        tlr = cosine_schedule(to.count, warmup=2, total=10)
        np.testing.assert_allclose(float(tlr), float(jlr), rtol=1e-7)
        jp, jo, jm = jadamw.adamw_update(jax.tree.map(jnp.asarray, grads),
                                         jo, jp, lr=jlr, **kw)
        tp, to, tm = adamw_update(pytree.tree_map(torch.tensor, grads), to,
                                  tp, lr=tlr, **kw)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for got, want in ((tp, jp), (to.m, jo.m), (to.v, jo.v)):
            for g, w in zip(pytree.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-7)
    assert int(to.count) == 3 and to.count.dtype == torch.int32
    for step in (0, 50, 100, 5000, 20000):
        np.testing.assert_allclose(
            float(cosine_schedule(torch.tensor(step, dtype=torch.int32))),
            float(jadamw.cosine_schedule(jnp.int32(step))), rtol=1e-6)


def test_compress_int8_matches_jax():
    r = np.random.default_rng(0)
    for x in (r.standard_normal(256).astype(np.float32) * 3,
              np.zeros(7, np.float32),
              r.standard_normal((4, 9)).astype(np.float32) * 1e-3):
        jc, js = jcompress.compress_int8(jnp.asarray(x))
        tc, ts = compress_int8(torch.from_numpy(x))
        assert tc.dtype == torch.int8
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(float(ts), float(js), rtol=1e-7)
        np.testing.assert_allclose(
            decompress_int8(tc, ts).numpy(),
            np.asarray(jcompress.decompress_int8(jc, js)), rtol=1e-7)
        err = np.abs(decompress_int8(tc, ts).numpy() - x).max()
        assert err <= float(ts) / 2 + 1e-6


def _shard_map():
    try:
        from jax import shard_map
    except ImportError:          # jax < 0.5 keeps it in experimental
        from jax.experimental.shard_map import shard_map
    return shard_map


def test_ef_compressed_psum_matches_jax_under_shard_map():
    """One axis member, as tests/test_ft.py runs the JAX function: twenty
    error-feedback steps, the sent sums and errors equal."""
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:1]), ("pod",))
    fn = jax.jit(_shard_map()(
        lambda g, e: jcompress.ef_compressed_psum(g, e, "pod"), mesh=mesh,
        in_specs=(P(), P()), out_specs=(P(), P())))
    r = np.random.default_rng(1)
    jerr, terr = jnp.zeros(64), [torch.zeros(64)]
    sent, big = torch.zeros(64), 0.0
    gs = [r.standard_normal(64).astype(np.float32) * 10 ** (i % 3)
          for i in range(20)]
    for g in gs:
        jsent, jerr = fn(jnp.asarray(g), jerr)
        tsent, terr = ef_compressed_psum([torch.from_numpy(g)], terr)
        # jit may divide by multiplying with the reciprocal and fuse the
        # residual: a rounding apart, 1e-6 of the largest gradient so far
        # (the error buffers carry residuals of that size)
        big = max(big, float(np.abs(g).max()))
        tol = 1e-6 * big
        np.testing.assert_allclose(tsent.numpy(), np.asarray(jsent), rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(terr[0].numpy(), np.asarray(jerr), rtol=0,
                                   atol=tol)
        sent += tsent
    np.testing.assert_allclose((sent + terr[0]).numpy(), sum(gs), rtol=1e-4,
                               atol=1e-3)


def test_ef_compressed_psum_over_four_members():
    """The shared grid: the largest member's scale, an exact int32 sum of
    the codes, each member's own residual (numpy of the JAX formulas)."""
    r = np.random.default_rng(2)
    gs = [r.standard_normal(33).astype(np.float32) * s for s in (1, 5, .1, 2)]
    es = [r.standard_normal(33).astype(np.float32) * .01 for _ in gs]
    red, new = ef_compressed_psum([torch.from_numpy(g) for g in gs],
                                  [torch.from_numpy(e) for e in es])
    tot = [g + e for g, e in zip(gs, es)]
    smax = np.float32(max(max(np.abs(t).max(), 1e-12) for t in tot) / 127.0)
    codes = [np.clip(np.round(t / smax), -127, 127) for t in tot]
    want = sum(c.astype(np.int32) for c in codes).astype(np.float32) * smax
    np.testing.assert_allclose(red.numpy(), want, rtol=1e-6)
    for n, t, c in zip(new, tot, codes):
        np.testing.assert_allclose(n.numpy(), t - c * smax, rtol=1e-6,
                                   atol=1e-7)
    with pytest.raises(ValueError):
        ef_compressed_psum([torch.zeros(3)], [])


def _state_tree(arch="olmoe-1b-7b"):
    """A (params, AdamWState) tree after one port step, as numpy and as
    the port's tensors."""
    cfg = tcr.get(arch).REDUCED
    params = tt.train_params(cfg, _tree(arch), device="cpu")
    opt = adamw_init(params)
    tok, tgt = _batch(cfg)
    loss = tt.lm_loss(params, torch.from_numpy(tok), torch.from_numpy(tgt),
                      cfg, _opts(RunOptions))
    grads = pytree.unflatten(params, torch.autograd.grad(
        loss, pytree.leaves(params)))
    params, opt, _ = adamw_update(grads, opt, params, lr=1e-3)
    return params, opt


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    params, opt = _state_tree()
    save_checkpoint(tmp_path, 7, (params, opt), extra={"note": "port"})
    jtemplate = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(tuple(x.shape), jnp.float32
                                       if x.dtype == torch.float32
                                       else jnp.int32),
        (pytree.tree_map(lambda t: t.detach(), params),
         jadamw.AdamWState(m=opt.m, v=opt.v, count=opt.count)),
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    got, step, extra = j_restore(tmp_path, jtemplate)
    assert step == 7 and extra == {"note": "port"}
    for a, b in zip(pytree.leaves((params, opt)), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    assert int(got[1].count) == 1


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    tree = _tree("granite-8b")
    jparams = jax.tree.map(jnp.asarray, tree)
    jopt = jadamw.adamw_init(jparams)
    jopt = jopt._replace(count=jnp.int32(5),
                         m=jax.tree.map(lambda a: a * 0.5, jparams))
    j_save(tmp_path, 3, (jparams, jopt), extra={"wall": 1.5})
    template = (tt.train_params(tcr.get("granite-8b").REDUCED,
                                generator=torch.Generator().manual_seed(1),
                                device="cpu"), None)
    template = (template[0], adamw_init(template[0]))
    (params, opt), step, extra = restore_checkpoint(tmp_path, template,
                                                    device="cpu")
    assert step == 3 and extra == {"wall": 1.5}
    assert int(opt.count) == 5 and opt.count.dtype == torch.int32
    for a, b in zip(pytree.leaves((params, opt)),
                    jax.tree.leaves((jparams, jopt))):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    assert all(isinstance(p, torch.nn.Parameter) and p.requires_grad
               for p in pytree.leaves(params))


def _family_tree(family):
    """A GNN tree (lists of weights, stacked blocks) or a recsys tree in
    the JAX layout, with its port counterpart (float32 masters)."""
    if family == "gnn":
        cfg = jcr.get("meshgraphnet").REDUCED
        tree = jax.tree.map(np.asarray, jg.init_gnn_params(
            jax.random.PRNGKey(0), cfg, d_in=5, d_out=3))
        return tree, tg.gnn_params_from_jax(
            tree, tcr.get("meshgraphnet").REDUCED, device="cpu")
    cfg = jcr.get("two-tower-retrieval").REDUCED
    tree = jax.tree.map(np.asarray, jr.init_recsys_params(
        jax.random.PRNGKey(0), cfg))
    return tree, tr.recsys_params_from_jax(
        tree, tcr.get("two-tower-retrieval").REDUCED, device="cpu")


@pytest.mark.parametrize("family", ["gnn", "recsys"])
def test_model_checkpoints_cross_restore(tmp_path, family):
    """Written by the port and restored in JAX, and the reverse: the GNN
    tree's lists of MLP weights and stacked blocks, the recsys tables."""
    tree, params = _family_tree(family)
    opt = adamw_init(params)
    opt = opt._replace(count=torch.tensor(4, dtype=torch.int32),
                       m=pytree.tree_map(lambda p: p.detach() * 0.5, params))
    save_checkpoint(tmp_path / "port", 2, (params, opt))
    jparams = jax.tree.map(jnp.asarray, tree)
    jtemplate = (jparams, jadamw.adamw_init(jparams))
    got, step, _ = j_restore(tmp_path / "port", jtemplate)
    assert step == 2 and int(got[1].count) == 4
    for a, b in zip(pytree.leaves((params, opt)), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))

    jopt = jadamw.adamw_init(jparams)._replace(
        count=jnp.int32(6), v=jax.tree.map(lambda a: a * 0.25, jparams))
    j_save(tmp_path / "jax", 5, (jparams, jopt))
    zeros = pytree.tree_map(lambda p: torch.nn.Parameter(torch.zeros_like(p)),
                            params)
    (rp, ro), step, _ = restore_checkpoint(
        tmp_path / "jax", (zeros, adamw_init(zeros)), device="cpu")
    assert step == 5 and int(ro.count) == 6
    for a, b in zip(pytree.leaves((rp, ro)),
                    jax.tree.leaves((jparams, jopt))):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    assert all(isinstance(p, torch.nn.Parameter) for p in pytree.leaves(rp))


def test_checkpoint_format_edges(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.int32),
                       "h": torch.full((2,), 1.5, dtype=torch.bfloat16)}}
    save_checkpoint(tmp_path, 5, tree)
    got, step, _ = restore_checkpoint(tmp_path, tree, device="cpu")
    assert step == 5 and got["nested"]["h"].dtype == torch.bfloat16
    for a, b in zip(pytree.leaves(tree), pytree.leaves(got)):
        assert torch.equal(a, b)
    # a crashed partial write never counts
    bad = tmp_path / "step_9.tmp"
    bad.mkdir()
    (bad / "garbage.npy").write_bytes(b"xx")
    assert latest_step(tmp_path) == 5
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, {"a": torch.zeros(3), "nested": {
            "b": torch.zeros(4), "h": torch.zeros(2)}})
    with pytest.raises(KeyError):
        restore_checkpoint(tmp_path, {"zz": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "none", tree)


def test_checkpoint_manager_keeps_the_last_and_saves_async(tmp_path):
    mgr = CheckpointManager(tmp_path / "gc", keep=2)
    t = {"a": torch.ones(2)}
    for s in [1, 2, 3, 4]:
        mgr.save(s, t)
    assert sorted(d.name for d in (tmp_path / "gc").iterdir()) == \
        ["step_3", "step_4"]
    mgr = CheckpointManager(tmp_path / "as", async_save=True)
    x = torch.arange(4.0)
    mgr.save(7, {"a": x})
    x.add_(100)                      # the snapshot was taken at save()
    mgr.wait()
    got, _, _ = mgr.restore({"a": torch.zeros(4)})
    assert latest_step(tmp_path / "as") == 7
    assert torch.equal(got["a"], torch.arange(4.0))


# a train shape and its CPU-sized overrides per arch of the driver tests
DRIVER_SHAPES = {"meshgraphnet": ("full_graph_sm", {"n_nodes": 150,
                                                    "n_edges": 600,
                                                    "d_feat": 9})}


def _driver(tmp_path, total, fail_at=None, ckpt_every=2, arch="granite-8b"):
    shape, over = DRIVER_SHAPES.get(
        arch, ("train_4k", {"seq_len": S, "global_batch": 2}))
    bundle = tsteps.build_bundle(arch, shape, _opts(RunOptions),
                                 reduced=True, overrides=over)
    init_state, batch_fn = make_init_and_batches(bundle, "cpu")
    cfg = DriverConfig(total_steps=total, ckpt_dir=str(tmp_path),
                       ckpt_every=ckpt_every, async_save=True)
    return TrainDriver(cfg, bundle.step_fn, init_state, batch_fn,
                       injector=FailureInjector(fail_at))


@pytest.mark.parametrize("arch", ["granite-8b", "olmoe-1b-7b",
                                  "meshgraphnet"])
def test_crash_resume_is_exact(tmp_path, arch):
    ref = _driver(tmp_path / "ref", 5, arch=arch).run()
    crashing = _driver(tmp_path / "crash", 5, fail_at=3, arch=arch)
    with pytest.raises(RuntimeError, match="injected failure"):
        crashing.run()
    crashing.mgr.wait()        # the save of step 1 may still be writing
    assert latest_step(tmp_path / "crash") == 1
    out = _driver(tmp_path / "crash", 5, arch=arch).run()
    assert [h["step"] for h in out["history"]] == [2, 3, 4]
    assert out["history"] == ref["history"][2:]
    for a, b in zip(pytree.leaves(ref["params"]),
                    pytree.leaves(out["params"])):
        assert torch.equal(a, b)
    assert torch.equal(ref["opt_state"].count, out["opt_state"].count)


def test_straggler_detection(tmp_path):
    import time as _t
    d = _driver(tmp_path / "s", 8, ckpt_every=100)
    orig, calls = d.step_fn, {"n": 0}

    def slow_step(*a):
        calls["n"] += 1
        if calls["n"] == 7:          # well past 3x the median step
            _t.sleep(max(0.5, 5 * max(d.step_times)))
        return orig(*a)

    d.step_fn = slow_step
    out = d.run()
    assert 6 in out["stragglers"]


def test_run_training_matches_jax(tmp_path):
    from repro.launch.train import run_training as j_run
    over = {"seq_len": 32, "global_batch": 4}
    want = j_run("granite-8b", "train_4k", steps=4,
                 ckpt_dir=str(tmp_path / "jax"), reduced=True,
                 overrides=over)
    got = run_training("granite-8b", "train_4k", steps=4,
                       ckpt_dir=tmp_path / "port", reduced=True,
                       overrides=over, device="cpu",
                       params=_tree("granite-8b"))
    assert [h["step"] for h in got["history"]] == [0, 1, 2, 3]
    for g, w in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-5)
    assert latest_step(tmp_path / "port") == 3


def test_build_bundle_and_run_training_under_dots(tmp_path):
    """The train bundle and the driver under ``remat_policy="dots"``: the
    same history as under ``"nothing"``, bit for bit."""
    over = {"seq_len": 32, "global_batch": 4}
    hist = {}
    for policy in ("nothing", "dots"):
        opts = RunOptions(seq_parallel=False, loss_chunk=16, attn_chunk=32,
                          moe_groups=4, remat=True, remat_policy=policy)
        bundle = tsteps.build_bundle("olmoe-1b-7b", "train_4k", opts,
                                     reduced=True, overrides=over)
        assert bundle.opts.remat_policy == policy
        out = run_training("olmoe-1b-7b", "train_4k", steps=3,
                           ckpt_dir=tmp_path / policy, reduced=True,
                           overrides=over, opts=opts, device="cpu",
                           params=_tree("olmoe-1b-7b"))
        hist[policy] = out["history"]
    assert [h["step"] for h in hist["dots"]] == [0, 1, 2]
    assert [(h["loss"], h["grad_norm"]) for h in hist["dots"]] == \
        [(h["loss"], h["grad_norm"]) for h in hist["nothing"]]


def test_launchers_refuse_what_is_not_ported(tmp_path):
    # still refused: both need the sharded train step and the GNN and
    # recsys splits, the next slices of the sharded model code
    with pytest.raises(NotImplementedError,
                       match="sharded train step.*GNN and recsys.*ROADMAP"):
        run_training("granite-8b", "train_4k", 1, tmp_path, mesh_name="pod",
                     device="cpu")
    with pytest.raises(NotImplementedError,
                       match="sharded train step.*GNN and.*recsys.*meta"):
        dryrun_cell("path-engine", "batch_1b", "pod")
    # ported now: the ring on one CPU slot equals the JAX ring on one
    # device (tests/test_torch_mesh.py: 8 and 3 slots)
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P
    from repro_torch.launch.mesh import make_cells_mesh, make_host_mesh
    rng = np.random.default_rng(5)
    h = rng.standard_normal((8, 3)).astype(np.float32)
    es, ed = rng.integers(0, 8, (2, 1, 1, 12)).astype(np.int32)
    em = rng.random((1, 1, 12)) < 0.75
    ring = jax.shard_map(
        lambda hh, a, b, c: jg.ring_aggregate(hh, a[0], b[0], c[0], "cells"),
        mesh=Mesh(np.array(jax.devices()[:1]), ("cells",)),
        in_specs=(P("cells"),) * 4, out_specs=P("cells"), check_vma=False)
    got = tg.ring_aggregate([torch.from_numpy(h)],
                            *map(torch.from_numpy, (es, ed, em)),
                            make_cells_mesh(devices=["cpu"]), "cells")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ring(h, es, ed, em)),
                               atol=1e-5)
    # ported now: the "dots" remat policy and the float8 KV cache
    assert tsteps.build_bundle("granite-8b", "train_4k",
                               RunOptions(remat_policy="dots"),
                               reduced=True).opts.remat_policy == "dots"
    assert tsteps.build_bundle("granite-8b", "decode_32k",
                               RunOptions(kv_cache_dtype="f8"),
                               reduced=True).kind == "decode"
    # ported now: the decode bundle under flash_decode, its step on a
    # (1, 2) layout of CPU slots against the JAX bundle's on the host mesh
    opts = RunOptions(flash_decode=True, attn_chunk=4, seq_parallel=False)
    over = {"seq_len": 8, "global_batch": 2}
    bundle = tsteps.build_bundle("granite-8b", "decode_32k", opts,
                                 reduced=True, overrides=over)
    assert bundle.kind == "decode" and bundle.opts.flash_decode
    jmesh = mesh_by_name("host")
    jb = j_build_bundle("granite-8b", "decode_32k", Rules(jmesh),
                        JaxRunOptions(flash_decode=True, attn_chunk=4,
                                      seq_parallel=False),
                        reduced=True, overrides=over)
    tree = _tree("granite-8b")
    model = tt.params_from_jax(tree, bundle.cfg, device="cpu", opts=opts) \
        .with_mesh(make_host_mesh(1, 2, devices=["cpu"] * 2))
    toks = rng.integers(0, bundle.cfg.vocab, (2, 3)).astype(np.int32)
    jc = jt.init_cache(jcr.get("granite-8b").REDUCED, 2, 8, jnp.float32)
    tc = model.init_cache(2, 8)
    with use_mesh(jmesh):
        jstep = jax.jit(jb.step_fn)
        for i in range(3):
            want, jc = jstep(jax.tree.map(jnp.asarray, tree),
                             jnp.asarray(toks[:, i:i + 1]), jc)
            got, tc = bundle.step_fn(model, torch.from_numpy(toks[:, i:i + 1]),
                                     tc)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="train shape"):
        run_training("granite-8b", "decode_32k", 1, tmp_path, device="cpu")
    assert tsteps.build_bundle("olmoe-1b-7b", "decode_32k").kind == "decode"

