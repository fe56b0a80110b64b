"""The port's two-tower recsys model against the JAX package's, on the CPU.

The same JAX parameter tree (``init_recsys_params`` of two-tower-retrieval's
``REDUCED`` config, carried across by ``recsys_params_from_jax``) and the
same numpy batches go through both packages, in float32. Held to the JAX
package:

* ``embedding_bag`` (mean and sum, -1 pads, an all-pad bag) and its
  gradient, the user and item towers, ``recsys_loss`` with and without
  the logQ correction and every gradient, ``score_candidates``: rtol =
  atol = 1e-5;
* ``topk_stable`` against ``jax.lax.top_k`` on scores with ties and
  -inf: equal; ``retrieve_topk`` and the retrieval bundle (candidates
  padded with -1), also with every score tied bit for bit: equal ids,
  scores at 1e-5; the serve bundle at 1e-5;
* ``InteractionStream.batch_at``: equal arrays;
* one train step of the train bundle against the JAX bundle's jitted
  step: loss, grad norm, parameters and AdamW state at 1e-5;
* ``run_training``'s history over four steps at the JAX tests'
  ``SMOKE_CASES`` batch of 16: rtol 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcr  # noqa: E402
from repro.data.recsys_data import InteractionStream as JStream  # noqa: E402
from repro.launch.mesh import mesh_by_name, use_mesh  # noqa: E402
from repro.launch.steps import build_bundle as j_build_bundle  # noqa: E402
from repro.models import recsys as jr  # noqa: E402
from repro.models.sharding import Rules  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs as tcr  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.data.recsys_data import InteractionStream  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models import recsys as tr  # noqa: E402
from repro_torch.models import segment as tseg  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

ARCH = "two-tower-retrieval"
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _assert_tree_close(got, want, what=""):
    """The same tree paths, each leaf at rtol = atol = 1e-5."""
    got, want = pytree.flatten(got), pytree.flatten(want)
    assert [p for p, _ in got] == [p for p, _ in want], what
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL,
                                   err_msg=f"{what} {path}")


def _cfgs():
    return jcr.get(ARCH).REDUCED, tcr.get(ARCH).REDUCED


def _tree(seed=0):
    return jax.tree.map(np.array, jr.init_recsys_params(
        jax.random.PRNGKey(seed), _cfgs()[0]))


def _both(tree=None):
    tree = _tree() if tree is None else tree
    return (jax.tree.map(jnp.asarray, tree),
            tr.recsys_params_from_jax(tree, _cfgs()[1], device="cpu"))


def _batch(B=12, seed=1):
    return InteractionStream(_cfgs()[1], B, seed=seed).batch_at(3)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_param_tree_and_logical_axes_match_jax():
    tree = _tree()
    params = tr.init_recsys_params(
        _cfgs()[1], generator=torch.Generator().manual_seed(0), device="cpu")
    got, want = pytree.flatten(params), pytree.flatten(tree)
    assert [(p, tuple(x.shape)) for p, x in got] == \
        [(p, x.shape) for p, x in want]
    assert tr.recsys_param_count(_cfgs()[1]) == sum(x.size for _, x in want)
    assert pytree.flatten(tr.recsys_param_logical(params)) == \
        pytree.flatten(jr.recsys_param_logical(tree))


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_embedding_bag_and_its_gradient_match_jax(mode):
    r = np.random.default_rng(0)
    table = r.standard_normal((10, 4)).astype(np.float32)
    ids = r.integers(-1, 10, (6, 5)).astype(np.int32)
    ids[2] = -1                                    # an all-pad bag
    ids[3, :3] = 7                                 # an id repeated
    w = r.standard_normal((6, 4)).astype(np.float32)
    want, jg = jax.value_and_grad(lambda t: jnp.sum(
        jr.embedding_bag(t, jnp.asarray(ids), mode) * w))(jnp.asarray(table))
    tt = _t(table).requires_grad_(True)
    out = tr.embedding_bag(tt, _t(ids), mode)
    np.testing.assert_allclose(
        _np(out), np.asarray(jr.embedding_bag(jnp.asarray(table),
                                              jnp.asarray(ids), mode)), **TOL)
    assert np.all(_np(out)[2] == 0)
    (g,) = torch.autograd.grad(torch.sum(out * _t(w)), tt)
    np.testing.assert_allclose(_np(g), np.asarray(jg), **TOL)


@pytest.mark.parametrize("mode,chunk", [(m, c) for m in ("mean", "sum")
                                        for c in (None, 4)])
def test_embedding_bag_gradient_of_a_repeated_id_matches_jax(
        monkeypatch, mode, chunk):
    """A popular id's gradient rows (about 380 of 512) and the pads' (to
    id 0) summed past segment.CHUNK rows: in chunks, then their sums."""
    if chunk:
        monkeypatch.setattr(tseg, "CHUNK", chunk)
    r = np.random.default_rng(2)
    table = r.standard_normal((10, 4)).astype(np.float32)
    ids = r.integers(-1, 10, (64, 8)).astype(np.int32)
    ids[r.random(ids.shape) < 0.75] = 3
    w = r.standard_normal((64, 4)).astype(np.float32)
    want, jg = jax.value_and_grad(lambda t: jnp.sum(
        jr.embedding_bag(t, jnp.asarray(ids), mode) * w))(jnp.asarray(table))
    tt = _t(table).requires_grad_(True)
    out = tr.embedding_bag(tt, _t(ids), mode)
    assert int((ids == 3).sum()) > tseg.CHUNK
    got = torch.sum(out * _t(w))
    (g,) = torch.autograd.grad(got, tt)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(_np(g), np.asarray(jg), **TOL)


def test_towers_and_scores_match_jax():
    jp, tp = _both()
    b = _batch()
    for name in ("user_tower", "item_tower"):
        ids = b["hist_ids"] if name == "user_tower" else b["item_ids"]
        with torch.no_grad():
            got = getattr(tr, name)(tp, _t(ids))
        np.testing.assert_allclose(
            _np(got), np.asarray(getattr(jr, name)(jp, jnp.asarray(ids))),
            **TOL)
    with torch.no_grad():
        got = tr.score_candidates(tp, _t(b["hist_ids"]), _t(b["item_ids"]))
    np.testing.assert_allclose(
        _np(got), np.asarray(jr.score_candidates(
            jp, jnp.asarray(b["hist_ids"]), jnp.asarray(b["item_ids"]))),
        **TOL)


@pytest.mark.parametrize("logq", [True, False])
def test_recsys_loss_and_every_gradient_match_jax(logq):
    jcfg, tcfg = _cfgs()
    jp, tp = _both()
    b = _batch(B=16)
    if not logq:
        del b["sampling_logq"]
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jr.recsys_loss(p, bb, jcfg)))(
        jp, jax.tree.map(jnp.asarray, b))
    loss = tr.recsys_loss(tp, {k: _t(v) for k, v in b.items()}, tcfg)
    grads = torch.autograd.grad(loss, pytree.leaves(tp))
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    _assert_tree_close(pytree.unflatten(tp, grads), jgrads, what="grads")


def _tied_params():
    """Every item's tower output the same unit vector (the last layer's
    weights zero, its bias one-hot), so every candidate's score ties bit
    for bit in both packages."""
    tree = _tree()
    tree["item_mlp"]["w"][-1][:] = 0.0
    tree["item_mlp"]["b"][-1][:] = 0.0
    tree["item_mlp"]["b"][-1][2] = 1.0
    return tree


@pytest.mark.parametrize("k", [1, 10, 57, 200])
def test_topk_stable_breaks_ties_as_jax_top_k(k):
    r = np.random.default_rng(k)
    scores = r.integers(0, 5, 200).astype(np.float32)
    scores[r.random(200) < 0.1] = -np.inf
    jv, ji = jax.lax.top_k(jnp.asarray(scores), k)
    tv, ti = tr.topk_stable(_t(scores), k)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))


@pytest.mark.parametrize("tied", [False, True])
def test_retrieve_topk_matches_jax(tied):
    jp, tp = _both(_tied_params() if tied else None)
    hist = np.array([[1, 2, 3, -1, -1]], np.int32)
    cands = np.random.default_rng(3).permutation(500)[:64].astype(np.int32)
    jv, ji = jr.retrieve_topk(jp, jnp.asarray(hist), jnp.asarray(cands),
                              k=20)
    with torch.no_grad():
        tv, ti = tr.retrieve_topk(tp, _t(hist), _t(cands), k=20)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_allclose(_np(tv), np.asarray(jv), **TOL)
    if tied:                       # all tied: the first 20, in order
        np.testing.assert_array_equal(_np(ti), cands[:20])


def _jax_bundle(shape, over=None):
    mesh = mesh_by_name("host")
    return mesh, j_build_bundle(ARCH, shape, Rules(mesh), reduced=True,
                                overrides=over)


def test_serve_and_retrieval_bundles_match_jax():
    jp, tp = _both()
    b = _batch(B=8)
    mesh, jserve = _jax_bundle("serve_p99", {"batch": 8})
    tserve = tsteps.build_bundle(ARCH, "serve_p99", reduced=True,
                                 overrides={"batch": 8})
    assert tserve.kind == "recsys_serve"
    with use_mesh(mesh):
        want = jax.jit(jserve.step_fn)(jp, jnp.asarray(b["hist_ids"]),
                                       jnp.asarray(b["item_ids"]))
    got = tserve.step_fn(tp, _t(b["hist_ids"]), _t(b["item_ids"]))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)

    over = {"n_candidates": 400}
    mesh, jret = _jax_bundle("retrieval_cand", over)
    tret = tsteps.build_bundle(ARCH, "retrieval_cand", reduced=True,
                               overrides=over)
    (shape, _), = [tret.inputs["cand_ids"]]
    assert shape == (512,)
    cands = np.full(shape, -1, np.int32)
    cands[:400] = np.random.default_rng(4).permutation(500)[:400]
    hist = b["hist_ids"][:1]
    for tied in (False, True):
        jp, tp = _both(_tied_params() if tied else None)
        with use_mesh(mesh):
            jv, ji = jax.jit(jret.step_fn)(jp, jnp.asarray(hist),
                                           jnp.asarray(cands))
        tv, ti = tret.step_fn(tp, _t(hist), _t(cands))
        np.testing.assert_array_equal(_np(ti), np.asarray(ji))
        np.testing.assert_allclose(_np(tv), np.asarray(jv), **TOL)
        assert _np(ti).shape == (100,) and np.all(_np(ti) >= 0)


@pytest.mark.parametrize("step", [0, 7])
def test_interaction_stream_equal(step):
    jcfg, tcfg = _cfgs()
    want = JStream(jcfg, 32, seed=2).batch_at(step)
    got = InteractionStream(tcfg, 32, seed=2).batch_at(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_train_step_matches_jax():
    tree = _tree()
    b = _batch(B=16)
    mesh, jb = _jax_bundle("train_batch", {"batch": 16})
    jp = jax.tree.map(jnp.asarray, tree)
    with use_mesh(mesh):
        jp2, jo, jm = jax.jit(jb.step_fn)(jp, jadamw.adamw_init(jp),
                                          jax.tree.map(jnp.asarray, b))
    bundle = tsteps.build_bundle(ARCH, "train_batch", reduced=True,
                                 overrides={"batch": 16})
    assert bundle.kind == "recsys_train"
    params = tr.recsys_params_from_jax(tree, bundle.cfg, device="cpu")
    p, o, m = bundle.step_fn(params, adamw_init(params),
                             {k: _t(v) for k, v in b.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               **TOL)
    _assert_tree_close(p, jp2, what="params")
    _assert_tree_close(o.m, jo.m, what="m")
    _assert_tree_close(o.v, jo.v, what="v")
    assert int(o.count) == int(jo.count) == 1


def test_run_training_matches_jax(tmp_path):
    from repro.launch.train import run_training as j_run
    over = {"batch": 16}
    want = j_run(ARCH, "train_batch", steps=4,
                 ckpt_dir=str(tmp_path / "jax"), reduced=True, overrides=over)
    got = run_training(ARCH, "train_batch", steps=4,
                       ckpt_dir=tmp_path / "port", reduced=True,
                       overrides=over, device="cpu", params=_tree())
    assert [h["step"] for h in got["history"]] == [0, 1, 2, 3]
    for g, w in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-5)
