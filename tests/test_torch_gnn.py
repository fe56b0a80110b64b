"""The port's GNN zoo against the JAX package's, on the CPU.

The same JAX parameter tree (``init_gnn_params``, carried across by
``gnn_params_from_jax``) and the same numpy batches go through both
packages at the ``REDUCED`` configs of meshgraphnet, graphcast, schnet and
graphsage-reddit, in float32. Held to the JAX package:

* ``_segment``'s sum, mean and max, empty segments and masked (-inf)
  messages included, and their gradients: rtol = atol = 1e-5;
* ``gnn_forward``, ``gnn_loss`` and every gradient for all four kinds,
  with and without edge and node masks (and meshgraphnet under mean and
  max aggregation): rtol = atol = 1e-5;
* ``sample_blocks``, ``flat_batch``, ``sampled_batch`` and
  ``molecule_batch``: equal arrays;
* one train step of each GNN bundle (a full graph, molecules, a sampled
  block) against the JAX bundle's jitted step: loss, grad norm, the
  parameters and the AdamW state at 1e-5;
* ``run_training``'s loss and gradient-norm history over four steps at
  the JAX tests' ``SMOKE_CASES`` overrides: rtol 1e-5;
* the JAX ``test_gnn_permutation_invariance``, on the port.

The port sorts each batch's edges by destination and sums every segment
in that (stable) order; the JAX package scatters in edge order, so the
two differ only in the order of the gradient sums.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcr  # noqa: E402
from repro.core import generators as jgen  # noqa: E402
from repro.data import gnn_data as jdata  # noqa: E402
from repro.launch.mesh import mesh_by_name, use_mesh  # noqa: E402
from repro.launch.steps import build_bundle as j_build_bundle  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
from repro.models import sampler as jsampler  # noqa: E402
from repro.models.sharding import Rules  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs as tcr  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.core import generators as tgen  # noqa: E402
from repro_torch.data import gnn_data as tdata  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models import gnn as tg  # noqa: E402
from repro_torch.models import sampler as tsampler  # noqa: E402
from repro_torch.models import segment as tseg  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
KINDS = ["meshgraphnet", "graphcast", "schnet", "graphsage-reddit"]
# the JAX tests' SMOKE_CASES (tests/test_models.py) of the GNN family
SMOKE = {
    "meshgraphnet": ("full_graph_sm", {"n_nodes": 150, "n_edges": 600,
                                       "d_feat": 9}),
    "schnet": ("molecule", {"batch": 4, "n_nodes": 10, "n_edges": 24}),
    "graphsage-reddit": ("minibatch_lg", {"n_nodes": 2000,
                                          "batch_nodes": 16,
                                          "fanout": (4, 3), "d_feat": 11}),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These models are tiny: torch's thread pool only contends with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _to_torch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in b.items()}


def _jax_tree(cfg, d_in, d_out, seed=0):
    return jax.tree.map(np.asarray, jg.init_gnn_params(
        jax.random.PRNGKey(seed), cfg, d_in=d_in, d_out=d_out))


def _dims(cfg):
    d_out = cfg.extra("n_classes", 41) if cfg.kind == "graphsage" else \
        cfg.extra("d_out", 3)
    return 5, d_out


# ----------------------------------------------------------------------
# _segment
# ----------------------------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_segment_matches_jax(op):
    r = np.random.default_rng(0)
    E, F, n = 40, 3, 15
    msgs = r.standard_normal((E, F)).astype(np.float32)
    msgs[r.random(E) < 0.2] = -np.inf if op == "max" else 0.0
    dst = r.integers(0, 12, E).astype(np.int32)   # segments 12..14 empty
    dst[dst == 5] = 6
    dst[:4] = 5                    # segment 5: (for max) masked rows only
    if op == "max":
        msgs[:4] = -np.inf
    w = r.standard_normal((n, F)).astype(np.float32)
    want, jgrad = jax.jit(jax.value_and_grad(
        lambda m: jnp.sum(jg._segment(m, jnp.asarray(dst), n, op) * w)))(
        jnp.asarray(msgs))
    tm = torch.from_numpy(msgs).requires_grad_(True)
    out = tg._segment(tm, torch.from_numpy(dst), n, op)
    np.testing.assert_allclose(
        _np(out), np.asarray(jg._segment(jnp.asarray(msgs),
                                         jnp.asarray(dst), n, op)), **TOL)
    got = torch.sum(out * torch.from_numpy(w))
    (g,) = torch.autograd.grad(got, tm)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(_np(g), np.asarray(jgrad), **TOL)
    if op == "max":
        assert np.all(_np(out)[12:] == 0) and np.all(_np(out)[5] == 0)


# runs longer than segment.CHUNK rows are summed in chunks, then the
# chunks' sums: at the real CHUNK a run of 700 rows (a hub's in-edges) takes
# two passes, at CHUNK 4 the same run takes five; for max, ties spread over
# several chunks share the gradient equally, as in JAX
LONG = [(op, chunk) for op in ("sum", "mean", "max") for chunk in (None, 4)]


@pytest.mark.parametrize("op,chunk", LONG,
                         ids=[f"{o}-chunk{c or tseg.CHUNK}" for o, c in LONG])
def test_segment_past_chunk_matches_jax(monkeypatch, op, chunk):
    if chunk:
        monkeypatch.setattr(tseg, "CHUNK", chunk)
    r = np.random.default_rng(1)
    E, F, n = 800, 3, 9
    dst = np.concatenate([np.full(700, 2), r.integers(0, 7, E - 700)])
    dst = dst[r.permutation(E)].astype(np.int32)    # segments 7, 8 empty
    msgs = r.standard_normal((E, F)).astype(np.float32)
    hub = np.flatnonzero(dst == 2)
    if op == "max":
        msgs[hub[::150]] = 5.0          # five tied maxima, chunks apart
        msgs[hub[1::7]] = -np.inf
    w = r.standard_normal((n, F)).astype(np.float32)
    want, jgrad = jax.jit(jax.value_and_grad(
        lambda m: jnp.sum(jg._segment(m, jnp.asarray(dst), n, op) * w)))(
        jnp.asarray(msgs))
    tm = torch.from_numpy(msgs).requires_grad_(True)
    out = tg._segment(tm, torch.from_numpy(dst), n, op)
    assert len(tseg.Segments(torch.from_numpy(dst), n)._sorted[3]) == \
        (2 if chunk is None else 5)
    np.testing.assert_allclose(
        _np(out), np.asarray(jg._segment(jnp.asarray(msgs),
                                         jnp.asarray(dst), n, op)), **TOL)
    (g,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), tm)
    np.testing.assert_allclose(_np(g), np.asarray(jgrad), **TOL)
    if op == "max":
        assert np.all(_np(g)[hub[::150]] == w[2] / 5)


# ----------------------------------------------------------------------
# forward, loss and gradients
# ----------------------------------------------------------------------

def _graph_batch(cfg, masked, seed=3, N=20, E=60):
    r = np.random.default_rng(seed)
    d_in, d_out = _dims(cfg)
    b = {"nodes": r.standard_normal((N, d_in)).astype(np.float32),
         "edge_src": r.integers(0, N, E).astype(np.int32),
         "edge_dst": r.integers(0, N, E).astype(np.int32)}
    if masked:
        em = np.ones(E, bool)
        em[r.permutation(E)[:E // 5]] = False
        nm = np.ones(N, bool)
        nm[-3:] = False
        b["edge_mask"], b["node_mask"] = em, nm
    if cfg.kind == "schnet":
        b["edge_rbf"] = tdata.rbf_expand(
            r.random(E).astype(np.float32) * 10, cfg.extra("rbf", 300),
            10.0)
        b["targets"] = r.standard_normal(N).astype(np.float32)
    elif cfg.kind == "graphsage":
        b["labels"] = r.integers(0, d_out, N).astype(np.int32)
    else:
        b["edge_feat"] = r.standard_normal((E, 4)).astype(np.float32)
        b["targets"] = r.standard_normal((N, d_out)).astype(np.float32)
    return b


# the last field: segment.CHUNK for the case (2: every aggregation and
# gather backward summed in chunks, the pads' dropped segment included)
CASES = [(k, m, None, None) for k in KINDS for m in (False, True)] + [
    ("meshgraphnet", True, "mean", None), ("meshgraphnet", True, "max", None),
    ("meshgraphnet", False, "max", None)] + [
    (k, True, None, 2) for k in KINDS] + [("meshgraphnet", True, "max", 2)]


@pytest.mark.parametrize(
    "arch,masked,agg,chunk", CASES,
    ids=[f"{a}-{'masked' if m else 'plain'}-{g or 'cfg'}"
         + (f"-chunk{c}" if c else "") for a, m, g, c in CASES])
def test_forward_loss_and_grads_match_jax(monkeypatch, arch, masked, agg,
                                          chunk):
    if chunk:
        monkeypatch.setattr(tseg, "CHUNK", chunk)
    jcfg, tcfg = jcr.get(arch).REDUCED, tcr.get(arch).REDUCED
    if agg:
        jcfg = dataclasses.replace(jcfg, aggregator=agg)
        tcfg = dataclasses.replace(tcfg, aggregator=agg)
    tree = _jax_tree(jcfg, *_dims(jcfg))
    b = _graph_batch(jcfg, masked)
    jb = jax.tree.map(jnp.asarray, b)
    jp = jax.tree.map(jnp.asarray, tree)
    want_out = jax.jit(lambda p, bb: jg.gnn_forward(p, bb, jcfg))(jp, jb)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, bb: jg.gnn_loss(p, bb, jcfg)))(jp, jb)

    params = tg.gnn_params_from_jax(tree, tcfg, device="cpu")
    tb = _to_torch(b)
    with torch.no_grad():
        out = tg.gnn_forward(params, tb, tcfg)
    np.testing.assert_allclose(_np(out), np.asarray(want_out), **TOL)
    loss = tg.gnn_loss(params, tb, tcfg)
    grads = torch.autograd.grad(loss, pytree.leaves(params),
                                materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **TOL)
    _assert_tree_close(pytree.unflatten(params, grads), want_grads,
                       what=f"{arch} grads")


def test_gnn_permutation_invariance():
    """Relabeling nodes permutes outputs consistently (message passing is
    permutation-equivariant): the JAX test, on the port."""
    cfg = tcr.get("meshgraphnet").REDUCED
    params = tg.init_gnn_params(cfg, 5, 3,
                                generator=torch.Generator().manual_seed(0),
                                device="cpu")
    rng = np.random.default_rng(3)
    N, E = 20, 60
    batch = {"nodes": rng.standard_normal((N, 5)).astype(np.float32),
             "edge_src": rng.integers(0, N, E).astype(np.int32),
             "edge_dst": rng.integers(0, N, E).astype(np.int32),
             "edge_feat": rng.standard_normal((E, 4)).astype(np.float32)}
    with torch.no_grad():
        out = _np(tg.gnn_forward(params, _to_torch(batch), cfg))
    perm = rng.permutation(N)
    inv = np.argsort(perm)
    batch2 = dict(batch)
    batch2["nodes"] = batch["nodes"][perm]
    batch2["edge_src"] = inv[batch["edge_src"]].astype(np.int32)
    batch2["edge_dst"] = inv[batch["edge_dst"]].astype(np.int32)
    with torch.no_grad():
        out2 = _np(tg.gnn_forward(params, _to_torch(batch2), cfg))
    np.testing.assert_allclose(out2, out[perm], atol=1e-4)


def test_molecule_loss_is_the_mean_of_each_molecule():
    """Flattening B molecules into one graph of disjoint parts gives the
    JAX bundle's vmapped per-molecule loss."""
    for arch in ("schnet", "meshgraphnet", "graphsage-reddit"):
        jcfg, tcfg = jcr.get(arch).REDUCED, tcr.get(arch).REDUCED
        d_in, d_out = _dims(jcfg)
        b = jdata.molecule_batch(jcfg, 3, 7, 12, d_in, d_out, seed=2)
        b["edge_mask"][1, :5] = False
        tree = _jax_tree(jcfg, d_in, d_out)
        jp = jax.tree.map(jnp.asarray, tree)
        want = jax.jit(lambda p, mb: jax.vmap(
            lambda bb: jg.gnn_loss(p, bb, jcfg))(mb).mean())(
            jp, jax.tree.map(jnp.asarray, b))
        got = tg.gnn_molecule_loss(
            tg.gnn_params_from_jax(tree, tcfg, device="cpu"), _to_torch(b),
            tcfg)
        np.testing.assert_allclose(float(got.detach()), float(want), **TOL)


@pytest.mark.parametrize("arch", KINDS)
def test_param_tree_and_logical_axes_match_jax(arch):
    """The port's init draws the JAX tree's shapes (stacked blocks, lists
    of MLP weights); its logical axes are the JAX ones (replicated)."""
    jcfg, tcfg = jcr.get(arch).REDUCED, tcr.get(arch).REDUCED
    tree = _jax_tree(jcfg, *_dims(jcfg))
    params = tg.init_gnn_params(tcfg, *_dims(tcfg),
                                generator=torch.Generator().manual_seed(0),
                                device="cpu")
    got, want = pytree.flatten(params), pytree.flatten(tree)
    assert [(p, tuple(x.shape)) for p, x in got] == \
        [(p, x.shape) for p, x in want]
    assert all(isinstance(x, torch.nn.Parameter) and x.dtype == torch.float32
               for _, x in got)
    assert tg.gnn_param_count(tcfg, *_dims(tcfg)) == sum(
        x.size for _, x in want)
    assert pytree.flatten(tg.gnn_param_logical(params)) == pytree.flatten(
        jg.gnn_param_logical(tree))


def test_ring_aggregate_is_refused():
    """Ported now (``tests/test_torch_mesh.py`` holds it on 8 and 3
    slots): on one CPU slot against the JAX ring under ``shard_map`` over
    one device, padded bucket and ``msg_fn`` included."""
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P
    from repro_torch.launch.mesh import make_cells_mesh
    rng = np.random.default_rng(4)
    n, F, Eb, E = 24, 3, 64, 50
    h = rng.standard_normal((n, F)).astype(np.float32)
    es = np.zeros((1, 1, Eb), np.int32)
    ed = np.zeros((1, 1, Eb), np.int32)
    em = np.zeros((1, 1, Eb), bool)
    es[0, 0, :E] = rng.integers(0, n, E)
    ed[0, 0, :E] = rng.integers(0, n, E)
    em[0, 0, :E] = True
    mesh = Mesh(np.array(jax.devices()[:1]), ("cells",))
    for j_msg, t_msg in ((None, None),
                         (lambda x, d: x * 2.0 + d[:, None],
                          lambda x, d: x * 2.0 + d[:, None])):
        fn = jax.shard_map(
            lambda hh, a, b, c: jg.ring_aggregate(hh, a[0], b[0], c[0],
                                                  "cells", msg_fn=j_msg),
            mesh=mesh, in_specs=(P("cells"),) * 4, out_specs=P("cells"),
            check_vma=False)
        want = np.asarray(fn(h, es, ed, em))
        got = tg.ring_aggregate([torch.from_numpy(h)],
                                *map(torch.from_numpy, (es, ed, em)),
                                make_cells_mesh(devices=["cpu"]), "cells",
                                msg_fn=t_msg)
        np.testing.assert_allclose(got[0].numpy(), want, atol=1e-5)


# ----------------------------------------------------------------------
# sampler and batches
# ----------------------------------------------------------------------

def _assert_batches_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@functools.lru_cache(maxsize=None)
def _graphs(n=300, seed=1):
    return jgen.powerlaw(n, 4.0, seed=seed), tgen.powerlaw(n, 4.0, seed=seed)


@pytest.mark.parametrize("caps", [(None, None), (512, 1024)])
def test_sample_blocks_equal(caps):
    jgraph, tgraph = _graphs()
    roots = np.random.default_rng(5).integers(0, jgraph.n, 24)
    want = jsampler.sample_blocks(jgraph, roots, (5, 3),
                                  np.random.default_rng(9), *caps)
    got = tsampler.sample_blocks(tgraph, roots, (5, 3),
                                 np.random.default_rng(9), *caps)
    _assert_batches_equal(dataclasses.asdict(got), dataclasses.asdict(want))


@pytest.mark.parametrize("arch", KINDS)
def test_graph_batches_equal(arch):
    jcfg, tcfg = jcr.get(arch).REDUCED, tcr.get(arch).REDUCED
    jgraph, tgraph = _graphs()
    shape = jcr.get(arch).SHAPES["full_graph_sm"]
    src, dst = tgraph.edges_by_dst
    np.testing.assert_array_equal(src, jgraph.edges_by_dst[0])
    np.testing.assert_array_equal(dst, jgraph.edges_by_dst[1])
    assert src.dtype == dst.dtype == np.int32
    _assert_batches_equal(
        tdata.flat_batch(tcfg, shape, tgraph, 6, 3, seed=4, n_pad=512,
                         e_pad=2048),
        jdata.flat_batch(jcfg, shape, jgraph, 6, 3, seed=4, n_pad=512,
                         e_pad=2048))
    roots = np.random.default_rng(2).integers(0, jgraph.n, 16)
    _assert_batches_equal(
        tdata.sampled_batch(tcfg, tgraph, roots, (4, 3), 6, 3, seed=4,
                            n_pad=512, e_pad=512),
        jdata.sampled_batch(jcfg, jgraph, roots, (4, 3), 6, 3, seed=4,
                            n_pad=512, e_pad=512))
    _assert_batches_equal(
        tdata.molecule_batch(tcfg, 4, 10, 24, 6, 3, seed=4),
        jdata.molecule_batch(jcfg, 4, 10, 24, 6, 3, seed=4))


# ----------------------------------------------------------------------
# the train step and run_training
# ----------------------------------------------------------------------

def _smoke_batch(arch, shape, over, bundle_inputs, step=0):
    """The JAX launcher's batch of ``step`` for a SMOKE case."""
    mod = jcr.get(arch)
    cfg = mod.REDUCED
    sdims = dict(dict(mod.SHAPES[shape].dims), **over)
    kind = mod.SHAPES[shape].kind
    d_in = sdims.get("d_feat", 16)
    d_out = cfg.extra("n_classes", 41) if cfg.kind == "graphsage" else \
        cfg.extra("d_out", 3)
    if kind == "gnn_mol":
        b = jdata.molecule_batch(cfg, sdims["batch"], sdims["n_nodes"],
                                 sdims["n_edges"], d_in, d_out, seed=step)
    else:
        g = jgen.powerlaw(sdims["n_nodes"], 4.0, seed=0)
        n_pad, e_pad = bundle_inputs["nodes"][0][0], \
            bundle_inputs["edge_src"][0][0]
        if kind == "gnn_mini":
            roots = np.random.default_rng(step).integers(
                0, g.n, sdims["batch_nodes"])
            b = jdata.sampled_batch(cfg, g, roots, sdims["fanout"], d_in,
                                    d_out, seed=step, n_pad=n_pad,
                                    e_pad=e_pad)
        else:
            b = jdata.flat_batch(cfg, mod.SHAPES[shape], g, d_in, d_out,
                                 seed=step, n_pad=n_pad, e_pad=e_pad)
    return b, d_in, d_out


@pytest.mark.parametrize("arch", sorted(SMOKE))
def test_train_step_matches_jax(arch):
    shape, over = SMOKE[arch]
    bundle = tsteps.build_bundle(arch, shape, reduced=True, overrides=over)
    assert bundle.kind == jcr.get(arch).SHAPES[shape].kind
    b, d_in, d_out = _smoke_batch(arch, shape, over, bundle.inputs)
    for k, (shp, _) in bundle.inputs.items():
        assert b[k].shape == shp, k
    jcfg = jcr.get(arch).REDUCED
    tree = _jax_tree(jcfg, d_in, d_out)
    mesh = mesh_by_name("host")
    jbundle = j_build_bundle(arch, shape, Rules(mesh), reduced=True,
                             overrides=over)
    jp = jax.tree.map(jnp.asarray, tree)
    with use_mesh(mesh):
        jp2, jo, jm = jax.jit(jbundle.step_fn)(
            jp, jadamw.adamw_init(jp), jax.tree.map(jnp.asarray, b))
    params = tg.gnn_params_from_jax(tree, bundle.cfg, device="cpu")
    p, o, m = bundle.step_fn(params, adamw_init(params), _to_torch(b))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               **TOL)
    _assert_tree_close(p, jp2, what="params")
    _assert_tree_close(o.m, jo.m, what="m")
    _assert_tree_close(o.v, jo.v, what="v")
    assert int(o.count) == int(jo.count) == 1


@pytest.mark.parametrize("arch", sorted(SMOKE))
def test_run_training_matches_jax(tmp_path, arch):
    from repro.launch.train import run_training as j_run
    shape, over = SMOKE[arch]
    want = j_run(arch, shape, steps=4, ckpt_dir=str(tmp_path / "jax"),
                 reduced=True, overrides=over)
    bundle = tsteps.build_bundle(arch, shape, reduced=True, overrides=over)
    _, d_in, d_out = _smoke_batch(arch, shape, over, bundle.inputs)
    got = run_training(arch, shape, steps=4, ckpt_dir=tmp_path / "port",
                       reduced=True, overrides=over, device="cpu",
                       params=_jax_tree(jcr.get(arch).REDUCED, d_in, d_out))
    assert [h["step"] for h in got["history"]] == [0, 1, 2, 3]
    for g, w in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-5)
