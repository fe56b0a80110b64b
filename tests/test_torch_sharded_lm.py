"""The port's sharded LM serving against the JAX package's GSPMD bundles.

The JAX side builds ``build_bundle(arch, shape, Rules(mesh), opts,
reduced=True)`` and jits its step with the bundle's ``in_shardings`` and
``out_shardings`` over eight fake CPU devices, in one subprocess for the
module (the device-count flag must be set before JAX starts, as in
``tests/test_torch_mesh.py``). The port runs ``LM(..., mesh=layout)`` over
CPU slots (``make_host_mesh(d, m, devices=["cpu"] * n)``) with the same
weights: the JAX ``init_lm_params(rng, cfg, tp)`` tree, its q heads padded
for the tensor axis, carried by ``params_from_jax``. Inputs are drawn with
numpy from a fixed seed and handed to both through an ``.npz`` file.

Cases, on the ``REDUCED`` configs: granite-8b on (2, 4), (1, 4) and
(4, 2); qwen2.5-14b on (2, 4) (QKV bias; 5 q heads padded to 8 over one KV
head); olmoe-1b-7b on (2, 4) (8 experts over 4 slots, the dispatch in 2
groups). Each case runs prefill at S = 32 (``seq_parallel`` on) and S = 24
(off) under ``serve_param_sharding`` ``"2d"`` and ``"tp_only"``, and four
teacher-forced decode steps from a cache pre-filled at positions 0..5 (the
steps cross a slot's block of the sequence) at batch 2 (4 on (4, 2),
whose data axis does not divide 2) and at batch 1 (the ``seq_kv_wide``
cache), with and without ``flash_decode``. The JAX ``flash_decode``
``shard_map`` cuts the batch over ``data``, so at batch 1 on a data axis of
2 or 4 it refuses the shape: there the port's ``flash_decode`` is held to
the JAX gathered decode, the same function. Tolerance: float32 at atol =
rtol = 1e-4 (``tests/test_torch_transformer.py``'s ``TOL``).

Also: the sharded port against the one-device port at 1e-5 (float32 sums
over the tensor axis in another order); ``seq_parallel`` equal to the
unsplit residual stream bit for bit; the MoE routing on every slot equal
to the one-device routing and to ``jax.lax.top_k`` exactly;
``shard_tree`` then ``assemble_tree`` giving the tree back exactly, the
pieces views of it; a tree whose q heads do not split over the tensor
axis raising; a slot whose q heads straddle two GQA groups; ``reduce_scatter`` and the per-slot ``all_gather`` against
list folds; the serving bundles over a layout, a train bundle refusing
one; and the gathered decode over a float8 cache against the one-device
float8 decode.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jcr  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs as tcr  # noqa: E402
from repro_torch.config import RunOptions  # noqa: E402
from repro_torch.launch import collectives  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.sharding import (Rules, assemble_tree,  # noqa: E402
                                         serve_logical, shard_tree)

ROOT = Path(__file__).resolve().parents[1]
# (name, arch, (data, model), decode batch)
CASES = (("granite_2x4", "granite-8b", (2, 4), 2),
         ("granite_1x4", "granite-8b", (1, 4), 2),
         ("granite_4x2", "granite-8b", (4, 2), 4),
         ("qwen_2x4", "qwen2.5-14b", (2, 4), 2),
         ("olmoe_2x4", "olmoe-1b-7b", (2, 4), 2))
IDS = [c[0] for c in CASES]
MODES = ("2d", "tp_only")
PREFILL_B, PREFILL_S = 4, (32, 24)
CACHE_S, FILLED, STEPS = 16, 6, 4
TOL = dict(atol=1e-4, rtol=1e-4)          # against the JAX bundles
ONE_DEVICE_TOL = dict(atol=1e-5, rtol=1e-5)
# the float8 gathered decode against the one-device one: a later layer's
# keys and values, a rounding apart, can land on neighbouring e4m3 values
# (tests/test_torch_mesh.py's ONE_SLOT_F8_REL_L2)
F8_REL_L2 = 2e-2

JAX_SIDE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
sys.path.insert(0, "src")
from repro import configs as cr
from repro.config import RunOptions
from repro.launch.steps import build_bundle
from repro.models import transformer
from repro.models.sharding import Rules

inp = dict(np.load(sys.argv[1]))
out = {}
AUTO = jax.sharding.AxisType.Auto


def mesh(shape):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AUTO,) * 2,
                         devices=jax.devices()[:n])


for name, arch, shape, B0 in CASES:
    cfg = cr.get(arch).REDUCED
    m = mesh(shape)
    rules = Rules(m)
    params = transformer.init_lm_params(jax.random.PRNGKey(0), cfg,
                                        tp=shape[1])
    for mode in MODES:
        for S in PREFILL_S:
            b = build_bundle(arch, "prefill_32k", rules,
                             RunOptions(serve_param_sharding=mode,
                                        attn_chunk=8), reduced=True,
                             overrides={"seq_len": S,
                                        "global_batch": PREFILL_B})
            with jax.set_mesh(m):
                fn = jax.jit(b.step_fn, in_shardings=b.in_shardings,
                             out_shardings=b.out_shardings)
                got = fn(params, jnp.asarray(inp["tokens"][:, :S]))
            out[f"{name}_{mode}_prefill{S}"] = np.asarray(got)
    for B in (B0, 1):
        for flash in (False, True):
            if flash and B == 1 and shape[0] > 1:
                continue    # the JAX shard_map cuts batch 1 over data
            b = build_bundle(arch, "decode_32k", rules,
                             RunOptions(flash_decode=flash, attn_chunk=8),
                             reduced=True,
                             overrides={"seq_len": CACHE_S,
                                        "global_batch": B})
            cache = transformer.init_cache(cfg, B, CACHE_S,
                                           dtype=jnp.float32)
            k0 = inp[f"{name}_b{B}_k0"]
            cache["k"] = cache["k"].at[:, :, :FILLED].set(k0)
            cache["v"] = cache["v"].at[:, :, :FILLED].set(k0 * 0.5)
            cache["pos"] = jnp.int32(FILLED)
            toks = inp[f"{name}_b{B}_tokens"]
            got = []
            with jax.set_mesh(m):
                fn = jax.jit(b.step_fn, in_shardings=b.in_shardings,
                             out_shardings=b.out_shardings)
                for t in range(STEPS):
                    logits, cache = fn(params, jnp.asarray(toks[:, t:t + 1]),
                                       cache)
                    got.append(np.asarray(logits))
            out[f"{name}_b{B}_flash{int(flash)}"] = np.concatenate(got, 1)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models: torch's thread pool only contends with the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs() -> dict:
    rng = np.random.default_rng(30)
    out = {"tokens": rng.integers(0, 256, (PREFILL_B, max(PREFILL_S)))
           .astype(np.int32)}
    for name, arch, _, B0 in CASES:
        cfg = jcr.get(arch).REDUCED
        for B in (B0, 1):
            out[f"{name}_b{B}_k0"] = rng.standard_normal(
                (cfg.n_layers, B, FILLED, cfg.n_kv_heads, cfg.hd)
            ).astype(np.float32)
            out[f"{name}_b{B}_tokens"] = rng.integers(
                0, cfg.vocab, (B, STEPS)).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(inputs, JAX outputs)``: one subprocess over 8 fake devices."""
    d = tmp_path_factory.mktemp("sharded_lm")
    np.savez(d / "in.npz", **_inputs())
    consts = "".join(f"{k} = {globals()[k]!r}\n" for k in (
        "CASES", "MODES", "PREFILL_B", "PREFILL_S", "CACHE_S", "FILLED",
        "STEPS"))
    code = textwrap.dedent(JAX_SIDE).replace(
        "inp = dict(", consts + "inp = dict(", 1)
    res = subprocess.run(
        [sys.executable, "-c", code, str(d / "in.npz"), str(d / "out.npz")],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT),
        env={"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
             "JAX_PLATFORMS": "cpu", "PYTHONPATH": "src",
             "PATH": "/usr/bin:/bin:/usr/local/bin"})
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(d / "in.npz")), dict(np.load(d / "out.npz"))


def _cpu(shape):
    return make_host_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


def _tree(arch: str, tp: int) -> dict:
    cfg = jcr.get(arch).REDUCED
    return jax.tree.map(np.asarray,
                        jt.init_lm_params(jax.random.PRNGKey(0), cfg, tp=tp))


def _case(name: str):
    return next(c for c in CASES if c[0] == name)


def _model(name: str, opts: RunOptions, mesh=True):
    _, arch, shape, _ = _case(name)
    return tt.params_from_jax(_tree(arch, shape[1]), tcr.get(arch).REDUCED,
                              device="cpu", opts=opts,
                              mesh=_cpu(shape) if mesh else None)


def _decode(model, inp, name: str, B: int):
    """Four teacher-forced steps from the pre-filled cache: the logits
    (B, STEPS, vocab) and the one-device cache the pieces view."""
    one = model.with_mesh(None)
    full = one.init_cache(B, CACHE_S)
    k0 = torch.from_numpy(inp[f"{name}_b{B}_k0"])
    full["k"][:, :, :FILLED] = k0.to(full["k"].dtype)
    full["v"][:, :, :FILLED] = (k0 * 0.5).to(full["v"].dtype)
    full["pos"] = FILLED
    cache = full if model.rules is None else tt.shard_cache(full,
                                                            model.rules)
    toks = torch.from_numpy(inp[f"{name}_b{B}_tokens"])
    got = []
    for t in range(STEPS):
        logits, cache = model.decode_step(toks[:, t:t + 1], cache)
        got.append(logits)
    return torch.cat(got, 1), full


# ----------------------------------------------------------------------
# against the JAX bundles
# ----------------------------------------------------------------------

@pytest.mark.parametrize("S", PREFILL_S)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", IDS)
def test_prefill_matches_jax(runs, name, mode, S):
    inp, out = runs
    model = _model(name, RunOptions(serve_param_sharding=mode))
    got = model.prefill(torch.from_numpy(inp["tokens"][:, :S]))
    want = out[f"{name}_{mode}_prefill{S}"]
    assert tuple(got.shape) == want.shape == (PREFILL_B, 1,
                                              model.cfg.vocab)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("name", IDS)
def test_decode_matches_jax(runs, name, wide, flash):
    inp, out = runs
    B = 1 if wide else _case(name)[3]
    model = _model(name, RunOptions(flash_decode=flash))
    got, full = _decode(model, inp, name, B)
    key = f"{name}_b{B}_flash{int(flash)}"
    want = out.get(key, out[f"{name}_b{B}_flash0"])
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the steps wrote the one-device cache through the pieces' views
    end = FILLED + STEPS
    assert bool((full["k"][:, :, FILLED:end] != 0).any())
    assert bool((full["k"][:, :, end:] == 0).all())


# ----------------------------------------------------------------------
# against the one-device port
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", IDS)
def test_sharded_matches_one_device(runs, name):
    inp, _ = runs
    B = _case(name)[3]
    for flash in (False, True):
        sharded = _model(name, RunOptions(flash_decode=flash))
        one = sharded.with_mesh(None)
        toks = torch.from_numpy(inp["tokens"])
        torch.testing.assert_close(sharded.prefill(toks), one.prefill(toks),
                                   **ONE_DEVICE_TOL)
        torch.testing.assert_close(sharded(toks), one(toks),
                                   **ONE_DEVICE_TOL)
        for b in (B, 1):
            torch.testing.assert_close(_decode(sharded, inp, name, b)[0],
                                       _decode(one, inp, name, b)[0],
                                       **ONE_DEVICE_TOL)


@pytest.mark.parametrize("name", IDS)
def test_seq_parallel_equals_unsplit_stream(runs, name):
    inp, _ = runs
    toks = torch.from_numpy(inp["tokens"])
    sp = _model(name, RunOptions(seq_parallel=True))
    flat = sp.with_mesh(sp.mesh, RunOptions(seq_parallel=False))
    assert torch.equal(sp.prefill(toks), flat.prefill(toks))
    assert torch.equal(sp(toks), flat(toks))
    # at S = 24 (not a multiple of 16) the stream is not cut at all
    assert torch.equal(sp.prefill(toks[:, :24]), flat.prefill(toks[:, :24]))


@pytest.mark.parametrize("wide", [False, True])
def test_moe_routing_equals_one_device_and_jax(runs, monkeypatch, wide):
    """Every slot's routing of every layer: the slots of a data row agree,
    and their groups together equal the one-device ``moe_route`` at the
    same group count on the same tokens, and ``jax.lax.top_k`` of the JAX
    router's softmax, exactly."""
    inp, _ = runs
    name = "olmoe_2x4"
    model = _model(name, RunOptions())
    assert model.opts.moe_groups == 2          # the data axis's size
    seen = []

    def recording(h, router, cfg, groups):
        r = route(h, router, cfg, groups)
        seen.append((h, router, groups, r))
        return r

    route = tt.moe_route
    monkeypatch.setattr(tt, "moe_route", recording)
    if wide:
        _decode(model, inp, name, 1)
    else:
        model.prefill(torch.from_numpy(inp["tokens"]))
    layout, rules = model.mesh, model.rules
    cfg = model.cfg
    calls = len(seen) // layout.size
    assert calls * layout.size == len(seen) and calls >= cfg.n_layers
    for c in range(calls):
        recs = seen[c * layout.size:(c + 1) * layout.size]
        rows = []
        for g in layout.groups("model"):
            first = recs[g[0]]
            for s in g[1:]:
                assert torch.equal(recs[s][3].eids, first[3].eids)
            rows.append(first)
        # the data rows' tokens in order (one row holding them all at
        # batch 1, where the stream is not cut over data)
        if wide:
            rows = rows[:1]
        h = torch.cat([r[0].reshape(-1, r[0].shape[-1]) for r in rows])
        G = sum(r[3].eids.shape[0] for r in rows)
        eids = torch.cat([r[3].eids for r in rows])
        want = route(h, rows[0][1], cfg, G).eids
        assert torch.equal(eids, want)
        x = h.reshape(G, -1, h.shape[-1]).numpy()
        probs = jax.nn.softmax(x @ rows[0][1].numpy(), axis=-1)
        _, jids = jax.lax.top_k(probs, cfg.moe.top_k)
        np.testing.assert_array_equal(eids.numpy(), np.asarray(jids))


# ----------------------------------------------------------------------
# parameters, rules, collectives
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_shard_tree_then_assemble_tree_is_exact(mode):
    cfg = tcr.get("qwen2.5-14b").REDUCED
    tree = tt.init_lm_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu", tp=4)
    rules = Rules(_cpu((2, 4)))
    logical = serve_logical(tt.lm_param_logical(cfg),
                            RunOptions(serve_param_sharding=mode))
    pieces = shard_tree(rules, tree, logical)
    assert len(pieces) == 8
    back = assemble_tree(rules, pieces, logical)
    for key in ("embed", "final_norm"):
        assert torch.equal(back[key], tree[key])
    for key, t in tree["layers"].items():
        assert torch.equal(back["layers"][key], t)
        for p in pieces:                       # views, no copy
            got = p["layers"][key]
            assert got.untyped_storage().data_ptr() == \
                t.untyped_storage().data_ptr()
    # wq: rows over data under "2d" only, heads over model
    wq = pieces[5]["layers"]["wq"]
    D, cols = cfg.d_model, tree["layers"]["wq"].shape[-1]
    assert tuple(wq.shape) == (cfg.n_layers, D // 2 if mode == "2d" else D,
                               cols // 4)


def test_padded_tree_matches_jax_and_unpadded_tree_raises():
    cfg = tcr.get("qwen2.5-14b").REDUCED
    assert tt.padded_heads(cfg, 4) == jt.padded_heads(
        jcr.get("qwen2.5-14b").REDUCED, 4) == 8
    jtree = _tree("qwen2.5-14b", 4)
    mine = tt.init_lm_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu", tp=4)
    real = cfg.n_heads * cfg.hd
    for key in ("wq", "wo", "bq"):
        assert tuple(mine["layers"][key].shape) == jtree["layers"][key].shape
    assert bool((mine["layers"]["wq"][..., real:] == 0).all())
    assert bool((mine["layers"]["wo"][:, real:] == 0).all())
    assert tt.lm_param_logical(cfg) == jt.lm_param_logical(
        jcr.get("qwen2.5-14b").REDUCED)
    unpadded = _tree("qwen2.5-14b", 1)
    with pytest.raises(ValueError, match="5 q heads do not split over "
                                         "the 4 slots.*tp=4"):
        tt.params_from_jax(unpadded, cfg, device="cpu", mesh=_cpu((2, 4)))
    # a padded tree on one device: the padded heads add nothing to the
    # heads' sum, but regroup GQA, so it is another function; the same as
    # the sharded one
    model = tt.params_from_jax(jtree, cfg, device="cpu")
    assert model.n_heads == 8
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(
        model.with_mesh(_cpu((2, 4))).prefill(toks), model.prefill(toks),
        **ONE_DEVICE_TOL)


def test_heads_straddling_kv_groups_match_one_device():
    """6 q heads over 2 KV heads (groups of 3) on a 3-way tensor axis: a
    slot's 2 heads straddle two groups, so its keys and values are taken
    one a q head; prefill and decode equal the one-device model's."""
    import dataclasses
    cfg = dataclasses.replace(tcr.get("granite-8b").REDUCED, n_heads=6,
                              n_kv_heads=2, head_dim=8, d_ff=96, vocab=255)
    one = tt.LM(cfg, generator=torch.Generator().manual_seed(0),
                device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(5))
    for flash in (False, True):
        sharded = one.with_mesh(_cpu((1, 3)), RunOptions(flash_decode=flash))
        torch.testing.assert_close(sharded.prefill(toks), one.prefill(toks),
                                   **ONE_DEVICE_TOL)
        caches = [m.init_cache(2, 6) for m in (one, sharded)]
        for t in range(5):
            want, caches[0] = one.decode_step(toks[:, t:t + 1], caches[0])
            got, caches[1] = sharded.decode_step(toks[:, t:t + 1],
                                                 caches[1])
            torch.testing.assert_close(got, want, **ONE_DEVICE_TOL)


@pytest.mark.parametrize("axes", ["model", "data", ("data", "model")])
def test_reduce_scatter_and_selected_gather_equal_list_folds(axes):
    layout = _cpu((2, 4))
    gen = torch.Generator().manual_seed(7)
    xs = [torch.randn(3, 8, 5, generator=gen) for _ in range(layout.size)]
    sums = collectives.psum(xs, layout, axes)
    got = collectives.reduce_scatter(xs, layout, axes, dim=1)
    for g in layout.groups(axes):
        n = len(g)
        for i, s in enumerate(g):
            want = sums[s].narrow(1, i * (8 // n), 8 // n)
            assert torch.equal(got[s], want)          # bit for bit
    with pytest.raises(ValueError, match="does not split"):
        collectives.reduce_scatter(xs, layout, axes, dim=2)

    def pick(s, x):
        return x[:, :, s % 5:s % 5 + 1]

    got = collectives.all_gather(xs, layout, axes, dim=-2, select=pick)
    for g in layout.groups(axes):
        for s in g:
            assert torch.equal(got[s], torch.cat([pick(s, xs[j]) for j in g],
                                                 -2))


def test_bundles_over_a_layout():
    layout = _cpu((2, 2))
    opts = RunOptions(flash_decode=False)
    over = {"seq_len": 16, "global_batch": 2}
    pre = tsteps.build_bundle("olmoe-1b-7b", "prefill_32k", opts,
                              reduced=True, overrides=over, mesh=layout)
    dec = tsteps.build_bundle("olmoe-1b-7b", "decode_32k", opts,
                              reduced=True, overrides=over, mesh=layout)
    assert pre.mesh == dec.mesh == layout
    assert pre.opts.moe_groups == 2          # as the JAX _lm_bundle sets it
    cfg = tcr.get("olmoe-1b-7b").REDUCED
    one = tt.LM(cfg, generator=torch.Generator().manual_seed(0),
                device="cpu", opts=RunOptions(moe_groups=2))
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(pre.step_fn(one, toks), one.prefill(toks),
                               **ONE_DEVICE_TOL)
    placed = one.with_mesh(layout, dec.opts)
    cache, ref = placed.init_cache(2, 16), one.init_cache(2, 16)
    for t in range(3):
        got, cache = dec.step_fn(placed, toks[:, t:t + 1], cache)
        want, ref = one.decode_step(toks[:, t:t + 1], ref)
        torch.testing.assert_close(got, want, **ONE_DEVICE_TOL)
    with pytest.raises(NotImplementedError, match="sharded train step"):
        tsteps.build_bundle("granite-8b", "train_4k", RunOptions(),
                            reduced=True, overrides=over, mesh=layout)
    with pytest.raises(NotImplementedError, match="GNN and recsys"):
        tsteps.build_bundle("meshgraphnet", "full_graph_sm", RunOptions(),
                            reduced=True, mesh=layout)


def test_gathered_decode_over_float8_cache(runs):
    inp, _ = runs
    name = "granite_2x4"
    opts = RunOptions(kv_cache_dtype="f8")
    sharded = _model(name, opts)
    got, full = _decode(sharded, inp, name, 2)
    want, one_full = _decode(sharded.with_mesh(None), inp, name, 2)
    assert full["k"].dtype == tt.F8
    rel = (got - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(rel.max()) <= F8_REL_L2, float(rel.max())
    # layer 0's keys (no attention upstream) written alike, byte for byte
    assert torch.equal(full["k"][0].view(torch.uint8),
                       one_full["k"][0].view(torch.uint8))


def test_moe_parts_compose_to_moe_ffn():
    """``moe_ffn`` is ``moe_route``, ``moe_dispatch``, ``moe_experts`` and
    ``moe_combine`` in order; the experts' products taken in blocks and
    concatenated equal the whole products."""
    cfg = tcr.get("olmoe-1b-7b").REDUCED
    gen = torch.Generator().manual_seed(9)
    D, E, Fe = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    lp = {"router": torch.randn(D, E, generator=gen),
          "e_gate": torch.randn(E, D, Fe, generator=gen) / 8,
          "e_up": torch.randn(E, D, Fe, generator=gen) / 8,
          "e_down": torch.randn(E, Fe, D, generator=gen) / 8}
    h = torch.randn(2, 12, D, generator=gen)
    want, _ = tm.moe_ffn(h, lp, cfg, groups=4)
    r = tm.moe_route(h, lp["router"], cfg, 4)
    disp = tm.moe_dispatch(r, cfg)
    blocks = [tm.moe_experts(disp[:, e:e + 2], lp["e_gate"][e:e + 2],
                             lp["e_up"][e:e + 2], lp["e_down"][e:e + 2])
              for e in range(0, E, 2)]
    eo = torch.cat(blocks, 1)
    whole = tm.moe_experts(disp, lp["e_gate"], lp["e_up"], lp["e_down"])
    torch.testing.assert_close(eo, whole, atol=1e-6, rtol=1e-6)
    assert torch.equal(tm.moe_combine(whole, r, cfg.moe.top_k)
                       .reshape(h.shape), want)
