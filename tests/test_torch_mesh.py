"""The substrate's ``shard_map`` programs on a layout of device slots,
against the JAX package.

The port runs each program over CPU slots (``["cpu"] * n``); the JAX side
runs the same program under ``jax.shard_map`` over fake CPU devices, in
one subprocess for the whole module (the device-count flag must be set
before JAX starts, as in ``tests/test_distributed.py``). Inputs are drawn
with numpy from fixed seeds and handed to both through an ``.npz`` file.

* ``make_host_mesh(data, model)``: the slot order of ``jax.make_mesh``;
  ``Rules.shard`` cuts the blocks ``jax.device_put`` places on each device
  under the same logical axes, and ``Rules.assemble`` puts them back.
* ``flash_decode``: REDUCED granite-8b's ``decode_step`` with
  ``RunOptions(flash_decode=True)`` on (2, 4) and (1, 4) layouts, over a
  float32 and a float8 cache pre-filled at positions 0..4, six steps from
  position 5 (slots 1..3, then 2..3, hold no valid key: one step crosses a
  slot's boundary), against the JAX ``decode_step(flash_decode=True)`` at
  2e-3 (``tests/test_distributed.py``'s bound), and against the port's own
  one-slot decode over the same cache (``ONE_SLOT_TOL``,
  ``ONE_SLOT_F8_REL_L2``).
* ``gnn.ring_aggregate`` on 8 and 3 slots against the JAX ring on 8 and 3
  devices, with and without a ``msg_fn``: normal features at atol 1e-5
  (the JAX test's), integer-valued features exactly, and those equal to
  a one-shot ``models/segment.py`` sum too.
* ``ef_compressed_psum_axis`` over an 8-slot ``pod`` axis against the JAX
  ``ef_compressed_psum`` under ``shard_map`` over 8 devices, 20 steps,
  each from the error state the JAX chain carried: the summed codes
  exactly, the reduced gradient and each member's error within 1e-6 of
  the largest gradient so far (XLA may take the scale as a product with
  1/127 and fuses the residual's product and difference); over the
  port's own chain the sequence form equal bit for bit, and the error
  feedback's invariant.

Unit cases: every collective on one device equals the same reduction
over a Python list; an empty slot's attention partial is zeros and an
lse of -inf; a layout that mixes device types, or a model on another type
than its layout, raises.
"""
import functools
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.config import RunOptions  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    F8, attention_partial)
from repro_torch.launch import collectives  # noqa: E402
from repro_torch.launch.mesh import (Layout, make_cells_mesh,  # noqa: E402
                                     make_host_mesh)
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.gnn import ring_aggregate  # noqa: E402
from repro_torch.models.segment import Segments  # noqa: E402
from repro_torch.models.sharding import Rules  # noqa: E402
from repro_torch.optim.compress import (_scale,  # noqa: E402
                                        ef_compressed_psum,
                                        ef_compressed_psum_axis)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-8b"
# (name, (data, model), batch, cache type)
DECODE_CASES = (("2x4_f32", (2, 4), 4, "f32"), ("2x4_f8", (2, 4), 4, "f8"),
                ("1x4_f32", (1, 4), 4, "f32"), ("1x4_f8_b1", (1, 4), 1, "f8"))
DECODE_S, DECODE_FILLED, DECODE_STEPS = 32, 5, 6
DECODE_TOL = 2e-3                 # tests/test_distributed.py's bound
# the port's own one-slot decode over the same cache: float32 sums in
# another order, atol = rtol = 1e-5; over float8, p is rounded to bf16
# against each slot's row max instead of the whole row's, and a later
# layer's keys and values, a rounding apart, can land on neighbouring e4m3
# values (2**-3 apart relative): a row's relative L2 within 2e-2
ONE_SLOT_TOL = 1e-5
ONE_SLOT_F8_REL_L2 = 2e-2
MESH_SHAPES = ((2, 4), (1, 8), (8, 1), (4, 2))
SHARD_SPECS = (("batch", "seq_kv", None), (None, "seq_kv_wide", None),
               (None, "tensor", None), ("cells", None, None))
RING_P = (8, 3)
RING_N_LOC, RING_F, RING_EB, RING_E = 16, 5, 40, 500
EF_STEPS, EF_N = 20, 1000

JAX_SIDE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, "src")
from repro import configs as cr
from repro.config import RunOptions
from repro.models import transformer
from repro.models.gnn import ring_aggregate
from repro.models.sharding import Rules
from repro.optim.compress import ef_compressed_psum

inp = dict(np.load(sys.argv[1]))
out = {}
AUTO = jax.sharding.AxisType.Auto


def mesh(shape, names):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, names, axis_types=(AUTO,) * len(shape),
                         devices=jax.devices()[:n])


for shape in MESH_SHAPES:
    m = mesh(shape, ("data", "model"))
    out[f"order_{shape[0]}x{shape[1]}"] = np.vectorize(
        lambda d: d.id)(m.devices)

m = mesh((2, 4), ("data", "model"))
rules = Rules(m)
x = inp["shard_x"]
for i, spec in enumerate(SHARD_SPECS):
    arr = jax.device_put(x, rules.sharding(*spec))
    starts = np.zeros((8, x.ndim), np.int64)
    for sh in arr.addressable_shards:
        starts[sh.device.id] = [s.start or 0 for s in sh.index]
    out[f"shard_{i}"] = starts

cfg = cr.get("granite-8b").REDUCED
params = transformer.init_lm_params(jax.random.PRNGKey(0), cfg, tp=1)
for name, shape, B, kv in DECODE_CASES:
    m = mesh(shape, ("data", "model"))
    rules = Rules(m)
    opts = RunOptions(flash_decode=True, attn_chunk=8, seq_parallel=False)
    dt = jnp.float8_e4m3fn if kv == "f8" else jnp.float32
    cache = transformer.init_cache(cfg, B, DECODE_S, dtype=dt)
    k0 = inp[f"{name}_k0"]
    cache["k"] = cache["k"].at[:, :, :DECODE_FILLED].set(k0.astype(dt))
    cache["v"] = cache["v"].at[:, :, :DECODE_FILLED].set(
        (k0 * 0.5).astype(dt))
    cache["pos"] = jnp.int32(DECODE_FILLED)
    spec = jax.tree.map(
        lambda ax: rules.sharding(*ax) if isinstance(ax, tuple)
        else rules.sharding(), transformer.cache_logical(B == 1),
        is_leaf=lambda x: isinstance(x, tuple))
    cache = jax.device_put(cache, spec)
    constrain = lambda x, axes: jax.lax.with_sharding_constraint(
        x, rules.sharding(*axes))
    toks = inp[f"{name}_tokens"]
    with jax.set_mesh(m):
        step = jax.jit(lambda p, t, c: transformer.decode_step(
            p, t, c, cfg, opts, constrain))
        got = []
        for t in range(DECODE_STEPS):
            logits, cache = step(params, jnp.asarray(toks[:, t:t + 1]),
                                 cache)
            got.append(np.asarray(logits))
    out[f"{name}_logits"] = np.concatenate(got, axis=1)


def j_msg(src_h, ed):
    return jnp.concatenate(
        [src_h * 2.0, ed[:, None] + src_h.sum(-1, keepdims=True)], -1)


for Pd in RING_P:
    m = mesh((Pd,), ("cells",))
    for msg in (False, True):
        fn = jax.jit(jax.shard_map(
            lambda hh, a, b, c: ring_aggregate(
                hh, a[0], b[0], c[0], "cells", msg_fn=j_msg if msg else None),
            mesh=m, in_specs=(P("cells"),) * 4, out_specs=P("cells"),
            check_vma=False))
        for feat in ("normal", "int"):
            got = fn(inp[f"ring{Pd}_h_{feat}"], inp[f"ring{Pd}_es"],
                     inp[f"ring{Pd}_ed"], inp[f"ring{Pd}_em"])
            out[f"ring{Pd}_{int(msg)}_{feat}"] = np.asarray(got)

m = mesh((8,), ("pod",))
fn = jax.jit(jax.shard_map(
    lambda g, e: tuple(x[None] for x in ef_compressed_psum(g[0], e[0], "pod")),
    mesh=m, in_specs=(P("pod"), P("pod")), out_specs=(P("pod"), P("pod"))))
err = jnp.zeros((8, EF_N), jnp.float32)
reduced, errors = [], []
for t in range(EF_STEPS):
    red, err = fn(jnp.asarray(inp["ef_grads"][t]), err)
    reduced.append(np.asarray(red))
    errors.append(np.asarray(err))
out["ef_reduced"], out["ef_errors"] = np.stack(reduced), np.stack(errors)
np.savez(sys.argv[2], **out)
"""


def _ring_inputs(rng, P: int) -> dict:
    """The JAX test's ring inputs over P blocks: features, edges bucketed
    by (destination owner, source owner), Eb the bucket width (edges past
    a full bucket dropped), and the dense sum of the kept edges."""
    N = P * RING_N_LOC
    h = rng.standard_normal((N, RING_F)).astype(np.float32)
    h_int = rng.integers(-8, 9, (N, RING_F)).astype(np.float32)
    src = rng.integers(0, N, RING_E)
    dst = rng.integers(0, N, RING_E)
    es = np.zeros((P, P, RING_EB), np.int32)
    ed = np.zeros((P, P, RING_EB), np.int32)
    em = np.zeros((P, P, RING_EB), bool)
    fill = np.zeros((P, P), int)
    kept = []
    for s, d in zip(src, dst):
        po, so = d // RING_N_LOC, s // RING_N_LOC
        i = fill[po, so]
        if i >= RING_EB:
            continue
        es[po, so, i] = s % RING_N_LOC
        ed[po, so, i] = d % RING_N_LOC
        em[po, so, i] = True
        fill[po, so] += 1
        kept.append((s, d))
    kept = np.array(kept)
    return {f"ring{P}_h_normal": h, f"ring{P}_h_int": h_int,
            f"ring{P}_es": es, f"ring{P}_ed": ed, f"ring{P}_em": em,
            f"ring{P}_kept": kept}


def _inputs() -> dict:
    rng = np.random.default_rng(29)
    cfg = j_configs.get(ARCH).REDUCED
    out = {"shard_x": np.arange(8 * 16 * 4, dtype=np.float32).reshape(
        8, 16, 4)}
    for name, _, B, _ in DECODE_CASES:
        out[f"{name}_k0"] = rng.standard_normal(
            (cfg.n_layers, B, DECODE_FILLED, cfg.n_kv_heads, cfg.hd)
        ).astype(np.float32)
        out[f"{name}_tokens"] = rng.integers(
            0, cfg.vocab, (B, DECODE_STEPS)).astype(np.int32)
    for P in RING_P:
        out.update(_ring_inputs(rng, P))
    out["ef_grads"] = np.stack([
        rng.standard_normal((8, EF_N)).astype(np.float32) * 10 ** (t % 3)
        for t in range(EF_STEPS)])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(inputs, JAX outputs)``: one subprocess over 8 fake devices."""
    d = tmp_path_factory.mktemp("mesh")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    consts = "".join(f"{k} = {globals()[k]!r}\n" for k in (
        "MESH_SHAPES", "SHARD_SPECS", "DECODE_CASES", "DECODE_S",
        "DECODE_FILLED", "DECODE_STEPS", "RING_P", "EF_STEPS", "EF_N"))
    code = textwrap.dedent(JAX_SIDE).replace(
        "inp = dict(", consts + "inp = dict(", 1)
    res = subprocess.run(
        [sys.executable, "-c", code, str(d / "in.npz"), str(d / "out.npz")],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT),
        env={"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
             "JAX_PLATFORMS": "cpu", "PYTHONPATH": "src",
             "PATH": "/usr/bin:/bin:/usr/local/bin"})
    assert res.returncode == 0, res.stderr[-3000:]
    return inp, dict(np.load(d / "out.npz"))


def _cpu(shape) -> Layout:
    return make_host_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


# ----------------------------------------------------------------------
# layouts, rules, collectives
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_host_mesh_slot_order_matches_jax(runs, shape):
    layout = _cpu(shape)
    order = runs[1][f"order_{shape[0]}x{shape[1]}"]
    assert layout.shape == tuple(order.shape)
    assert layout.axis_names == ("data", "model")
    for s in range(layout.size):
        assert order[layout.coords(s)] == s
        assert layout.axis_index(s, "model") == layout.coords(s)[1]
        assert layout.axis_index(s, ("data", "model")) == s
    assert layout.groups("model") == [
        list(range(r * shape[1], (r + 1) * shape[1]))
        for r in range(shape[0])]


@pytest.mark.parametrize("i", range(len(SHARD_SPECS)))
def test_rules_shard_matches_jax_and_assembles(runs, i):
    inp, out = runs
    spec = SHARD_SPECS[i]
    rules = Rules(_cpu((2, 4)))
    x = torch.from_numpy(inp["shard_x"])
    pieces = rules.shard(x, *spec)
    local = rules.local_shape(tuple(x.shape), *spec)
    for s, p in enumerate(pieces):
        idx = tuple(slice(a, a + n) for a, n in zip(out[f"shard_{i}"][s],
                                                    local))
        assert tuple(p.shape) == local
        assert torch.equal(p, x[idx])
        assert p.untyped_storage().data_ptr() == \
            x.untyped_storage().data_ptr()          # a view, no copy
    assert torch.equal(rules.assemble(pieces, *spec), x)


@pytest.mark.parametrize("op", ["psum", "pmax", "all_gather", "ppermute"])
@pytest.mark.parametrize("axes", ["model", "data", ("data", "model")])
def test_collectives_equal_list_reductions(op, axes):
    layout = _cpu((2, 4))
    gen = torch.Generator().manual_seed(3)
    xs = [torch.randn(6, 5, generator=gen) for _ in range(layout.size)]
    fold = {"psum": torch.add, "pmax": torch.maximum}
    for g in layout.groups(axes):
        members = [xs[s] for s in g]
        if op in fold:
            got = getattr(collectives, op)(xs, layout, axes)
            want = functools.reduce(fold[op], members)
            assert all(torch.equal(got[s], want) for s in g)
        elif op == "all_gather":
            got = collectives.all_gather(xs, layout, axes, dim=1)
            assert all(torch.equal(got[s], torch.cat(members, 1))
                       for s in g)
        else:
            n = len(g)
            got = collectives.ppermute(xs, layout, axes,
                                       [(j, (j + 1) % n) for j in range(n)])
            for j, s in enumerate(g):
                assert torch.equal(got[s], members[(j - 1) % n])
                assert got[s].data_ptr() != members[(j - 1) % n].data_ptr()


def test_layout_and_model_errors():
    with pytest.raises(ValueError, match="mixes device types"):
        make_host_mesh(1, 2, devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="4 slots"):
        make_host_mesh(2, 2, devices=["cpu"])
    pod = Layout("pod", ("data", "model"), (16, 16))
    with pytest.raises(ValueError, match="names no devices"):
        pod.device(0)
    layout = _cpu((1, 4))
    with pytest.raises(ValueError, match="permutation"):
        collectives.ppermute([torch.zeros(1)] * 4, layout, "model",
                             [(0, 1), (1, 1)])
    with pytest.raises(ValueError, match="one tensor per slot"):
        collectives.psum([torch.zeros(1)], layout, "model")
    cfg = tt_cfg()
    with pytest.raises(ValueError, match="slots are on"):
        tt.LM(cfg, generator=torch.Generator(), device="cpu",
              mesh=make_host_mesh(1, 2, devices=["cuda:0"] * 2),
              opts=RunOptions(flash_decode=True))
    # a layout without flash_decode: the gathered decode (GSPMD's default)
    # runs, and equals the one-device decode
    model = tt.LM(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 3),
                         generator=torch.Generator().manual_seed(1))
    for sharded in (model.with_mesh(_cpu((1, 2))),
                    tt.LM(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu", mesh=_cpu((1, 2)))):
        assert not sharded.opts.flash_decode and sharded.mesh is not None
        caches = [m.init_cache(2, 4) for m in (model, sharded)]
        for t in range(3):
            want, caches[0] = model.decode_step(toks[:, t:t + 1], caches[0])
            got, caches[1] = sharded.decode_step(toks[:, t:t + 1],
                                                 caches[1])
            torch.testing.assert_close(got, want, atol=ONE_SLOT_TOL,
                                       rtol=ONE_SLOT_TOL)


def tt_cfg():
    from repro_torch.configs import get
    return get(ARCH).REDUCED


# ----------------------------------------------------------------------
# flash_decode
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["f32", "f8"])
def test_empty_slot_partial_is_zero_and_minus_inf(kv):
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(2, 1, 4, 16, generator=gen)
    k = torch.randn(2, 8, 2, 16, generator=gen)
    if kv == "f8":
        k = tt.quantize_f8(k)
    out, lse = attention_partial(q, k, k, 0)
    assert out.dtype == torch.float32 and lse.shape == (2, 4, 1)
    assert torch.equal(out, torch.zeros_like(out))
    assert bool((lse == float("-inf")).all())
    out, lse = attention_partial(q, k, k, 3)
    assert bool(torch.isfinite(out).all() and torch.isfinite(lse).all())


def _port_decode(inp, name, B, kv, mesh):
    """The port's six teacher-forced steps from the pre-filled cache;
    ``mesh`` None: one device, without flash_decode."""
    cfg = tt_cfg()
    tree = jt.init_lm_params(jax.random.PRNGKey(0),
                             j_configs.get(ARCH).REDUCED, tp=1)
    opts = RunOptions(flash_decode=mesh is not None,
                      kv_cache_dtype="f8" if kv == "f8" else "bf16")
    model = tt.params_from_jax(jax.tree.map(np.asarray, tree), cfg,
                               device="cpu", opts=opts)
    if mesh is not None:
        model = model.with_mesh(mesh)
    k0 = torch.from_numpy(inp[f"{name}_k0"])
    full = model.with_mesh(None).init_cache(B, DECODE_S)
    if kv == "f8":
        full["k"][:, :, :DECODE_FILLED] = tt.quantize_f8(k0)
        full["v"][:, :, :DECODE_FILLED] = tt.quantize_f8(k0 * 0.5)
    else:
        full["k"][:, :, :DECODE_FILLED] = k0
        full["v"][:, :, :DECODE_FILLED] = k0 * 0.5
    full["pos"] = DECODE_FILLED
    cache = full if mesh is None else tt.shard_cache(full, model.rules)
    toks = torch.from_numpy(inp[f"{name}_tokens"])
    got = []
    for t in range(DECODE_STEPS):
        logits, cache = model.decode_step(toks[:, t:t + 1], cache)
        got.append(logits)
    return torch.cat(got, 1), full


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in
                                                    DECODE_CASES])
def test_flash_decode_matches_jax(runs, case):
    inp, out = runs
    name, shape, B, kv = case
    got, full = _port_decode(inp, name, B, kv, _cpu(shape))
    want = out[f"{name}_logits"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=DECODE_TOL,
                               rtol=DECODE_TOL)
    # the steps wrote the one-device tensor through the pieces' views
    end = DECODE_FILLED + DECODE_STEPS
    assert bool((full["k"][:, :, DECODE_FILLED:end].float() != 0).any())
    assert bool((full["k"][:, :, end:].float() == 0).all())


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in
                                                    DECODE_CASES])
def test_flash_decode_matches_one_slot(runs, case):
    inp, _ = runs
    name, shape, B, kv = case
    got, sharded = _port_decode(inp, name, B, kv, _cpu(shape))
    want, one = _port_decode(inp, name, B, kv, None)
    if kv == "f32":
        torch.testing.assert_close(got, want, atol=ONE_SLOT_TOL,
                                   rtol=ONE_SLOT_TOL)
    else:
        rel = (got - want).norm(dim=-1) / want.norm(dim=-1)
        assert float(rel.max()) <= ONE_SLOT_F8_REL_L2, float(rel.max())
    # layer 0's keys (no attention upstream) written alike, byte for byte
    assert torch.equal(sharded["k"][0].view(torch.uint8),
                       one["k"][0].view(torch.uint8))


def test_flash_decode_on_one_slot_and_init_cache_pieces():
    """No layout: flash_decode runs as one slot (a (1, 1) JAX mesh), and
    equals the default decode. A layout's ``init_cache`` gives views of
    one tensor per device, cut by ``cache_logical``."""
    cfg = tt_cfg()
    model = tt.LM(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    flash = model.with_mesh(None, RunOptions(flash_decode=True))
    toks = torch.randint(0, cfg.vocab, (2, 5),
                         generator=torch.Generator().manual_seed(1))
    outs = []
    for m in (model, flash):
        cache = m.init_cache(2, 8)
        outs.append(torch.cat([m.decode_step(toks[:, t:t + 1], cache)[0]
                               for t in range(5)], 1))
    torch.testing.assert_close(outs[1], outs[0], atol=1e-6, rtol=1e-6)
    sharded = model.with_mesh(_cpu((2, 2)), RunOptions(flash_decode=True))
    cache = sharded.init_cache(2, 8)
    assert len(cache["k"]) == 4
    assert tuple(cache["k"][3].shape) == (cfg.n_layers, 1, 4,
                                          cfg.n_kv_heads, cfg.hd)
    base = cache["k"][0].untyped_storage().data_ptr()
    assert all(p.untyped_storage().data_ptr() == base for p in cache["k"])
    wide = sharded.init_cache(1, 8)
    assert tuple(wide["k"][1].shape) == (cfg.n_layers, 1, 2,
                                         cfg.n_kv_heads, cfg.hd)
    with pytest.raises(ValueError, match="needs a model with that layout"):
        model.decode_step(toks[:, :1], cache)


# ----------------------------------------------------------------------
# ring_aggregate
# ----------------------------------------------------------------------

def _t_msg(src_h, dst):
    return torch.cat([src_h * 2.0,
                      dst[:, None].to(src_h.dtype)
                      + src_h.sum(-1, keepdim=True)], -1)


@pytest.mark.parametrize("feat", ["normal", "int"])
@pytest.mark.parametrize("msg", [False, True])
@pytest.mark.parametrize("P", RING_P)
def test_ring_aggregate_matches_jax(runs, P, msg, feat):
    inp, out = runs
    layout = make_cells_mesh(devices=["cpu"] * P)
    h = torch.from_numpy(inp[f"ring{P}_h_{feat}"])
    got = ring_aggregate(
        list(h.split(RING_N_LOC)),
        *(torch.from_numpy(inp[f"ring{P}_{x}"]) for x in ("es", "ed", "em")),
        layout, "cells", msg_fn=_t_msg if msg else None)
    assert [tuple(x.shape) for x in got] == [
        (RING_N_LOC, RING_F + int(msg))] * P
    got = torch.cat(got).numpy()
    want = out[f"ring{P}_{int(msg)}_{feat}"]
    if feat == "normal":
        np.testing.assert_allclose(got, want, atol=1e-5)
        return
    np.testing.assert_array_equal(got, want)
    if not msg:       # and the one-shot fixed-order segmented sum
        kept = torch.from_numpy(inp[f"ring{P}_kept"])
        seg = Segments(kept[:, 1], P * RING_N_LOC)
        one = seg.reduce(h.index_select(0, kept[:, 0]).index_select(
            0, seg.perm), "sum")
        np.testing.assert_array_equal(got, one.numpy())


# ----------------------------------------------------------------------
# ef_compressed_psum over an axis
# ----------------------------------------------------------------------

def test_ef_compressed_psum_axis_matches_jax(runs):
    inp, out = runs
    layout = Layout("pods", ("pod",), (8,), ("cpu",) * 8)
    errs = [torch.zeros(EF_N) for _ in range(8)]
    seq_errs = [torch.zeros(EF_N) for _ in range(8)]
    sent = torch.zeros(EF_N, dtype=torch.float64)
    big = 0.0
    for t in range(EF_STEPS):
        grads = list(torch.from_numpy(inp["ef_grads"][t]))
        # the port's own chain: the axis form equals the sequence form
        red, errs = ef_compressed_psum_axis(grads, errs, layout, "pod")
        seq_red, seq_errs = ef_compressed_psum(grads, seq_errs)
        for s in range(8):
            assert torch.equal(red[s], seq_red)
            assert torch.equal(errs[s], seq_errs[s])
        sent += red[0].double()
        # one step from the state the JAX chain carried: the summed codes
        # exactly; XLA may divide by 127 as a product with its reciprocal
        # (a scale an ulp apart) and fuses the residual g - c * s (one
        # rounding, not two), so the floats agree within 1e-6 of the
        # largest gradient so far, as in tests/test_torch_train.py
        prev = list(torch.from_numpy(out["ef_errors"][t - 1])) if t \
            else [torch.zeros(EF_N) for _ in range(8)]
        j_red, j_errs = ef_compressed_psum_axis(grads, prev, layout, "pod")
        scale = max(_scale(g + e) for g, e in zip(grads, prev))
        codes = torch.round(j_red[0] / scale)
        assert torch.equal(codes * scale, j_red[0])
        np.testing.assert_array_equal(
            codes.numpy(), np.round(out["ef_reduced"][t, 0] / scale.numpy()))
        big = max(big, float(np.abs(inp["ef_grads"][t]).max()))
        for got, want in ((torch.stack(j_red), out["ef_reduced"][t]),
                          (torch.stack(j_errs), out["ef_errors"][t])):
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * big,
                                       rtol=0)
    # error feedback: sum sent + sum of final errors = sum of gradients
    total = torch.from_numpy(inp["ef_grads"]).double().sum((0, 1))
    np.testing.assert_allclose(
        (sent + torch.stack(errs).double().sum(0)).numpy(), total.numpy(),
        rtol=1e-4, atol=1e-3)
