"""The port's engine bundle (``path-engine``) against the JAX package's.

The same numpy-seeded inputs go through the JAX ``_engine_bundle``'s
``engine_superstep`` (jitted, host mesh) and the port's
:class:`~repro_torch.launch.steps.EngineSuperstep` on the CPU, three
supersteps chained (frontier and dist carried, the level-1 paths the same
each time); every output is held equal exactly, and the carried visited
words to ``pack_bits(dist != 127)``. Cases: ``REDUCED`` at the shape's
overrides (4,096 vertices, 16 queries, k 4: W = 1, dist padded inside),
32 queries (W = 1, dist updated in place) and 40 (W = 2, Q not a
multiple of 32). Also the bundle's
``meta`` against the JAX one at ``batch_1b``, the config registry, and
the carry rules (a frontier or dist not made by the step is copied).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jcr  # noqa: E402
from repro.core import generators as jgen  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.steps import build_bundle as j_build_bundle  # noqa: E402
from repro.models.sharding import Rules as JRules  # noqa: E402
from repro_torch import configs as tcr  # noqa: E402
from repro_torch.core.enumerate import prune_table  # noqa: E402
from repro_torch.kernels.msbfs_expand.ops import pack_bits  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402

ARCH, SHAPE = "path-engine", "batch_1b"
SUPERSTEPS = 3
N_PATHS = 3000
CASES = {
    "reduced": dict(n_vertices=4096, n_queries=16, k=4),
    "q32": dict(n_vertices=4096, n_queries=32, k=4),
    "q40": dict(n_vertices=4096, n_queries=40, k=4),
}


def _ell(n, avg_deg, cap, seed, rows):
    """An erdos graph's in-neighbour ELL (pad n) of ``rows`` rows."""
    g = jgen.erdos(n, avg_deg, seed=seed)
    ell = np.full((rows, cap), n, dtype=np.int32)
    ell[:n] = g.ell(cap=cap, reverse=True).idx
    return ell


def _inputs(bundle, cfg, seed=0):
    """Seeded numpy inputs of the superstep (JAX layouts: uint32 words)."""
    d = bundle.dims
    V, Q, k = d["n_vertices"], d["n_queries"], d["k"]
    W = -(-Q // 32)
    Vp = min(V, tsteps.ENGINE_PRUNED_MAX)
    width = (k + 1) // 2 + 1
    rng = np.random.default_rng(seed)
    ell = _ell(V, cfg.avg_degree, cfg.ell_cap, seed, V)
    sources = rng.choice(V, Q, replace=False)
    dist = np.full((V, Q), 127, dtype=np.int8)
    dist[sources, np.arange(Q)] = 0
    frontier = np.zeros((V, W), dtype=np.uint32)
    for q, s in enumerate(sources):
        frontier[s, q // 32] |= np.uint32(1 << (q % 32))
    pruned = _ell(Vp, cfg.avg_degree, cfg.ell_cap, seed + 1, Vp + 1)
    slack = rng.integers(0, k + 1, Vp + 1).astype(np.int8)
    splice = rng.integers(-1, k, Vp + 1).astype(np.int8)
    slack[Vp] = splice[Vp] = -1
    tbl = prune_table(torch.from_numpy(slack), torch.from_numpy(splice))
    paths = np.full((tsteps.ENGINE_OUT_CAP, width), -1, dtype=np.int32)
    u = rng.integers(0, Vp, 4 * N_PATHS)
    v = pruned[u, rng.integers(0, cfg.ell_cap, 4 * N_PATHS)]
    keep = np.flatnonzero(v != Vp)[:N_PATHS]
    paths[:keep.size, 0], paths[:keep.size, 1] = u[keep], v[keep]
    return dict(ell=ell, frontier=frontier, dist=dist, pruned=pruned,
                tbl=tbl.numpy(), paths=paths, count=keep.size)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    over = CASES[request.param]
    jb = j_build_bundle(ARCH, SHAPE, JRules(make_host_mesh()), reduced=True,
                        overrides=over)
    tb = tsteps.build_bundle(ARCH, SHAPE, reduced=True, overrides=over)
    return request.param, jb, tb, _inputs(tb, tcr.get(ARCH).REDUCED)


def test_superstep_chain_equals_jax(case):
    _, jb, tb, x = case
    jstep = jax.jit(jb.step_fn)
    j_fr, j_dist = x["frontier"], x["dist"]
    t_fr = torch.from_numpy(x["frontier"].view(np.int32).copy())
    t_dist = torch.from_numpy(x["dist"].copy())
    fixed_t = (torch.from_numpy(x["pruned"]), torch.from_numpy(x["tbl"]),
               torch.from_numpy(x["paths"]),
               torch.tensor(x["count"], dtype=torch.int64))
    for hop in range(1, SUPERSTEPS + 1):
        j_fr, j_dist, j_verts, j_count = jstep(
            x["ell"], j_fr, j_dist, np.int32(hop), x["pruned"], x["tbl"],
            x["paths"], np.int32(x["count"]))
        t_fr, t_dist, t_verts, t_count = tb.step_fn(
            torch.from_numpy(x["ell"]), t_fr, t_dist, hop, *fixed_t)
        np.testing.assert_array_equal(t_fr.numpy().view(np.uint32),
                                      np.asarray(j_fr))
        np.testing.assert_array_equal(t_dist.numpy(), np.asarray(j_dist))
        np.testing.assert_array_equal(t_verts.numpy(), np.asarray(j_verts))
        assert int(t_count) == int(j_count) > 0
        np.testing.assert_array_equal(
            tb.step_fn.visited.numpy(),
            pack_bits(torch.from_numpy(np.array(j_dist)) != 127).numpy())
    # the BFS reached past the sources, and still has a frontier
    assert (np.asarray(j_dist) == SUPERSTEPS).any()


def test_step_carries_its_own_buffers(case):
    name, _, tb, x = case
    step = tsteps.build_bundle(ARCH, SHAPE, reduced=True,
                               overrides=CASES[name]).step_fn
    fixed = (torch.from_numpy(x["pruned"]), torch.from_numpy(x["tbl"]),
             torch.from_numpy(x["paths"]), torch.tensor(x["count"]))
    ell = torch.from_numpy(x["ell"])
    fr0 = torch.from_numpy(x["frontier"].view(np.int32).copy())
    d0 = torch.from_numpy(x["dist"].copy())
    fr1, d1, _, _ = step(ell, fr0, d0, 1, *fixed)
    V, W = fr1.shape
    # the returned frontier is the [:V] view of a zero-sentinel buffer
    assert fr1._base is not None and fr1._base.shape == (V + 1, W)
    assert not fr1._base[V].any()
    vis1 = step.visited
    fr2, d2, _, _ = step(ell, fr1, d1, 2, *fixed)
    assert step.visited is vis1                 # carried, updated in place
    assert fr2._base is not fr1._base
    padded = d1.shape[1] != 32 * W
    # the padded dist buffer is carried too; a Q = 32W dist is the input
    assert (d2._base is d1._base) if padded else (d2 is d1 is d0)
    # a dist changed since the step wrote it gets its words derived again
    d2[0, 0] = 5
    step(ell, fr2, d2, 3, *fixed)
    assert step.visited is not vis1
    np.testing.assert_array_equal(step.visited.numpy(),
                                  pack_bits(d2 != 127).numpy())
    # derived in row chunks, the words are the same
    assert torch.equal(tsteps.visited_words(d2, chunk=1000),
                       pack_bits(d2 != 127))


def test_frontier_pad_bits_are_cleared():
    over = CASES["q40"]
    tb = tsteps.build_bundle(ARCH, SHAPE, reduced=True, overrides=over)
    x = _inputs(tb, tcr.get(ARCH).REDUCED)
    fr = x["frontier"].copy()
    fr[:, -1] |= np.uint32(0xFFFFFF00)        # bits of queries 40..63
    ell = torch.from_numpy(x["ell"])
    fixed = (torch.from_numpy(x["pruned"]), torch.from_numpy(x["tbl"]),
             torch.from_numpy(x["paths"]), torch.tensor(x["count"]))
    got = tb.step_fn(ell, torch.from_numpy(fr.view(np.int32)),
                     torch.from_numpy(x["dist"].copy()), 1, *fixed)
    want = tsteps.build_bundle(ARCH, SHAPE, reduced=True,
                               overrides=over).step_fn(
        ell, torch.from_numpy(x["frontier"].view(np.int32).copy()),
        torch.from_numpy(x["dist"].copy()), 1, *fixed)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_meta_equals_jax_at_batch_1b():
    jb = j_build_bundle(ARCH, SHAPE, JRules(make_host_mesh()))
    tb = tsteps.build_bundle(ARCH, SHAPE)
    assert tb.meta == jb.meta
    assert tb.kind == "engine_batch" and tb.arch == ARCH
    V, Q = 67_108_864, 512
    assert tb.inputs["ell_idx"] == ((V, 64), torch.int32)
    assert tb.inputs["frontier"] == ((V, 16), torch.int32)
    assert tb.inputs["dist"] == ((V, Q), torch.int8)
    assert tb.inputs["pruned_ell"][0] == (2**22 + 1, 64)
    assert tb.inputs["paths"][0] == (2**20, 4)


def test_path_engine_config_is_ported():
    got, want = tcr.get(ARCH), jcr.get(ARCH)
    assert got.FAMILY == want.FAMILY == "engine"
    for name in ("CONFIG", "REDUCED"):
        assert dataclasses.asdict(getattr(got, name)) == \
            dataclasses.asdict(getattr(want, name))
    assert {k: dataclasses.asdict(v) for k, v in got.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.SHAPES.items()}
    assert ARCH not in tcr.ASSIGNED and tcr.ASSIGNED == jcr.ASSIGNED


def test_launch_audit_pins_the_superstep():
    from repro_torch.analysis import launch_audit
    budgets = json.loads(launch_audit.DEFAULT_BUDGETS_PATH.read_text())
    cuda = budgets["engine_superstep"]["cuda"]
    # one msbfs_step and one fused level (and its memset), no copy to the
    # host inside the superstep
    assert cuda["kernels"] == {"msbfs_step": 1, "level_fused": 1}
    assert cuda["launches"] == 3 and cuda["syncs"] == 0
    entry, = [e for e in launch_audit.MANIFEST
              if e.name == "engine_superstep"]
    assert launch_audit.measure(entry, "torch") == \
        budgets["engine_superstep"]["torch"]
