"""The port's graph deltas against the JAX package's.

The scenarios of the JAX package's ``tests/test_delta.py``, with the same
inputs (made with numpy from fixed seeds) going through both packages:
``GraphDelta`` normalization, the CSR merge of ``apply_delta`` (both
directions, against the JAX merge and a ``from_edges`` rebuild), the ELL
patch of ``update_device_graph`` (incremental, and the rebuild whose caps
never shrink), ``host_set_dist``, the set-seeded ``msbfs_set_dist_ell``
(plain arm, against the JAX ELL sweep under the Pallas interpreter and its
segment sweep), the keys ``invalidate_delta`` evicts and keeps, and a
sequence of far, near, no-op, wide and cap-crossing deltas through the
engine under both ``delta_backend`` values, whose reports (less the
wall time) and following path rows must equal the JAX engine's and the
brute-force oracle's. Every comparison is exact equality: integers and
booleans throughout.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import generators as j_gen  # noqa: E402
from repro.core.cache import SharedPathCache as JCache  # noqa: E402
from repro.core.delta import GraphDelta as JGraphDelta  # noqa: E402
from repro.core.delta import apply_delta as j_apply_delta  # noqa: E402
from repro.core.delta import host_set_dist as j_host_set_dist  # noqa: E402
from repro.core.delta import (  # noqa: E402
    update_device_graph as j_update_device_graph)
from repro.core.engine import BatchPathEngine as JEngine  # noqa: E402
from repro.core.engine import EngineConfig as JConfig  # noqa: E402
from repro.core.graph import DeviceGraph as JDeviceGraph  # noqa: E402
from repro.core.graph import Graph as JGraph  # noqa: E402
from repro.core.msbfs import msbfs_set_dist as j_msbfs_set_dist  # noqa: E402
from repro.core.msbfs import (  # noqa: E402
    msbfs_set_dist_ell as j_msbfs_set_dist_ell)
from repro.core.pathset import PathSet as JPathSet  # noqa: E402
from repro_torch.core import (AppliedDelta, BatchPathEngine,  # noqa: E402
                              DeviceGraph, EngineConfig, Graph, GraphDelta,
                              PathSession, SharedPathCache, apply_delta,
                              host_set_dist, oracle, update_device_graph)
from repro_torch.core.msbfs import msbfs_set_dist_ell  # noqa: E402
from repro_torch.core.pathset import PathSet  # noqa: E402

CPU = "cpu"


def _carry(jg):
    return Graph.from_arrays(jg.n, jg.indptr, jg.indices, jg.r_indptr,
                             jg.r_indices)


def _edge_list(g):
    return np.repeat(np.arange(g.n), np.diff(g.indptr)), \
        g.indices.astype(np.int64)


def _random_pairs(g, rng, n_add=6, n_del=6):
    """A messy delta as four arrays: self-loops, duplicates, absent
    deletes, present adds (the JAX tests' ``_random_delta``)."""
    n = g.n
    a_s = rng.integers(0, n, n_add)
    a_d = rng.integers(0, n, n_add)
    src, dst = _edge_list(g)
    pick = rng.integers(0, g.m, max(n_del // 2, 1))
    d_s = np.concatenate([src[pick], rng.integers(0, n, n_del)])
    d_d = np.concatenate([dst[pick], rng.integers(0, n, n_del)])
    # a duplicated add and a self-loop
    a_s = np.concatenate([a_s, a_s[:1], [0]])
    a_d = np.concatenate([a_d, a_d[:1], [0]])
    return a_s, a_d, d_s, d_d


def _both_deltas(arrays):
    return GraphDelta(*arrays), JGraphDelta(*arrays)


def _assert_graph_equal(a, b):
    for name in ("indptr", "indices", "r_indptr", "r_indices"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert a.n == b.n


def _assert_applied_equal(a, b):
    _assert_graph_equal(a.graph, b.graph)
    for name in ("added_src", "added_dst", "removed_src", "removed_dst",
                 "touched"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


FAMILIES = {
    "erdos": lambda: j_gen.erdos(60, 3.0, seed=1),
    "powerlaw": lambda: j_gen.powerlaw(80, 4.0, seed=2),
    "community": lambda: j_gen.community(90, n_comm=3, avg_deg=4.0, seed=3),
    "grid": lambda: j_gen.grid(7),
}


# ----------------------------------------------------------------------
# GraphDelta
# ----------------------------------------------------------------------

def test_graph_delta_normalizes_like_reference():
    arrays = ([3, 3, 1, 2, 5], [4, 4, 1, 0, 5], [7, 7, 2], [2, 2, 2])
    mine, ref = _both_deltas(arrays)
    for name in ("add_src", "add_dst", "del_src", "del_dst"):
        np.testing.assert_array_equal(getattr(mine, name),
                                      getattr(ref, name))
    assert (mine.n_add, mine.n_del) == (ref.n_add, ref.n_del) == (2, 2)
    assert mine.max_vertex() == ref.max_vertex() == 7
    assert bool(mine) and not GraphDelta.empty()
    assert GraphDelta.empty().max_vertex() == -1
    d = GraphDelta.from_pairs(add=[(1, 2), (1, 2)], remove=[(3, 3)])
    assert d.n_add == 1 and d.n_del == 1        # deletions keep self-loops


def test_graph_delta_rejects_bad_ids():
    with pytest.raises(ValueError, match=">= 0"):
        GraphDelta.from_pairs(add=[(-1, 2)])
    with pytest.raises(ValueError, match="equal length"):
        GraphDelta([1, 2], [3], [], [])
    g = Graph.from_edges(4, [0, 1], [1, 2])
    with pytest.raises(ValueError, match="outside the graph"):
        apply_delta(g, GraphDelta.from_pairs(add=[(0, 4)]))


# ----------------------------------------------------------------------
# apply_delta: the CSR merge
# ----------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_apply_delta_matches_reference_and_rebuild(family):
    jg = FAMILIES[family]()
    g = _carry(jg)
    rng = np.random.default_rng(len(family))
    for _ in range(4):                       # a chain of deltas
        arrays = _random_pairs(g, rng)
        mine, ref = _both_deltas(arrays)
        got, want = apply_delta(g, mine), j_apply_delta(jg, ref)
        assert isinstance(got, AppliedDelta)
        _assert_applied_equal(got, want)
        # == a from_edges rebuild of the edited edge set
        src, dst = _edge_list(g)
        edges = (set(zip(src.tolist(), dst.tolist()))
                 - set(zip(mine.del_src.tolist(), mine.del_dst.tolist()))
                 ) | set(zip(mine.add_src.tolist(), mine.add_dst.tolist()))
        rebuilt = Graph.from_edges(g.n, [u for u, _ in edges],
                                   [v for _, v in edges])
        _assert_graph_equal(got.graph, rebuilt)
        assert got.n_changed == len(got.added_src) + len(got.removed_src)
        g2, touched = g.apply_delta(mine)
        _assert_graph_equal(g2, got.graph)
        np.testing.assert_array_equal(touched, got.touched)
        g, jg = got.graph, want.graph


def test_noop_and_delete_then_add_cases():
    g = Graph.from_edges(5, [0, 1, 2], [1, 2, 3])
    jg = JGraph.from_edges(5, [0, 1, 2], [1, 2, 3])
    cases = [
        dict(add=[(0, 1)]),                     # present insert
        dict(remove=[(3, 4)]),                  # absent delete
        dict(add=[(1, 2)], remove=[(1, 2)]),    # delete-then-add cancels
        dict(add=[(2, 2)]),                     # self-loop
    ]
    for case in cases:
        got = apply_delta(g, GraphDelta.from_pairs(**case))
        want = j_apply_delta(jg, JGraphDelta.from_pairs(**case))
        assert got.graph is g and got.n_changed == 0, case
        assert want.n_changed == 0
        assert got.touched.size == 0
    got = apply_delta(g, GraphDelta.from_pairs(add=[(3, 4)],
                                               remove=[(0, 1), (4, 0)]))
    want = j_apply_delta(jg, JGraphDelta.from_pairs(add=[(3, 4)],
                                                    remove=[(0, 1), (4, 0)]))
    _assert_applied_equal(got, want)
    np.testing.assert_array_equal(got.touched, [0, 1, 3, 4])


# ----------------------------------------------------------------------
# update_device_graph
# ----------------------------------------------------------------------

def _tables_equal(dg, jdg):
    np.testing.assert_array_equal(dg.ell_idx.numpy(), np.asarray(jdg.ell_idx))
    np.testing.assert_array_equal(dg.r_ell_idx.numpy(),
                                  np.asarray(jdg.r_ell_idx))
    assert (dg.ell_cap, dg.r_ell_cap, dg.m) == \
        (jdg.ell_cap, jdg.r_ell_cap, jdg.m)


@pytest.mark.parametrize("seed", range(3))
def test_incremental_patch_matches_build(seed):
    rng = np.random.default_rng(6 + seed)
    jg = j_gen.community(70, n_comm=2, avg_deg=4.0, seed=7 + seed)
    g = _carry(jg)
    dg, jdg = DeviceGraph.build(g, CPU), JDeviceGraph.build(jg)
    before = dg.ell_idx.clone()
    # rewire existing edges: degrees stay within the caps
    src, dst = _edge_list(g)
    pairs_add, pairs_del = [], []
    for i in rng.choice(g.m, 3, replace=False):
        u, v = int(src[i]), int(dst[i])
        w = next(int(x) for x in rng.permutation(g.n)
                 if x != u and x not in g.neighbors(u))
        pairs_add.append((u, w))
        pairs_del.append((u, v))
    applied = apply_delta(g, GraphDelta.from_pairs(pairs_add, pairs_del))
    j_applied = j_apply_delta(jg, JGraphDelta.from_pairs(pairs_add,
                                                         pairs_del))
    dg2, incremental = update_device_graph(dg, applied)
    jdg2, j_incremental = j_update_device_graph(jdg, j_applied)
    assert incremental and j_incremental
    _tables_equal(dg2, jdg2)
    fresh = DeviceGraph.build(applied.graph, CPU)
    assert torch.equal(dg2.ell_idx, fresh.ell_idx)
    assert torch.equal(dg2.r_ell_idx, fresh.r_ell_idx)
    assert torch.equal(dg.ell_idx, before), "the old tables were written"


def test_cap_overflow_falls_back_to_rebuild():
    g = Graph.from_edges(5, [0, 1], [1, 2])          # max out-degree 1
    jg = JGraph.from_edges(5, [0, 1], [1, 2])
    delta = dict(add=[(0, 2), (0, 3)])
    dg2, incremental = update_device_graph(
        DeviceGraph.build(g, CPU), apply_delta(g, GraphDelta.from_pairs(**delta)))
    jdg2, j_incremental = j_update_device_graph(
        JDeviceGraph.build(jg), j_apply_delta(jg, JGraphDelta.from_pairs(**delta)))
    assert not incremental and not j_incremental and dg2.ell_cap >= 3
    _tables_equal(dg2, jdg2)


def test_cap_overflow_rebuild_never_shrinks_caps():
    g = Graph.from_edges(6, [0, 1, 2], [1, 2, 3])
    jg = JGraph.from_edges(6, [0, 1, 2], [1, 2, 3])
    dg = DeviceGraph.build(g, CPU, min_ell_caps=(4, 8))
    jdg = JDeviceGraph.build(jg, edge_cap=16, min_ell_caps=(4, 8))
    assert (dg.ell_cap, dg.r_ell_cap) == (4, 8)
    _tables_equal(dg, jdg)
    delta = dict(add=[(5, v) for v in range(5)])     # out-row 5: deg 5 > 4
    dg2, incremental = update_device_graph(
        dg, apply_delta(g, GraphDelta.from_pairs(**delta)))
    jdg2, _ = j_update_device_graph(
        jdg, j_apply_delta(jg, JGraphDelta.from_pairs(**delta)))
    assert not incremental
    assert dg2.ell_cap >= dg.ell_cap and dg2.r_ell_cap >= dg.r_ell_cap
    assert dg2.r_ell_cap == 8                        # a floor, not a shrink
    _tables_equal(dg2, jdg2)


# ----------------------------------------------------------------------
# distances from the touched frontier
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_set_dists_match_reference(seed):
    """host_set_dist and the plain-arm msbfs_set_dist_ell against the JAX
    host walk, its ELL sweep (Pallas interpreter) and its segment sweep;
    the old and new graphs give the same distances."""
    rng = np.random.default_rng(19 + seed)
    jg = j_gen.erdos(50, 3.0, seed=seed)
    g = _carry(jg)
    dg, jdg = DeviceGraph.build(g, CPU), JDeviceGraph.build(jg)
    arrays = _random_pairs(g, rng)
    applied = apply_delta(g, GraphDelta(*arrays))
    j_applied = j_apply_delta(jg, JGraphDelta(*arrays))
    assert applied.touched.size
    mask = np.zeros(g.n + 1, np.int8)
    mask[applied.touched] = 1
    for k_max in (1, 3, 5):
        for reverse in (False, True):
            host = host_set_dist(g, applied, k_max, reverse=reverse)
            np.testing.assert_array_equal(
                host, j_host_set_dist(jg, j_applied, k_max, reverse=reverse))
            np.testing.assert_array_equal(
                host, host_set_dist(applied.graph, applied, k_max, reverse))
            # distances on G relax over G's in-neighbours (r_ell_idx)
            ell = dg.ell_idx if reverse else dg.r_ell_idx
            j_ell = jdg.ell_idx if reverse else jdg.r_ell_idx
            got = msbfs_set_dist_ell(ell, torch.from_numpy(mask), n=g.n,
                                     k_max=k_max)
            assert got.dtype == torch.int8 and got.shape == (g.n + 1,)
            np.testing.assert_array_equal(got.numpy(), host)
            np.testing.assert_array_equal(got.numpy(), np.asarray(
                j_msbfs_set_dist_ell(j_ell, jnp.asarray(mask), n=g.n,
                                     k_max=k_max, backend="interpret")))
            esrc, edst = ((jdg.r_esrc, jdg.r_edst) if reverse
                          else (jdg.esrc, jdg.edst))
            np.testing.assert_array_equal(got.numpy(), np.asarray(
                j_msbfs_set_dist(esrc, edst, jnp.asarray(mask), n=g.n,
                                 k_max=k_max)))


def test_set_dist_ignores_row_n_and_guards_k_max():
    g = Graph.from_edges(4, [0, 1, 2], [1, 2, 3])
    dg = DeviceGraph.build(g, CPU)
    mask = torch.tensor([1, 0, 0, 0, 1], dtype=torch.int8)
    got = msbfs_set_dist_ell(dg.r_ell_idx, mask, n=4, k_max=2)
    np.testing.assert_array_equal(got.numpy(), [0, 1, 2, 3, 3])
    assert mask[4] == 1, "the caller's mask was written"
    with pytest.raises(ValueError, match="K_MAX_INT8"):
        msbfs_set_dist_ell(dg.r_ell_idx, mask, n=4, k_max=121)


# ----------------------------------------------------------------------
# hop-scoped invalidation
# ----------------------------------------------------------------------

def _levels(width=4, rows=4):
    verts = torch.full((rows, width), -1, dtype=torch.int32)
    verts[:, 0] = 1
    return [PathSet(verts, torch.tensor(rows), torch.tensor(False))]


def _j_levels(width=4, rows=4):
    verts = jnp.full((rows, width), -1, jnp.int32).at[:, 0].set(1)
    return [JPathSet(verts, jnp.int32(rows), jnp.bool_(False))]


def _dists(n, to=(), frm=()):
    d_to = np.full(n + 1, 99, np.int32)
    d_from = np.full(n + 1, 99, np.int32)
    for v, d in to:
        d_to[v] = d
    for v, d in frm:
        d_from[v] = d
    return {"to": d_to, "from": d_from}


KEYS = [("f", 3, 2, ((9, 4),), -2), ("b", 7, 2, ((1, 4),), -2),
        ("f", 5, 3, ((9, 2), (11, 5)), 9), ("b", 11, 1, ((3, 6),), -2)]
INVALIDATIONS = [
    ([5], dict(to=[(3, 3)], frm=[(9, 5)])),           # far: all survive
    ([5], dict(to=[(3, 2), (1, 99)], frm=[(7, 1)])),  # enumeration balls
    ([5], dict(frm=[(9, 4)])),                        # consumer prune radius
    ([5], dict(to=[(1, 3)])),
    ([5], dict(to=[(3, 2)])),                         # boundary inclusive
    ([5], dict(to=[(3, 3), (5, 3)], frm=[(11, 1), (9, 2)])),
    ([], {}),                                         # empty touched
]


@pytest.mark.parametrize("case", range(len(INVALIDATIONS)))
def test_invalidate_delta_evicts_like_reference(case):
    touched, d = INVALIDATIONS[case]
    mine, ref = SharedPathCache(), JCache()
    for key in KEYS:
        mine.put(key, _levels())
        ref.put(key, _j_levels())
    dists = _dists(20, **d) if touched else \
        {"to": np.empty(0), "from": np.empty(0)}
    assert mine.invalidate_delta(touched, dists) == \
        ref.invalidate_delta(touched, dists)
    assert [k for k in KEYS if mine.contains(k)] == \
        [k for k in KEYS if ref.contains(k)]
    assert mine.nbytes == ref.nbytes
    for key in KEYS:
        assert mine.has_root(*key[:2]) == ref.has_root(*key[:2])
    info, j_info = mine.info(), ref.info()
    for k in ("epoch", "delta_invalidations", "delta_evictions",
              "delta_kept", "entries"):
        assert info[k] == j_info[k], k
    # survivors carry the new epoch: they still hit
    for key in KEYS:
        if mine.contains(key):
            assert mine.get(key, CPU) is not None


def test_max_radius_matches_reference():
    mine, ref = SharedPathCache(), JCache()
    assert mine.max_radius() == ref.max_radius() == 0
    for key in KEYS:
        mine.put(key, _levels())
        ref.put(key, _j_levels())
        assert mine.max_radius() == ref.max_radius()
    assert mine.max_radius() == 6


# ----------------------------------------------------------------------
# the engine: a sequence of deltas against the JAX engine
# ----------------------------------------------------------------------

def _workload():
    jg = j_gen.community(900, n_comm=3, avg_deg=4.0, seed=0)
    qs = j_gen.similar_queries(jg, 8, similarity=0.85, k_range=(3, 4),
                               seed=1)
    return jg, qs


def _far_pairs(g, qs, count, rng):
    """Existing edges and absent pairs with both endpoints beyond every
    query's hop radius."""
    hot = np.zeros(g.n, bool)
    for s, t, k in qs:
        hot |= oracle.bfs_dist_from(g, s, k) <= k
        hot |= oracle.bfs_dist_from(g, t, k, reverse=True) <= k
    cold = ~hot
    src, dst = _edge_list(g)
    idx = np.flatnonzero(cold[src] & cold[dst])
    assert idx.size >= count, "no hop-cold region in the test graph"
    have = set(zip(src.tolist(), dst.tolist()))
    cold_v = np.flatnonzero(cold)
    adds = []
    while len(adds) < count:
        u, v = (int(x) for x in rng.choice(cold_v, 2, replace=False))
        if (u, v) not in have and (u, v) not in adds:
            adds.append((u, v))
    return adds, [(int(src[i]), int(dst[i])) for i in idx[:count]]


def _cap_crossing_pairs(g, dg):
    """In-edges into a vertex of maximum in-degree until it passes the
    in-neighbour table's cap."""
    v = int(np.argmax(g.in_degree()))
    need = dg.r_ell_cap - int(g.in_degree()[v]) + 1
    have = set(g.neighbors(v, reverse=True).tolist()) | {v}
    srcs = [u for u in range(g.n) if u not in have][:need]
    return [(u, v) for u in srcs]


def _check_rows(g, qs, rep, j_rep):
    for qi, (s, t, k) in enumerate(qs):
        assert np.array_equal(rep[qi].paths, np.asarray(j_rep[qi].paths)), qi
        truth = oracle.path_set(oracle.enumerate_paths_bruteforce(g, s, t, k))
        assert oracle.path_set(rep[qi].paths) == truth, qi


@pytest.mark.parametrize("backend", ["host", "msbfs"])
def test_delta_sequence_matches_jax_engine(backend):
    jg, qs = _workload()
    cfg = dict(min_cap=64, cache_bytes=64 << 20, delta_max_sources=16,
               delta_backend=backend)
    eng = BatchPathEngine(_carry(jg), EngineConfig(**cfg), device=CPU)
    j_eng = JEngine(jg, JConfig(kernel_backend="jnp", **cfg))
    cold = eng.run(qs)
    _check_rows(eng.g, qs, cold, j_eng.run(qs))
    rng = np.random.default_rng(9)

    path = [int(x) for x in cold[0].paths[0] if x >= 0]

    def noop(g):
        src, dst = _edge_list(g)
        return GraphDelta.from_pairs(add=[(int(src[0]), int(dst[0]))])

    # each delta is drawn from the graph it applies to
    deltas = {
        "far": lambda g: GraphDelta.from_pairs(*_far_pairs(g, qs, 2, rng)),
        "near": lambda g: GraphDelta.from_pairs(remove=[(path[0], path[1])]),
        "noop": noop,
        "wide": lambda g: GraphDelta(*_random_pairs(
            g, rng, n_add=g.m // 400 + 8, n_del=g.m // 400 + 8)),
        "cap": lambda g: GraphDelta.from_pairs(
            add=_cap_crossing_pairs(g, eng.dg)),
    }
    modes = []
    for name, make in deltas.items():
        delta = make(eng.g)
        j_delta = JGraphDelta(delta.add_src, delta.add_dst, delta.del_src,
                              delta.del_dst)
        g_before, dg_before, epoch = eng.g, eng.dg, eng.cache.epoch
        rep = eng.apply_delta(delta)
        j_rep = j_eng.apply_delta(j_delta)
        assert rep.pop("t_apply_s") >= 0 and j_rep.pop("t_apply_s") >= 0
        assert rep == j_rep, name
        assert (eng.dg.ell_cap, eng.dg.r_ell_cap) == \
            (j_eng.dg.ell_cap, j_eng.dg.r_ell_cap)
        after = eng.run(qs)
        _check_rows(eng.g, qs, after, j_eng.run(qs))
        modes.append((name, rep["cache_mode"], rep["device_update"]))
        if name == "far":
            assert rep["cache_kept"] > 0 and rep["cache_evicted"] == 0
            assert after.stats["n_materialized"] == 0
        if name == "near":
            assert rep["cache_evicted"] > 0
            assert tuple(path) not in oracle.path_set(after[0].paths)
        if name == "noop":
            assert eng.g is g_before and eng.dg is dg_before
            assert eng.cache.epoch == epoch
        if name == "cap":
            assert eng.dg.r_ell_cap > dg_before.r_ell_cap
            assert eng.dg.ell_cap >= dg_before.ell_cap
    assert modes == [("far", "delta", "incremental"),
                     ("near", "delta", "incremental"),
                     ("noop", "none", "none"),
                     ("wide", "full", "incremental"),
                     ("cap", "delta", "rebuild")]
    # the engine's tables equal a fresh build of the final graph
    fresh = DeviceGraph.build(eng.g, CPU,
                              min_ell_caps=(eng.dg.ell_cap,
                                            eng.dg.r_ell_cap))
    assert torch.equal(eng.dg.ell_idx, fresh.ell_idx)
    assert torch.equal(eng.dg.r_ell_idx, fresh.r_ell_idx)


def test_msbfs_backend_counts_launches_only_through_its_sweep(monkeypatch):
    """The "msbfs" backend prices the damage with msbfs_set_dist_ell on
    the old tables; "host" never calls it."""
    from repro_torch.core import engine as engine_mod
    calls = []
    real = engine_mod.msbfs_set_dist_ell

    def spy(ell, seed, *, n, k_max):
        calls.append((ell.data_ptr(), k_max))
        return real(ell, seed, n=n, k_max=k_max)

    monkeypatch.setattr(engine_mod, "msbfs_set_dist_ell", spy)
    jg, qs = _workload()
    for backend, expect in (("host", 0), ("msbfs", 2), ("device", 2)):
        calls.clear()
        eng = BatchPathEngine(_carry(jg), EngineConfig(
            min_cap=64, cache_bytes=64 << 20, delta_backend=backend),
            device=CPU)
        eng.run(qs)
        old = {eng.dg.ell_idx.data_ptr(), eng.dg.r_ell_idx.data_ptr()}
        radius = eng.cache.max_radius()
        s, _, _ = qs[0]
        eng.apply_delta(GraphDelta.from_pairs(
            remove=[(s, int(eng.g.neighbors(s)[0]))]))
        assert len(calls) == expect, backend
        assert all(p in old for p, _ in calls)
        assert all(k == min(1 << (radius - 1).bit_length(), 120)
                   for _, k in calls)


def test_session_apply_delta_batch_mode():
    jg = j_gen.community(200, n_comm=3, avg_deg=4.0, seed=8)
    qs = j_gen.similar_queries(jg, 5, similarity=0.8, k_range=(3, 3), seed=9)
    session = PathSession(_carry(jg), EngineConfig(min_cap=64,
                                                   cache_bytes=32 << 20),
                          device=CPU)
    session.run(qs)
    s, _, _ = qs[0]
    rep = session.apply_delta(GraphDelta.from_pairs(
        remove=[(s, int(session.engine.g.neighbors(s)[0]))]))
    assert rep["n_removed"] == 1 and rep["cache_mode"] == "delta"
    assert rep["device_update"] == "incremental"
    g2 = session.engine.g
    r = session.run(qs)
    for qi, (s, t, k) in enumerate(qs):
        assert oracle.path_set(r[qi].paths) == oracle.path_set(
            oracle.enumerate_paths_bruteforce(g2, s, t, k))
    # a session without a cache applies deltas too
    bare = PathSession(_carry(jg), EngineConfig(min_cap=64), device=CPU)
    rep = bare.apply_delta(GraphDelta.from_pairs(add=[(0, 1), (1, 2)]))
    assert rep["cache_mode"] == "none"
    assert rep["device_update"] in ("incremental", "rebuild")
