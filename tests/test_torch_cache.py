"""The port's cross-batch cache (``SharedPathCache``) against the JAX one.

The same batches run twice through a ``PathSession`` with a cache on the
CPU and through the JAX engine with the same ``EngineConfig`` (with
``kernel_backend="interpret"``): hit, miss and materialization counts,
the cache's own statistics and the path rows must be equal -- exact
equality, all integers. Also: a hit gives the rows of the run that filled
the cache, ``update_graph`` invalidates it (and drops the host distance
memo), the LRU evicts as the reference does, and the host round trip
keeps the port's dtypes.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import generators as j_gen  # noqa: E402
from repro.core.cache import SharedPathCache as JCache  # noqa: E402
from repro.core.cache import dedicated_keys as j_dedicated_keys  # noqa: E402
from repro.core.delta import GraphDelta as JGraphDelta  # noqa: E402
from repro.core.engine import EngineConfig as JConfig  # noqa: E402
from repro.core.pathset import PathSet as JPathSet  # noqa: E402
from repro.core.planner import RouterConfig as JRouterConfig  # noqa: E402
from repro.core.session import PathSession as JSession  # noqa: E402
from repro_torch.core import (EngineConfig, Graph, GraphDelta,  # noqa: E402
                              PathSession, RouterConfig, SharedPathCache,
                              oracle)
from repro_torch.core.cache import dedicated_keys  # noqa: E402
from repro_torch.core.pathset import (HostPathSet, PathSet,  # noqa: E402
                                      offload, pathset_nbytes, upload)
from repro_torch.obs import metrics  # noqa: E402

CPU = "cpu"
BUDGET = 1 << 24
INFO_KEYS = ("entries", "nbytes", "epoch", "hits", "misses", "inserts",
             "evictions", "invalidations", "oversize_skips")


def _carry(jg):
    return Graph.from_arrays(jg.n, jg.indptr, jg.indices, jg.r_indptr,
                             jg.r_indices)


@pytest.fixture(scope="module")
def graphs():
    jg = j_gen.community(500, n_comm=5, avg_deg=5.0, seed=0)
    jg2 = j_gen.community(500, n_comm=5, avg_deg=5.0, seed=7)
    return dict(jg=jg, g=_carry(jg), jg2=jg2, g2=_carry(jg2),
                queries=j_gen.similar_queries(jg, 10, similarity=0.8,
                                              k_range=(4, 5), seed=2)
                + j_gen.random_queries(jg, 4, k_range=(3, 5), seed=1))


def _sessions(graphs, **over):
    mine = PathSession(graphs["g"], EngineConfig(cache_bytes=BUDGET, **over),
                       device=CPU)
    ref = JSession(graphs["jg"], JConfig(cache_bytes=BUDGET,
                                         kernel_backend="interpret", **over))
    return mine, ref


def _same_rows(mine, ref):
    for a, b in zip(mine, ref):
        assert np.array_equal(a.paths, np.asarray(b.paths))


@pytest.mark.parametrize("planner", ["batch", "batch+"])
def test_two_runs_hit_like_reference(graphs, planner):
    mine, ref = _sessions(graphs)
    qs = graphs["queries"]
    for rnd in range(2):
        a = mine.run(qs, planner=planner)
        b = ref.run(qs, planner=planner)
        _same_rows(a, b)
        for key in ("n_materialized", "n_cache_hits", "n_cache_misses",
                    "n_psi_nodes", "n_shared"):
            assert a.stats[key] == b.stats[key], (rnd, key)
        info, j_info = mine.cache.info(), ref.cache.info()
        assert {k: info[k] for k in INFO_KEYS} == \
            {k: j_info[k] for k in INFO_KEYS}
    assert a.stats["n_materialized"] == 0 and a.stats["n_cache_hits"] > 0


def test_hits_give_the_rows_that_filled_the_cache(graphs):
    mine, _ = _sessions(graphs)
    qs = graphs["queries"]
    cold = mine.run(qs)
    warm = mine.run(qs)
    assert cold.stats["n_cache_hits"] == 0 and warm.stats["n_materialized"] == 0
    for q, a, b in zip(qs, cold, warm):
        assert np.array_equal(a.paths, b.paths)
        assert oracle.path_set(b.paths) == set(
            oracle.enumerate_paths_bruteforce(graphs["g"], *q))


def test_update_graph_invalidates_and_drops_host_dists(graphs):
    mine, ref = _sessions(graphs)
    qs = graphs["queries"]
    mine.run(qs)
    ref.run(qs)
    engine = mine.engine
    assert engine._host_dists is not None
    mine.update_graph(graphs["g"])
    ref.update_graph(graphs["jg"])
    assert engine._host_dists is None
    assert len(mine.cache) == 0 and mine.cache.epoch == ref.cache.epoch == 1
    a, b = mine.run(qs), ref.run(qs)
    assert a.stats["n_cache_hits"] == b.stats["n_cache_hits"] == 0
    assert a.stats["n_materialized"] == b.stats["n_materialized"] > 0
    # a different graph: the answers are the new graph's, not the old
    mine.update_graph(graphs["g2"])
    got = mine.run(qs, planner="auto")
    fresh = PathSession(graphs["g2"], device=CPU).run(qs, planner="basic")
    for a, b in zip(got, fresh):
        assert oracle.path_set(a.paths) == oracle.path_set(b.paths)
    assert engine.dg.n == graphs["g2"].n and engine.g is graphs["g2"]


def test_auto_with_a_cache_plans_lone_clusters_as_batch(graphs):
    # with a cache the router keeps even a one-query cluster on the batch
    # plan, so that its halves can hit next time
    mine = PathSession(graphs["g"], EngineConfig(
        cache_bytes=BUDGET, router=RouterConfig(green_max_cost=0.0)),
        device=CPU)
    ref = JSession(graphs["jg"], JConfig(
        cache_bytes=BUDGET, kernel_backend="interpret",
        router=JRouterConfig(green_max_cost=0.0)))
    qs = graphs["queries"][-4:]
    for _ in range(2):
        a, b = mine.run(qs, planner="auto"), ref.run(qs, planner="auto")
        assert a.routes == b.routes
        assert a.stats["cluster_planners"] == b.stats["cluster_planners"]
        assert a.stats["n_cache_hits"] == b.stats["n_cache_hits"]
        _same_rows(a, b)
    assert "basic" not in a.stats["cluster_planners"]
    assert a.stats["n_cache_hits"] > 0


def test_explicit_cache_is_the_sessions(graphs):
    cache = SharedPathCache(BUDGET)
    s = PathSession(graphs["g"], EngineConfig(), cache=cache, device=CPU)
    assert s.cache is cache and s.engine.cache is cache
    s.run(graphs["queries"][:3])
    assert len(cache) > 0
    assert PathSession(graphs["g"], device=CPU).cache is None


def test_cache_metrics_count_hits_and_misses(graphs):
    mine, _ = _sessions(graphs)
    reg = metrics.registry()
    snap = reg.snapshot()
    mine.run(graphs["queries"])
    warm = mine.run(graphs["queries"])
    delta = reg.since(snap)
    hits = sum(v for (name, _), v in delta.items()
               if name == "cache_hits_total")
    misses = sum(v for (name, _), v in delta.items()
                 if name == "cache_misses_total")
    assert hits == mine.cache.stats.hits == warm.stats["n_cache_hits"]
    assert misses == mine.cache.stats.misses


@pytest.mark.parametrize("backend", ["host", "msbfs"])
def test_invalidate_delta_through_sessions_like_reference(graphs, backend):
    """A delta between two runs: the same report (less its wall time),
    the same surviving entries and statistics, and the same rows after."""
    mine, ref = _sessions(graphs, delta_backend=backend)
    qs = graphs["queries"]
    mine.run(qs)
    ref.run(qs)
    s, _, _ = qs[-1]
    u = int(graphs["g"].neighbors(s)[0])
    rep = mine.apply_delta(GraphDelta.from_pairs(remove=[(s, u)]))
    j_rep = ref.apply_delta(JGraphDelta.from_pairs(remove=[(s, u)]))
    rep.pop("t_apply_s")
    j_rep.pop("t_apply_s")
    assert rep == j_rep and rep["cache_mode"] == "delta"
    assert rep["cache_evicted"] > 0
    keys = INFO_KEYS + ("delta_invalidations", "delta_evictions",
                        "delta_kept")
    info, j_info = mine.cache.info(), ref.cache.info()
    assert {k: info[k] for k in keys} == {k: j_info[k] for k in keys}
    a, b = mine.run(qs), ref.run(qs)
    _same_rows(a, b)
    for key in ("n_materialized", "n_cache_hits", "n_cache_misses"):
        assert a.stats[key] == b.stats[key], key


def test_dedicated_keys_match_reference_and_engine(graphs):
    for s, t, k in graphs["queries"]:
        assert dedicated_keys(s, t, k) == j_dedicated_keys(s, t, k)
    s, t, k = graphs["queries"][-1]
    mine, _ = _sessions(graphs)
    mine.run([(s, t, k)])                # a lone query: its two halves
    for key in dedicated_keys(s, t, k):
        assert mine.cache.contains(key)


# ----------------------------------------------------------------------
# the LRU and the host round trip
# ----------------------------------------------------------------------

def _sets(r, caps_widths):
    out = []
    for cap, width in caps_widths:
        v = np.full((cap, width), -1, np.int32)
        cnt = int(r.integers(0, cap + 1))
        v[:cnt] = r.integers(0, 99, (cnt, width))
        out.append((v, cnt))
    return out


def test_lru_evicts_like_reference():
    r = np.random.default_rng(0)
    budget = 2 * pathset_nbytes(256, 4) + 100   # a 256-row entry fits
    mine, ref = SharedPathCache(budget), JCache(budget)
    ops = []
    for i in range(40):
        key = ("f", int(r.integers(0, 8)), 3, ((7, 4),), -2)
        if r.random() < 0.4:
            ops.append(("get", key))
        else:
            cap = int(r.choice([16, 64, 256]))
            ops.append(("put", key, _sets(r, [(cap, 4)])))
    for op in ops:
        if op[0] == "get":
            got = mine.get(op[1], CPU)
            j_got = ref.get(op[1])
            assert (got is None) == (j_got is None)
            if got is not None:
                for a, b in zip(got, j_got):
                    assert np.array_equal(a.verts.numpy(), np.asarray(b.verts))
                    assert int(a.count) == int(b.count)
        else:
            _, key, levels = op
            mine.put(key, [PathSet(torch.from_numpy(v), torch.tensor(c),
                                   torch.tensor(False)) for v, c in levels])
            ref.put(key, [JPathSet(jnp.asarray(v), jnp.int32(c),
                                   jnp.bool_(False)) for v, c in levels])
        assert mine.info() == ref.info()
        assert list(mine._entries) == list(ref._entries)
    assert mine.stats.evictions > 0 and mine.stats.hits > 0
    assert mine.stats.oversize_skips == 0


def test_oversize_entry_is_skipped_like_reference():
    mine, ref = SharedPathCache(100), JCache(100)
    v = np.zeros((64, 4), np.int32)
    mine.put(("f", 0, 3, (), -2), [PathSet(torch.from_numpy(v),
                                           torch.tensor(3),
                                           torch.tensor(False))])
    ref.put(("f", 0, 3, (), -2), [JPathSet(jnp.asarray(v), jnp.int32(3),
                                           jnp.bool_(False))])
    assert mine.info() == ref.info() and mine.stats.oversize_skips == 1


def test_offload_upload_round_trip_keeps_the_ports_dtypes():
    v = np.full((8, 3), -1, np.int32)
    v[:5] = np.arange(15, dtype=np.int32).reshape(5, 3)
    ps = PathSet(torch.from_numpy(v), torch.tensor(5, dtype=torch.int64),
                 torch.tensor(True))
    host = offload(ps)
    assert isinstance(host, HostPathSet)
    assert host.cap == 8 and host.count == 5 and host.overflow is True
    assert host.nbytes == 8 * 3 * 4 + 16 == pathset_nbytes(8, 3)
    back = upload(host, CPU)
    assert back.count.dtype == torch.int64 and back.overflow.dtype == torch.bool
    assert back.verts.dtype == torch.int32 and back.cap == 8   # full buffer
    assert torch.equal(back.verts, ps.verts)
    assert int(back.count) == 5 and bool(back.overflow)
    # copies both ways: neither side shares memory with the other
    ps.verts[0, 0] = 99
    back.verts[1, 0] = 77
    assert host.verts[0, 0] == 0 and host.verts[1, 0] == 3
