"""The port's sharded executor against the JAX package's.

``repro_torch.core.distributed`` places a batch's sharing clusters on
engine replicas (LPT ``plan_clusters``) and runs them in threads; here
every replica lies on the CPU (``mesh=["cpu"] * 8``, the counterpart of
the reference's eight forced host devices). Held to the JAX package:

* ``plan_clusters`` on the reference's own cases and seeded random cost
  vectors: equal assignments and loads;
* ``cluster_costs`` and the per-query ball costs on the same index;
* the eight-replica engine against the JAX engine (``kernel_backend=
  "jnp"``) under ``batch``, ``batch+``, ``basic`` and ``auto``: the same
  path rows in the same order, counts, clusters; fewer clusters than
  replicas, zero queries, count and exists outputs;
* deltas: lockstep cache epochs, equal ``n_touched`` and rows over four
  rounds, replica tables equal to the primary's;
* the sharded ``StreamingServer``: equal results, ``per_device`` in
  ``batch_log`` and no steals;
* the JAX engine with ``n_devices=8`` in a subprocess under
  ``--xla_force_host_platform_device_count=8``: equal ``per_device``
  placement (all but ``device`` and ``t_wall_s``), cluster routes and
  ``routed_red``.

Also: ``n_devices=1`` and ``mesh=["cpu"]`` are the identity, a replica's
error propagates with nothing of its batch gathered, and launch counts
taken from many threads lose nothing. All outputs are integers (costs are
integer-valued floats): the tolerance is exact equality.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import build_index as j_build_index  # noqa: E402
from repro.core import generators as j_gen  # noqa: E402
from repro.core.delta import GraphDelta as JGraphDelta  # noqa: E402
from repro.core.distributed import cluster_costs as j_cluster_costs  # noqa: E402
from repro.core.distributed import plan_clusters as j_plan_clusters  # noqa: E402
from repro.core.distributed import query_ball_cost as j_query_ball_cost  # noqa: E402,E501
from repro.core.engine import BatchPathEngine as JEngine  # noqa: E402
from repro.core.engine import EngineConfig as JConfig  # noqa: E402
from repro.core.graph import DeviceGraph as JDeviceGraph  # noqa: E402
from repro.core.planner import RouterConfig as JRouterConfig  # noqa: E402
from repro.core.query import PathQuery as JPathQuery  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro_torch.core import (BatchPathEngine, DeviceGraph,  # noqa: E402
                              EngineConfig, Graph, GraphDelta, PathQuery,
                              PathSession, build_index)
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.planner import RouterConfig  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.obs import metrics as obsmetrics  # noqa: E402

CPU = "cpu"
MESH8 = [CPU] * 8
ROOT = Path(__file__).resolve().parents[1]
# routing thresholds under which the test graph's clusters split between
# YELLOW and RED (the defaults route every one of its queries GREEN)
ROUTER = dict(green_max_cost=0.0, red_min_cost=300.0)


def _port_graph(jg) -> Graph:
    return Graph.from_arrays(jg.n, jg.indptr, jg.indices, jg.r_indptr,
                             jg.r_indices)


@pytest.fixture(scope="module")
def sharded():
    """The reference's sharded-parity workload: 12 disconnected
    communities, about 12 clusters over 8 replicas."""
    jg = j_gen.community(1200, n_comm=12, avg_deg=4.0, p_intra=1.0, seed=0)
    qs = [tuple(int(x) for x in q)
          for q in j_gen.random_queries(jg, 16, k_range=(4, 5), seed=1)]
    return {"jg": jg, "g": _port_graph(jg), "qs": qs}


def _same_rows(mine, ref):
    assert len(mine) == len(ref)
    for qi, (a, b) in enumerate(zip(mine, ref)):
        assert np.array_equal(a.paths, b.paths), qi
        assert a.count == b.count and a.exists == b.exists, qi


# ----------------------------------------------------------------------
# placement units
# ----------------------------------------------------------------------
# the reference's cases: more clusters than replicas; fewer (trailing
# replicas empty); none; the heaviest on distinct replicas; zero-cost
# ties spread round-robin
PLAN_CASES = [
    ([5.0, 1.0, 4.0, 2.0, 3.0, 1.0, 8.0], 3),
    ([2.0, 1.0], 4),
    ([], 4),
    ([10.0, 9.0, 1.0], 2),
    ([0.0] * 6, 3),
    ([0.0] * 4, 3),
    ([3.0, 3.0, 3.0, 1.0], 1),
]


def _random_costs(seed):
    r = np.random.default_rng(seed)
    n = int(r.integers(0, 40))
    costs = r.integers(0, 6, n).astype(float) * r.choice([1.0, 1e3], n)
    return [float(c) for c in costs], int(r.integers(1, 9))


@pytest.mark.parametrize(
    "costs,n", PLAN_CASES + [_random_costs(s) for s in range(8)])
def test_plan_clusters_equals_reference(costs, n):
    mine = distributed.plan_clusters(costs, n)
    assert mine == j_plan_clusters(costs, n)
    assign, loads = mine
    assert sorted(ci for a in assign for ci in a) == list(range(len(costs)))
    assert len(assign) == len(loads) == n


def test_cluster_costs_equal_reference(sharded):
    jg, g, qs = sharded["jg"], sharded["g"], sharded["qs"]
    clusters = [[0, 1, 2], [3], list(range(4, 16))]
    j_index = j_build_index(JDeviceGraph.build(jg), qs, backend="jnp")
    index = build_index(DeviceGraph.build(g, CPU), qs)
    reg = obsmetrics.registry()
    before = reg.snapshot()
    assert distributed.cluster_costs(index, clusters) \
        == j_cluster_costs(j_index, clusters)
    # counted on the index's device: no host copy to count
    assert not reg.since(before)
    # the balls counted one reduction a hop budget give the reference's
    # per-query scans exactly
    j_dists = (np.asarray(j_index.dist_s), np.asarray(j_index.dist_t))
    assert distributed.query_ball_costs(index, range(len(qs))) \
        == {qi: j_query_ball_cost(j_index, qi, j_dists)
            for qi in range(len(qs))}
    assert distributed.query_ball_costs(index, []) == {}


def test_resolve_mesh_on_the_cpu():
    assert distributed.resolve_mesh(None, None, CPU) is None
    assert distributed.resolve_mesh(None, 0, CPU) is None
    assert distributed.resolve_mesh(None, 1, CPU) == [torch.device(CPU)]
    got = distributed.resolve_mesh(["cpu", torch.device("cpu")], 5, CPU)
    assert got == [torch.device(CPU)] * 2          # mesh wins


def test_a_dropped_sharded_engine_is_freed_at_once(sharded):
    """The executor holds its engine weakly: dropping a sharded engine
    frees it (and its tables) without the cyclic collector."""
    import gc
    import weakref
    eng = BatchPathEngine(sharded["g"], EngineConfig(
        min_cap=128, cache_bytes=1 << 20, mesh=[CPU] * 3), device=CPU)
    eng.run(sharded["qs"])
    assert len(eng.executor.replicas()) == 3
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_replicas_alias_tables_and_deltas_never_write_them(sharded):
    """On the engine's own device a replica's tables ARE the primary's,
    before and after a delta: safe, because a delta builds new tables
    (``index_copy``, not ``index_copy_``) and leaves the old ones as they
    were."""
    g, qs = sharded["g"], sharded["qs"]
    eng = BatchPathEngine(g, EngineConfig(min_cap=128, mesh=[CPU] * 3),
                          device=CPU)
    eng.run(qs)
    reps = eng.executor.replicas()
    old = eng.dg.ell_idx
    kept = old.clone()
    assert all(r.dg.ell_idx is old for r in reps)
    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    eng.apply_delta(GraphDelta.from_pairs(
        add=[(0, 600), (5, 900)], remove=[(int(src[0]), int(g.indices[0]))]))
    assert torch.equal(old, kept)                  # never written in place
    assert not torch.equal(eng.dg.ell_idx, kept)
    for r in reps[1:]:
        # the primary's patched tables, aliased again: no extra copy
        assert r.dg.ell_idx is eng.dg.ell_idx
        assert r.dg.r_ell_idx is eng.dg.r_ell_idx
        assert r.g is eng.g


# ----------------------------------------------------------------------
# the sharded engine against the JAX engine
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mesh_kw", [dict(n_devices=1), dict(mesh=[CPU])])
def test_one_replica_mesh_is_the_identity(sharded, mesh_kw):
    g, qs = sharded["g"], sharded["qs"]
    plain = BatchPathEngine(g, EngineConfig(min_cap=128), device=CPU)
    one = BatchPathEngine(g, EngineConfig(min_cap=128, **mesh_kw),
                          device=CPU)
    assert one.executor.n_replicas == 1 and not one.executor.sharded
    assert one.executor.index_dg is one.dg
    r0, r1 = plain.run(qs), one.run(qs)
    _same_rows(r1, r0)
    assert "per_device" not in r1.stats and "n_devices" not in r1.stats
    assert len(one.run([])) == 0


@pytest.mark.parametrize("planner", ["batch", "batch+", "basic", "auto"])
def test_eight_replicas_match_reference(sharded, planner):
    jg, g, qs = sharded["jg"], sharded["g"], sharded["qs"]
    j_eng = JEngine(jg, JConfig(min_cap=128, kernel_backend="jnp",
                                router=JRouterConfig(**ROUTER)))
    eng = BatchPathEngine(g, EngineConfig(min_cap=128, mesh=MESH8,
                                          router=RouterConfig(**ROUTER)),
                          device=CPU)
    assert eng.executor.n_replicas == 8 and eng.executor.sharded
    ref, got = j_eng.run(qs, planner=planner), eng.run(qs, planner=planner)
    _same_rows(got, ref)
    assert got.stats.get("n_clusters") == ref.stats.get("n_clusters")
    for key in ("n_psi_nodes", "n_materialized", "n_shared", "n_dedup",
                "n_share_edges", "n_rows_assembled", "cluster_planners"):
        assert got.stats.get(key) == ref.stats.get(key), key
    if planner == "basic":
        assert "per_device" not in got.stats
        return
    pd = got.stats["per_device"]
    assert got.stats["n_devices"] == len(pd) == 8
    assert sum(d["n_clusters"] for d in pd) == got.stats["n_clusters"]
    assert sum(d["n_queries"] for d in pd) == \
        len(qs) - got.stats.get("routed_green", 0)
    if planner == "auto":
        # one device routes no cluster RED; the mesh does (the routes
        # themselves are held to the JAX mesh in the subprocess test)
        assert set(ref.stats["cluster_routes"]) == {"yellow"}
        assert "red" in got.stats["cluster_routes"]
        assert got.stats["routed_red"] > 0
        assert got.routes.count("red") == got.stats["routed_red"]


def test_fewer_clusters_than_replicas_zero_queries_and_counts(sharded):
    jg, g, qs = sharded["jg"], sharded["g"], sharded["qs"]
    j_eng = JEngine(jg, JConfig(min_cap=128, kernel_backend="jnp"))
    eng = BatchPathEngine(g, EngineConfig(min_cap=128, mesh=MESH8),
                          device=CPU)
    sub = qs[:3]
    got = eng.run(sub)
    _same_rows(got, j_eng.run(sub))
    pd = got.stats["per_device"]
    assert sum(1 for d in pd if d["n_clusters"] == 0) == \
        8 - got.stats["n_clusters"]
    assert len(eng.run([])) == 0
    cq = [PathQuery(s, t, k, output="count") for s, t, k in qs[:6]]
    jq = [JPathQuery(s, t, k, output="count") for s, t, k in qs[:6]]
    assert [r.count for r in eng.run(cq)] == [r.count for r in j_eng.run(jq)]
    eq = [PathQuery(s, t, k, output="exists") for s, t, k in qs]
    jq = [JPathQuery(s, t, k, output="exists") for s, t, k in qs]
    assert [r.exists for r in eng.run(eq)] == \
        [r.exists for r in j_eng.run(jq)]


def test_balance_clusters_splits_for_the_replicas(sharded):
    g, qs = sharded["g"], sharded["qs"]
    # gamma below every similarity merges the whole batch into one cluster
    one = BatchPathEngine(g, EngineConfig(min_cap=128, gamma=-1.0,
                                          balance_clusters=True), device=CPU)
    four = PathSession(g, EngineConfig(min_cap=128, gamma=-1.0,
                                       balance_clusters=True),
                       mesh=[CPU] * 4, device=CPU)
    r1, r4 = one.run(qs), four.run(qs)
    assert r1.stats["n_clusters"] == 1
    assert r4.stats["n_clusters"] == 4
    assert [d["n_clusters"] for d in r4.stats["per_device"]] == [1] * 4
    for a, b in zip(r1, r4):
        assert sorted(map(tuple, a.paths)) == sorted(map(tuple, b.paths))


def test_sharded_deltas_stay_in_lockstep(sharded):
    jg, g = sharded["jg"], sharded["g"]
    qs = [tuple(int(x) for x in q)
          for q in j_gen.random_queries(jg, 12, k_range=(4, 4), seed=1)]
    j_eng = JEngine(jg, JConfig(min_cap=128, cache_bytes=16 << 20,
                                kernel_backend="jnp"))
    eng = BatchPathEngine(g, EngineConfig(min_cap=128, cache_bytes=16 << 20,
                                          mesh=MESH8), device=CPU)
    rng = np.random.default_rng(0)
    _same_rows(eng.run(qs), j_eng.run(qs))         # warm every cache
    for rnd in range(4):
        src = np.repeat(np.arange(jg.n), np.diff(j_eng.g.indptr))
        dst = j_eng.g.indices
        pick = rng.choice(src.size, 6, replace=False)
        rem = list(zip(src[pick].tolist(), dst[pick].tolist()))
        adds = []
        while len(adds) < 6:
            u, v = (int(x) for x in rng.integers(0, jg.n, 2))
            if u != v:
                adds.append((u, v))
        ref = j_eng.apply_delta(JGraphDelta.from_pairs(add=adds, remove=rem))
        got = eng.apply_delta(GraphDelta.from_pairs(add=adds, remove=rem))
        assert got["n_touched"] == ref["n_touched"]
        assert got["cache_epochs"] == [ref["cache_epoch"]] * 8, rnd
        for key in ("cache_mode", "device_update", "n_added", "n_removed"):
            assert got[key] == ref[key], key
        for rep in eng.executor.replicas()[1:]:
            assert torch.equal(rep.dg.ell_idx, eng.dg.ell_idx)
            assert torch.equal(rep.dg.r_ell_idx, eng.dg.r_ell_idx)
        _same_rows(eng.run(qs), j_eng.run(qs))
    caches = eng._all_caches()
    assert len(caches) == 8 and len({c.epoch for c in caches}) == 1
    # a wholesale swap bumps every epoch and drops the replicas
    eng.set_graph(g)
    assert len({c.epoch for c in caches}) == 1
    assert eng.executor.replica_caches() == []


def test_sharded_streaming_server_matches_reference():
    jg = j_gen.community(800, n_comm=8, avg_deg=4.0, p_intra=1.0, seed=0)
    g = _port_graph(jg)
    qs = [tuple(int(x) for x in q)
          for q in j_gen.random_queries(jg, 12, k_range=(4, 4), seed=1)]
    kw = dict(min_cap=128, cache_bytes=16 << 20)
    j_srv = j_serve.StreamingServer(
        JEngine(jg, JConfig(kernel_backend="jnp", **kw)),
        policy=j_serve.AdmissionPolicy(max_batch=12, max_delay_s=0.0))
    srv = serve.StreamingServer(
        BatchPathEngine(g, EngineConfig(mesh=MESH8, **kw), device=CPU),
        policy=serve.AdmissionPolicy(max_batch=12, max_delay_s=0.0))
    qids = [srv.submit(q) for q in qs]
    assert [j_srv.submit(q) for q in qs] == qids
    srv.drain()
    j_srv.drain()
    for qid in qids:
        a, b = srv.take(qid), j_srv.take(qid)
        assert np.array_equal(a.paths, b.paths), qid
    log, j_log = srv.batch_log[-1], j_srv.batch_log[-1]
    assert log["n_clusters"] == j_log["n_clusters"] > 1
    assert log["n_devices"] == 8 and len(log["per_device"]) == 8
    assert sum(d["n_clusters"] for d in log["per_device"]) == \
        log["n_clusters"]
    assert srv.sched.steals == 0      # the executor replaces stealing
    for key in ("n_psi_nodes", "n_materialized", "n_cache_hits",
                "n_cache_misses"):
        assert log[key] == j_log[key], key


def test_serve_cli_shards_over_the_devices_asked_for():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = [sys.executable, "-m", "repro_torch.launch.serve", "--n", "400",
            "--queries", "4", "--k-min", "3", "--k-max", "3",
            "--validate", "1", "--device", "cpu", "--devices", "1"]
    out = subprocess.run(args, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "on cpu (torch kernels)" in out.stdout and "OK" in out.stdout


# ----------------------------------------------------------------------
# failures propagate, counts are exact across threads
# ----------------------------------------------------------------------
def test_a_replica_error_propagates_and_nothing_is_gathered(sharded,
                                                            monkeypatch):
    g, qs = sharded["g"], sharded["qs"]
    eng = BatchPathEngine(g, EngineConfig(min_cap=128, mesh=MESH8),
                          device=CPU)
    srv = serve.StreamingServer(
        eng, policy=serve.AdmissionPolicy(max_batch=16, max_delay_s=0.0))
    victim = qs[5]
    real = BatchPathEngine._cluster_work

    def failing(self, queries, index, plus, min_sb, cluster):
        if any(tuple(queries[qi].key) == victim for qi in cluster):
            raise RuntimeError("replica lost its kernel")
        return real(self, queries, index, plus, min_sb, cluster)

    monkeypatch.setattr(BatchPathEngine, "_cluster_work", failing)
    with pytest.raises(RuntimeError, match="replica lost its kernel"):
        eng.run(qs)
    assert not eng.executor.in_fanout
    for q in qs:
        srv.submit(q)
    with pytest.raises(RuntimeError, match="replica lost its kernel"):
        srv.drain()
    assert srv.results == {} and srv.batch_log == []
    monkeypatch.setattr(BatchPathEngine, "_cluster_work", real)
    plain = BatchPathEngine(g, EngineConfig(min_cap=128), device=CPU)
    _same_rows(eng.run(qs), plain.run(qs))        # the engine still works


def test_launch_counts_lose_nothing_across_threads():
    """More threads than cores, switching as often as the interpreter
    allows: a lost read-modify-write would show in the totals."""
    saved = dict(registry.LAUNCHES)
    interval = sys.getswitchinterval()
    registry.reset_launches()
    n_threads, per_thread = 2 * (os.cpu_count() or 1) + 1, 2000
    barrier = threading.Barrier(n_threads)

    def count():
        barrier.wait(timeout=30)
        for _ in range(per_thread):
            registry.count_launch("level_fused", "path_member")

    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=count) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert registry.LAUNCHES["level_fused"] == n_threads * per_thread
        assert registry.LAUNCHES["path_member"] == n_threads * per_thread
        assert registry.LAUNCHES["join_fused"] == 0
    finally:
        sys.setswitchinterval(interval)
        registry.LAUNCHES.update(saved)


def test_first_load_runs_one_build_for_many_threads(monkeypatch, tmp_path):
    """``build.load`` from several threads at once: one build, one
    library object, every signature declared."""
    import ctypes

    from repro_torch.kernels import build

    calls = []
    gate = threading.Event()

    class FakeLib:
        def __init__(self, path):
            self.error_string = type("F", (), {})()
            self.launch = type("F", (), {})()

    def fake_build(names):
        calls.append(list(names))
        gate.wait(5)                   # hold the first builder a while

    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(ctypes, "CDLL", FakeLib)
    build._cdll.cache_clear()
    got = []
    try:
        threads = [threading.Thread(target=lambda: got.append(
            build.load("ell_spmm", {"launch": [ctypes.c_int]})))
            for _ in range(4)]
        for t in threads:
            t.start()
        gate.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        build._cdll.cache_clear()
    assert calls == [["ell_spmm"]]
    assert len(got) == 4 and all(lib is got[0] for lib in got)
    assert got[0].launch.argtypes == [ctypes.c_int]


# ----------------------------------------------------------------------
# placement and routes against the JAX engine on eight host devices
# ----------------------------------------------------------------------
JAX_MESH = """
import json, sys
import numpy as np
sys.path.insert(0, "src")
import jax
from repro.core import BatchPathEngine, EngineConfig, generators
from repro.core.planner import RouterConfig

assert len(jax.devices()) == 8
g = generators.community(1200, n_comm=12, avg_deg=4.0, p_intra=1.0, seed=0)
qs = generators.random_queries(g, 16, k_range=(4, 5), seed=1)
eng = BatchPathEngine(g, EngineConfig(min_cap=128, n_devices=8,
                                      kernel_backend="jnp",
                                      router=RouterConfig(**ROUTER)))
out = {}
for planner in ("batch", "auto"):
    r = eng.run(qs, planner=planner)
    out[planner] = {
        "per_device": [{k: v for k, v in d.items()
                        if k not in ("device", "t_wall_s")}
                       for d in r.stats["per_device"]],
        "cluster_routes": r.stats.get("cluster_routes"),
        "routed_red": r.stats.get("routed_red"),
        "n_clusters": r.stats["n_clusters"],
        "routes": None if r.routes is None else list(r.routes),
        "paths": [np.asarray(x.paths).tolist() for x in r]}
print("RESULT " + json.dumps(out))
"""


def test_placement_and_routes_match_the_jax_mesh(sharded):
    code = "ROUTER = %r\n" % ROUTER + textwrap.dedent(JAX_MESH)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=600, cwd=str(ROOT),
        env={"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
             "JAX_PLATFORMS": "cpu", "PYTHONPATH": "src",
             "PATH": "/usr/bin:/bin:/usr/local/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(next(ln for ln in out.stdout.splitlines()
                          if ln.startswith("RESULT "))[len("RESULT "):])
    eng = BatchPathEngine(sharded["g"], EngineConfig(
        min_cap=128, mesh=MESH8, router=RouterConfig(**ROUTER)), device=CPU)
    for planner in ("batch", "auto"):
        r = eng.run(sharded["qs"], planner=planner)
        got = {"per_device": [{k: v for k, v in d.items()
                               if k not in ("device", "t_wall_s")}
                              for d in r.stats["per_device"]],
               "cluster_routes": r.stats.get("cluster_routes"),
               "routed_red": r.stats.get("routed_red"),
               "n_clusters": r.stats["n_clusters"],
               "routes": None if r.routes is None else list(r.routes),
               "paths": [np.asarray(x.paths).tolist() for x in r]}
        assert got == ref[planner], planner
    assert "red" in ref["auto"]["cluster_routes"]
