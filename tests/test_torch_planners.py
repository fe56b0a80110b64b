"""Every planner of the port with the default ``EngineConfig()`` against
the JAX engine.

The default configuration plans buffer capacities from walk counts
(``plan_caps=True``), which is what the ``ell_spmm`` kernel is for, and the
"+" planners split each query where the walk counts say the search is
cheapest. The batch mixes every output kind (paths / count / exists) and
limits; it runs through ``repro_torch``'s ``PathSession`` on the CPU (the
plain kernel versions) and through the JAX engine with
``kernel_backend="interpret"``, so that both take the ELL route of the
walk-count DP. Everything compared is an integer (paths, counts, flags,
statistics, routes) or integer-valued float32 below 2**24 (walk counts):
the tolerance is exact equality, path rows in the reference's order, and
every result is also held against the brute-force oracle.
"""
import warnings

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import generators as j_gen  # noqa: E402
from repro.core.engine import BatchPathEngine as JEngine  # noqa: E402
from repro.core.engine import EngineConfig as JConfig  # noqa: E402
from repro.core.graph import Graph as JGraph  # noqa: E402
from repro.core.index import build_index as j_build_index  # noqa: E402
from repro.core.planner import RouterConfig as JRouterConfig  # noqa: E402
from repro.core.query import PathQuery as JPathQuery  # noqa: E402
from repro_torch.core import (BatchPathEngine, BatchResult,  # noqa: E402
                              EngineConfig, Graph, PathQuery, PathSession,
                              RouterConfig, oracle)
from repro_torch.core.index import build_index  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

CPU = "cpu"
# router thresholds under which this batch splits into GREEN and YELLOW
# queries (with the defaults every query of it routes GREEN): at 300 five
# YELLOW queries form one cluster ("batch" plan), at 500 one YELLOW query
# is left alone ("basic" plan)
MIXED_GREEN_MAX = 300.0
LONE_GREEN_MAX = 500.0

# run name -> (planner, EngineConfig overrides)
RUNS = {
    "basic": ("basic", {}),
    "basic+": ("basic+", {}),
    "batch": ("batch", {}),
    "batch+": ("batch+", {}),
    "pathenum": ("pathenum", {}),
    "auto": ("auto", {}),
    "batch-plus-config": ("batch", {"plus": True}),
    "auto-mixed": ("auto", {"router": MIXED_GREEN_MAX}),
    "auto-lone": ("auto", {"router": LONE_GREEN_MAX}),
}


def _configs(over):
    over = dict(over)
    green = over.pop("router", None)
    if green is None:
        return EngineConfig(**over), JConfig(kernel_backend="interpret",
                                             **over)
    return (EngineConfig(router=RouterConfig(green_max_cost=green), **over),
            JConfig(kernel_backend="interpret",
                    router=JRouterConfig(green_max_cost=green), **over))


def _spec(jg):
    base = j_gen.random_queries(jg, 11, k_range=(3, 6), seed=1)
    kinds = [dict(), dict(output="count"), dict(output="exists"),
             dict(limit=2), dict(output="count", limit=3)]
    spec = [(s, t, k, kinds[i % len(kinds)]) for i, (s, t, k) in
            enumerate(base)]
    spec.append(spec[0])                       # a duplicate query
    return spec


@pytest.fixture(scope="module")
def workload():
    jg = j_gen.community(500, n_comm=5, avg_deg=5.0, seed=0)
    g = Graph.from_arrays(jg.n, jg.indptr, jg.indices, jg.r_indptr,
                          jg.r_indices)
    spec = _spec(jg)
    mine = [PathQuery(s, t, k, **kw) for s, t, k, kw in spec]
    ref = [JPathQuery(s, t, k, **kw) for s, t, k, kw in spec]
    engines = {}
    runs = {}
    for name, (planner, over) in RUNS.items():
        key = repr(sorted(over.items()))
        if key not in engines:
            cfg, jcfg = _configs(over)
            engines[key] = (BatchPathEngine(g, cfg, device=CPU),
                            JEngine(jg, jcfg))
        e, je = engines[key]
        runs[name] = (e.run(mine, planner=planner),
                      je.run(ref, planner=planner))
    default = engines[repr([])]
    return dict(g=g, jg=jg, queries=mine, ref_queries=ref, runs=runs,
                engine=default[0], j_engine=default[1])


def _assert_same_results(queries, mine, ref):
    for q, a, b in zip(queries, mine, ref):
        if q.output.value == "paths":
            assert a.paths.dtype == np.int32
            # same rows in the same order (stronger than sorted rows)
            assert np.array_equal(a.paths, np.asarray(b.paths)), q
            assert a.count == b.count
        elif q.output.value == "count":
            assert a.count == b.count, q
        assert a.exists == b.exists, q


@pytest.mark.parametrize("run", sorted(RUNS))
def test_results_equal_reference(workload, run):
    _assert_same_results(workload["queries"], *workload["runs"][run])


@pytest.mark.parametrize("run", sorted(RUNS))
def test_stats_equal_reference(workload, run):
    mine, ref = workload["runs"][run]
    # one schema: the reference's keys, less its compile telemetry
    assert set(mine.stats) == set(ref.stats), \
        set(mine.stats) ^ set(ref.stats)
    for key, val in ref.stats.items():
        if key.startswith("t_"):
            assert mine.stats[key] >= 0.0, key
        elif key != "kernel_backend":
            assert mine.stats[key] == val, key
    assert mine.stats["kernel_backend"] == "torch"


@pytest.mark.parametrize("run", sorted(RUNS))
def test_results_oracle_exact(workload, run):
    mine, _ = workload["runs"][run]
    g = workload["g"]
    for q, r in zip(workload["queries"], mine):
        expect = set(oracle.enumerate_paths_bruteforce(g, q.s, q.t, q.k))
        want = len(expect) if q.limit is None else min(q.limit, len(expect))
        if q.output.value == "paths":
            got = oracle.path_set(r.paths)
            assert len(r.paths) == len(got) == want
            assert got <= expect and (q.limit is not None or got == expect)
        elif q.output.value == "count":
            assert r.count == want
        assert r.exists == bool(expect)


@pytest.mark.parametrize("run,planners", [("auto", None),
                                          ("auto-mixed", ["batch"]),
                                          ("auto-lone", ["basic"])])
def test_auto_routes_equal_reference(workload, run, planners):
    mine, ref = workload["runs"][run]
    assert mine.routes == ref.routes
    for key in ("routed_green", "routed_yellow", "routed_red",
                "cluster_planners", "cluster_routes"):
        assert mine.stats.get(key) == ref.stats.get(key), key
    assert mine.stats.get("cluster_planners") == planners
    assert ("yellow" in mine.routes) == (planners is not None)
    assert "green" in mine.routes and "red" not in mine.routes


def test_plus_split_and_planned_caps_equal_reference(workload):
    """The walk counts drive two host decisions; both must be the
    reference's for every query and direction."""
    e, je = workload["engine"], workload["j_engine"]
    keys = [q.key for q in workload["queries"]]
    index = build_index(e.dg, keys)
    j_index = j_build_index(je.dg, keys, backend="interpret")
    moved = 0
    for qi, (s, t, k) in enumerate(keys):
        got = e._split(qi, index, True)
        assert got == je._split(qi, j_index, True)
        moved += got != e._split(qi, index, False)
        for forward, root, budget in ((True, s, got[0]), (False, t, got[1])):
            slack = e._dedicated_slack(index, qi, forward=forward)
            j_slack = je._dedicated_slack(j_index, qi, forward=forward)
            assert np.array_equal(slack.numpy(), np.asarray(j_slack))
            caps = e._plan_caps(not forward, root, budget, slack)
            assert caps == je._plan_caps(not forward, root, budget, j_slack)
            assert all(c >= e.cfg.min_cap for c in caps)
    assert moved > 0, "no '+' split left the midpoint: the test is blind"


def test_auto_unreachable_query_is_empty():
    # 0 -> 1 -> 2 -> 3: nothing reaches 0, so (3, 0, 3) is empty under
    # every planner; AUTO answers it from the index alone
    src, dst = [0, 1, 2], [1, 2, 3]
    g, jg = Graph.from_edges(4, src, dst), JGraph.from_edges(4, src, dst)
    kinds = [dict(), dict(output="count"), dict(output="exists")]
    mine = PathSession(g, device=CPU).run(
        [PathQuery(3, 0, 3, **kw) for kw in kinds] + [(0, 3, 3)],
        planner="auto")
    ref = JEngine(jg, JConfig(kernel_backend="interpret")).run(
        [JPathQuery(3, 0, 3, **kw) for kw in kinds] + [(0, 3, 3)],
        planner="auto")
    assert mine.routes == ref.routes == ("green",) * 4
    assert mine[0].paths.shape == np.asarray(ref[0].paths).shape == (0, 4)
    assert (mine[1].count, mine[1].exists, mine[2].exists) == \
        (ref[1].count, ref[1].exists, ref[2].exists) == (0, False, False)
    assert np.array_equal(mine[3].paths, [[0, 1, 2, 3]])


def test_auto_keeps_non_green_members_of_given_clusters(workload):
    cfg = EngineConfig(router=RouterConfig(green_max_cost=MIXED_GREEN_MAX))
    jcfg = JConfig(kernel_backend="interpret",
                   router=JRouterConfig(green_max_cost=MIXED_GREEN_MAX))
    n = len(workload["queries"])
    clusters = [list(range(0, n, 2)), list(range(1, n, 2))]
    mine = BatchPathEngine(workload["g"], cfg, device=CPU).run(
        workload["queries"], planner="auto", clusters=clusters)
    ref = JEngine(workload["jg"], jcfg).run(
        workload["ref_queries"], planner="auto", clusters=clusters)
    assert mine.routes == ref.routes
    assert mine.stats["n_clusters"] == ref.stats["n_clusters"] == 2
    _assert_same_results(workload["queries"], mine, ref)


def test_process_warns_and_matches_run(workload):
    e = workload["engine"]
    qs = [q.key for q in workload["queries"][:5]]
    with pytest.warns(DeprecationWarning, match="deprecated"):
        legacy = e.process(qs, mode="batch")
    assert isinstance(legacy, BatchResult)
    report = e.run(qs, planner="batch")
    assert sorted(legacy.paths) == list(range(len(qs)))
    for qi, r in enumerate(report):
        assert np.array_equal(legacy.paths[qi], r.paths)
    assert legacy.stats["n_psi_nodes"] == report.stats["n_psi_nodes"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        e.run(qs)                                 # run itself never warns


def test_run_records_batch_and_query_metrics(workload):
    e = workload["engine"]
    reg = metrics.registry()
    snap = reg.snapshot()
    qs = workload["queries"]
    rep = e.run(qs, planner="auto")
    delta = reg.since(snap)
    labels = (("backend", "torch"), ("planner", "auto"))
    assert delta[("engine_batch_wall_s", labels)].count == 1
    assert delta[("query_latency_s", labels)].count == len(qs)
    assert delta[("routed_green", ())] == rep.stats["routed_green"] == len(qs)
    assert ("routed_yellow", ()) not in delta
