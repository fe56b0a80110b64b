"""The port's engine (Planner.BATCH / BASIC) against the JAX engine.

One batch mixes every output kind (paths / count / exists) and limits; it
runs through ``repro_torch``'s ``PathSession`` on the CPU (the plain
kernel versions) and through the JAX engine with the same
``EngineConfig(plan_caps=False)`` and ``kernel_backend="interpret"``.
Paths, counts, exists flags and the sharing statistics must be equal --
exact equality, all integers -- and every result oracle-exact. The path
rows come out in the reference's order too (stable sorts, the same
compaction order), so rows are compared as arrays, not only as sets.

Also here: the porting hazards of the path buffers and joins (argsort
stability, the compaction dump row, count dtypes), each against the JAX
function on the same inputs, the refusal of every unported option and of
every malformed mesh, and the options ported since (compile telemetry,
span annotations) running.
The default configuration and the other planners are held against the
JAX engine in ``test_torch_planners.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import generators as j_gen  # noqa: E402
from repro.core.delta import GraphDelta as JGraphDelta  # noqa: E402
from repro.core.engine import BatchPathEngine as JEngine  # noqa: E402
from repro.core.engine import EngineConfig as JConfig  # noqa: E402
from repro.core.enumerate import expand_level as j_expand_level  # noqa: E402
from repro.core.join import cross_join as j_cross_join  # noqa: E402
from repro.core.join import keyed_join as j_keyed_join  # noqa: E402
from repro.core.join import keyed_join_count as j_keyed_join_count  # noqa: E402
from repro.core.join import sort_by_last as j_sort_by_last  # noqa: E402
from repro.core.pathset import compact_rows as j_compact_rows  # noqa: E402
from repro.core.pathset import concat as j_concat  # noqa: E402
from repro.core.pathset import PathSet as JPathSet  # noqa: E402
from repro.core.query import PathQuery as JPathQuery  # noqa: E402
from repro_torch.core import (EngineConfig, Graph, GraphDelta,  # noqa: E402
                              PathQuery, PathSession, oracle)
from repro_torch.core.engine import BatchPathEngine  # noqa: E402
from repro_torch.core.enumerate import expand_level, prune_table  # noqa: E402
from repro_torch.core.join import (cross_join, keyed_join,  # noqa: E402
                                   keyed_join_count, sort_by_last)
from repro_torch.core.pathset import (PathSet, compact_rows,  # noqa: E402
                                      concat, to_host)

CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _same(mine, ref):
    return np.array_equal(np.asarray(mine), np.asarray(ref))


# ----------------------------------------------------------------------
# the mixed batch, through both engines
# ----------------------------------------------------------------------

def _batch(jg):
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
    spec = _batch(jg)
    mine = [PathQuery(s, t, k, **kw) for s, t, k, kw in spec]
    ref = [JPathQuery(s, t, k, **kw) for s, t, k, kw in spec]
    session = PathSession(g, EngineConfig(plan_caps=False), device=CPU)
    j_engine = JEngine(jg, JConfig(plan_caps=False,
                                   kernel_backend="interpret"))
    runs = {p: (session.run(mine, planner=p), j_engine.run(ref, planner=p))
            for p in ("batch", "basic")}
    return dict(g=g, jg=jg, queries=mine, session=session, runs=runs)


@pytest.mark.parametrize("planner", ["batch", "basic"])
def test_results_equal_reference(workload, planner):
    mine, ref = workload["runs"][planner]
    for q, a, b in zip(workload["queries"], mine, ref):
        if q.output.value == "paths":
            assert a.paths.dtype == np.int32
            # same rows in the same order (stronger than sorted rows)
            assert _same(a.paths, b.paths), q
            assert oracle.path_set(a.paths) == oracle.path_set(b.paths)
            assert a.count == b.count
        elif q.output.value == "count":
            assert a.count == b.count, q
        assert a.exists == b.exists, q


@pytest.mark.parametrize("planner", ["batch", "basic"])
def test_stats_equal_reference(workload, planner):
    mine, ref = workload["runs"][planner]
    keys = ["n_rows_assembled", "n_queries"]
    if planner == "batch":
        keys += ["n_clusters", "n_psi_nodes", "n_materialized", "n_shared",
                 "n_dedup", "n_share_edges", "mu_mean"]
    for key in keys:
        assert mine.stats[key] == ref.stats[key], key
    assert mine.stats["kernel_backend"] == "torch"
    for key in ("t_build_index", "t_enumerate", "t_wall_s"):
        assert mine.stats[key] >= 0.0
    if planner == "batch":
        assert mine.stats["n_psi_nodes"] > len(workload["queries"])


@pytest.mark.parametrize("planner", ["batch", "basic"])
def test_results_oracle_exact(workload, planner):
    mine, _ = workload["runs"][planner]
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


def test_batch_equals_basic(workload):
    batch, _ = workload["runs"]["batch"]
    basic, _ = workload["runs"]["basic"]
    for q, a, b in zip(workload["queries"], batch, basic):
        if q.output.value == "paths" and q.limit is None:
            assert oracle.path_set(a.paths) == oracle.path_set(b.paths)


def test_reference_default_plan_caps_same_path_sets(workload):
    # the JAX default (walk-count capacity planning) sizes buffers only:
    # the same path sets as this port's plan_caps=False
    queries = [q for q in workload["queries"]
               if q.output.value == "paths" and q.limit is None]
    ref = JEngine(workload["jg"], JConfig(kernel_backend="interpret")).run(
        [JPathQuery(q.s, q.t, q.k) for q in queries], planner="batch")
    mine = workload["session"].run(queries, planner="batch")
    for a, b in zip(mine, ref):
        assert oracle.path_set(a.paths) == oracle.path_set(b.paths)


def test_overflow_retry_gives_the_same_answer(workload):
    # tiny starting capacities force the x4 overflow retry on every level
    g, queries = workload["g"], workload["queries"][:4]
    small = PathSession(g, EngineConfig(plan_caps=False, min_cap=4,
                                        join_cap=8), device=CPU)
    base, _ = workload["runs"]["batch"]
    got = small.run(queries)
    for q, a, b in zip(queries, got, base):
        if q.output.value == "paths":
            assert oracle.path_set(a.paths) == oracle.path_set(b.paths)
        assert a.exists == b.exists


def test_empty_batch_and_precomputed_clusters(workload):
    session = workload["session"]
    assert len(session.run([])) == 0
    qs = [q.key for q in workload["queries"][:4]]
    rep = session.run(qs, clusters=[[0, 2], [1, 3]])
    assert rep.stats["n_clusters"] == 2
    with pytest.raises(ValueError, match="partition"):
        session.run(qs, clusters=[[0, 1]])


# ----------------------------------------------------------------------
# unported options raise, never degrade; the ported ones run
# ----------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(plan_caps=False, edge_chunk=1 << 20),
])
def test_unported_options_raise(workload, cfg):
    with pytest.raises(NotImplementedError, match="not ported"):
        BatchPathEngine(workload["g"], EngineConfig(**cfg), device=CPU)


def test_log_compiles_reports_telemetry(workload):
    # the JAX engine's fields; on the CPU nothing is built or loaded
    eng = BatchPathEngine(workload["g"],
                          EngineConfig(plan_caps=False, log_compiles=True),
                          device=CPU)
    assert eng.compile_log is not None
    base, _ = workload["runs"]["batch"]
    for _ in range(2):
        rep = eng.run(workload["queries"])
        assert (rep.stats["n_compiles"], rep.stats["n_retraces"],
                rep.stats["compiled_kernels"]) == (0, 0, {})
        _same_answers(workload["queries"], rep, base)


def test_trace_annotations_run_under_record_function(workload):
    from repro_torch.obs import trace as obstrace
    eng = BatchPathEngine(workload["g"],
                          EngineConfig(plan_caps=False, trace=True,
                                       trace_annotations=True), device=CPU)
    try:
        assert eng.obs.annotator is torch.profiler.record_function
        rep = eng.run(workload["queries"])
    finally:
        obstrace.tracer().configure(enabled=False, annotator=None)
        obstrace.tracer().reset()
    base, _ = workload["runs"]["batch"]
    _same_answers(workload["queries"], rep, base)


def _same_answers(queries, got, want):
    for q, a, b in zip(queries, got, want):
        assert a.exists == b.exists, q
        if q.output.value != "exists":
            assert a.count == b.count, q


# a mesh is a device list of the engine's type, entry 0 its own device;
# n_devices counts local devices (the CPU is one)
@pytest.mark.parametrize("cfg,error,match", [
    (dict(mesh=object()), TypeError, "sequence of torch devices"),
    (dict(n_devices=2), ValueError, "only 1 local cpu devices"),
    (dict(mesh="cpu"), TypeError, "sequence of torch devices"),
    (dict(mesh=[object()]), TypeError, "not a torch device"),
    (dict(mesh=[]), ValueError, "empty"),
    (dict(mesh=["cpu", "nodevice"]), ValueError, "nodevice"),
    (dict(mesh=["cuda:0"]), ValueError, "not a cpu device"),
    (dict(n_devices=-1), ValueError, "negative"),
    (dict(n_devices="2"), TypeError, "must be an int"),
])
def test_bad_meshes_raise(workload, cfg, error, match):
    with pytest.raises(error, match=match):
        BatchPathEngine(workload["g"], EngineConfig(plan_caps=False, **cfg),
                        device=CPU)


@pytest.mark.parametrize("cfg", [
    dict(delta_max_sources=64),
    dict(delta_max_sources=2),
    dict(delta_backend="msbfs"),
    # any value other than "host" selects the MS-BFS sweep, as in the
    # reference
    dict(delta_backend="device"),
])
def test_delta_options_act_like_reference(workload, cfg):
    """The delta knobs are ported: a delta near the first query gives the
    JAX engine's report (less its wall time) and its path rows after."""
    jg = workload["jg"]
    qs = [q.key for q in workload["queries"]][:6]
    full = dict(plan_caps=False, cache_bytes=1 << 24, **cfg)
    eng = BatchPathEngine(workload["g"], EngineConfig(**full), device=CPU)
    j_eng = JEngine(jg, JConfig(kernel_backend="jnp", **full))
    eng.run(qs)
    j_eng.run(qs)
    s, _, _ = qs[0]
    u = int(workload["g"].neighbors(s)[0])
    w = int(workload["g"].neighbors(u)[-1])
    pairs = dict(add=[(s, w)], remove=[(s, u)])
    rep = eng.apply_delta(GraphDelta.from_pairs(**pairs))
    j_rep = j_eng.apply_delta(JGraphDelta.from_pairs(**pairs))
    rep.pop("t_apply_s")
    j_rep.pop("t_apply_s")
    assert rep == j_rep
    assert rep["cache_mode"] == ("full" if cfg.get("delta_max_sources") == 2
                                 else "delta")
    for a, b in zip(eng.run(qs), j_eng.run(qs)):
        assert np.array_equal(a.paths, np.asarray(b.paths))


def test_kernel_backend_must_agree_with_device(workload):
    with pytest.raises(ValueError, match="cannot run on"):
        PathSession(workload["g"], EngineConfig(plan_caps=False),
                    device=CPU, kernel_backend="cuda")
    s = PathSession(workload["g"], EngineConfig(plan_caps=False),
                    device=CPU, kernel_backend="torch")
    assert s.kernel_backend == "torch" and s.device.type == "cpu"


# ----------------------------------------------------------------------
# porting hazards: path buffers and joins against the JAX functions
# ----------------------------------------------------------------------

def _simple_rows(r, N, L, hi):
    return np.stack([r.choice(hi, size=L, replace=False) for _ in range(N)]
                    ).astype(np.int32)


@pytest.mark.parametrize("N,cap,p,seed", [(40, 16, 0.5, 0), (40, 64, 0.3, 1),
                                          (10, 4, 0.0, 2), (0, 8, 0.5, 3)])
def test_compact_rows_dump_row(N, cap, p, seed):
    r = np.random.default_rng(seed)
    mask = r.random(N) < p
    payload = r.integers(0, 99, (N, 3)).astype(np.int32)
    out, count, ovf = compact_rows(_t(mask), _t(payload), cap)
    assert count.dtype == torch.int64        # one declared count dtype
    if N == 0:   # the reference cannot take an empty mask (pos[-1])
        assert bool((out == -1).all()) and int(count) == 0 and not bool(ovf)
        return
    j_out, j_count, j_ovf = j_compact_rows(jnp.asarray(mask),
                                           jnp.asarray(payload), cap)
    assert _same(out, j_out)
    assert int(count) == int(j_count) and bool(ovf) == bool(j_ovf)


def test_concat_matches_reference():
    r = np.random.default_rng(4)
    parts = []
    for cap, cnt in ((6, 4), (3, 0), (5, 5)):
        v = np.full((cap, 4), -1, np.int32)
        v[:cnt] = r.integers(0, 50, (cnt, 4))
        parts.append((v, cnt))
    mine = concat([PathSet(_t(v), torch.tensor(c), torch.tensor(False))
                   for v, c in parts])
    ref = j_concat([JPathSet(jnp.asarray(v), jnp.int32(c), jnp.bool_(False))
                    for v, c in parts])
    assert _same(mine.verts, ref.verts) and int(mine.count) == int(ref.count)
    assert _same(to_host(mine), np.asarray(ref.verts)[:int(ref.count)])


def test_sort_by_last_is_stable():
    r = np.random.default_rng(5)
    verts = r.integers(0, 4, (64, 3)).astype(np.int32)   # many equal keys
    mine = sort_by_last(_t(verts), torch.tensor(50), col=2)
    ref = j_sort_by_last(jnp.asarray(verts), jnp.int32(50), col=2)
    assert _same(mine.verts, ref.verts) and _same(mine.keys, ref.keys)


@pytest.mark.parametrize("NA,NB,a_col,b_col,cap,seed", [
    (30, 25, 2, 1, 256, 0), (40, 40, 1, 2, 16, 1), (5, 7, 3, 3, 64, 2)])
def test_keyed_joins_match_reference(NA, NB, a_col, b_col, cap, seed):
    r = np.random.default_rng(seed)
    A = _simple_rows(r, NA, a_col + 1, 12)
    B = _simple_rows(r, NB, b_col + 1, 12)
    width = a_col + b_col + 1
    sa = sort_by_last(_t(A), torch.tensor(NA - 2), col=a_col)
    j_sa = j_sort_by_last(jnp.asarray(A), jnp.int32(NA - 2), col=a_col)
    mine = keyed_join(sa, _t(B), torch.tensor(NB), a_col=a_col, b_col=b_col,
                      out_cap=cap, out_width=width)
    ref = j_keyed_join(j_sa, jnp.asarray(B), jnp.int32(NB), a_col=a_col,
                       b_col=b_col, out_cap=cap, out_width=width,
                       backend="interpret")
    assert _same(mine.verts, ref.verts)
    assert int(mine.count) == int(ref.count)
    assert bool(mine.overflow) == bool(ref.overflow)
    n, ovf = keyed_join_count(sa, _t(B), torch.tensor(NB), a_col=a_col,
                              b_col=b_col, pair_cap=cap)
    j_n, j_ovf = j_keyed_join_count(j_sa, jnp.asarray(B), jnp.int32(NB),
                                    a_col=a_col, b_col=b_col, pair_cap=cap,
                                    backend="interpret")
    assert int(n) == int(j_n) and bool(ovf) == bool(j_ovf)


@pytest.mark.parametrize("NP,NC,p_col,c_col,cap,seed", [
    (20, 15, 1, 2, 512, 0), (30, 30, 2, 0, 64, 1), (3, 1, 0, 1, 8, 2)])
def test_cross_join_matches_reference(NP, NC, p_col, c_col, cap, seed):
    r = np.random.default_rng(seed)
    P = _simple_rows(r, NP, p_col + 1, 20)
    C = _simple_rows(r, NC, c_col + 1, 20)
    width = p_col + c_col + 2
    mine = cross_join(_t(P), torch.tensor(NP), _t(C), torch.tensor(NC),
                      p_col=p_col, c_col=c_col, out_cap=cap, out_width=width)
    ref = j_cross_join(jnp.asarray(P), jnp.int32(NP), jnp.asarray(C),
                       jnp.int32(NC), p_col=p_col, c_col=c_col, out_cap=cap,
                       out_width=width, backend="interpret")
    assert _same(mine.verts, ref.verts)
    assert int(mine.count) == int(ref.count)
    assert bool(mine.overflow) == bool(ref.overflow)


@pytest.mark.parametrize("out_cap", [1024, 8])
def test_expand_level_matches_reference(out_cap):
    r = np.random.default_rng(6)
    n, D, cap, level, budget = 40, 4, 32, 2, 5
    ell = r.integers(0, n + 1, (n, D)).astype(np.int32)
    verts = np.full((cap, budget + 1), -1, np.int32)
    verts[:, :level + 1] = _simple_rows(r, cap, level + 1, n)
    slack = r.integers(-1, 6, n + 1).astype(np.int8)
    splice = np.where(r.random(n + 1) < 0.1, 4, -1).astype(np.int8)
    slack[-1] = splice[-1] = -1
    count = 27
    mine = expand_level(_t(verts), torch.tensor(count), _t(ell),
                        prune_table(_t(slack), _t(splice)), 7,
                        level=level, budget=budget, out_cap=out_cap)
    ref = j_expand_level(jnp.asarray(verts), jnp.int32(count),
                         jnp.asarray(ell),
                         jnp.stack([jnp.asarray(slack), jnp.asarray(splice)],
                                   axis=1),
                         jnp.int32(7), level=level, budget=budget,
                         out_cap=out_cap, backend="interpret")
    assert _same(mine.frontier.verts, ref.frontier.verts)
    assert int(mine.frontier.count) == int(ref.frontier.count)
    assert bool(mine.frontier.overflow) == bool(ref.frontier.overflow)
    assert _same(mine.nbrs, ref.nbrs)
    assert _same(mine.splice_hit, ref.splice_hit)
