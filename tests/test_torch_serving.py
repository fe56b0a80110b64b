"""The port's streaming server against the JAX package's.

The scenarios of ``tests/test_serving_slo.py`` run through both packages
side by side: the port on the CPU (the plain kernel versions), the JAX
engine with ``kernel_backend="jnp"``. Each server reads "now" from a
model clock that charges a fixed cost per dispatch (``advance_batch``),
so admission is deterministic and the two timelines are one. Then:

* the scheduler sees the same clusters of query ids in the same order
  (admission order, batch cuts and clustering);
* every qid resolves to the same result: the same path rows in the same
  order, counts and exists flags, or the same typed SHED reason;
* every ``batch_log`` entry is equal except its real walls
  (``wall_s``, ``t_assemble_s``) and ``kernel_backend`` (the reference
  names its backend, the port its kernel arm); latencies on the model
  clock are compared too;
* ``delta_log`` is equal except ``t_apply_s``.

All of it is integers or floats computed from equal inputs in the same
order: the tolerance is exact equality.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import generators as j_gen  # noqa: E402
from repro.core.delta import GraphDelta as JGraphDelta  # noqa: E402
from repro.core.engine import BatchPathEngine as JEngine  # noqa: E402
from repro.core.engine import EngineConfig as JConfig  # noqa: E402
from repro.core.query import PathQuery as JPathQuery  # noqa: E402
from repro.core.session import PathSession as JPathSession  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro_torch.core import (BatchPathEngine, EngineConfig,  # noqa: E402
                              Graph, GraphDelta, PathQuery, PathSession,
                              ResultStatus, oracle)
from repro_torch.launch import serve  # noqa: E402

CPU = "cpu"
# the model clock's charge per dispatch: a fixed cost and one per query
C0, C1 = 1.0, 0.125
# batch_log fields measured on the host clock, and the field that names
# each package's own kernel backend
UNEQUAL = ("wall_s", "t_assemble_s", "kernel_backend")
# and the latencies, where a server reads the host's clock
ON_HOST_CLOCK = UNEQUAL + ("admission_wait_p50_s", "admission_wait_max_s",
                           "e2e_p50_s", "e2e_p99_s")


def model_clock():
    """exp11's clock: ``C0 + C1 * n`` per dispatch of n queries, whatever
    the dispatch took (the port's copy serves both servers)."""
    return serve.ServiceModelClock(C0, C1)


@pytest.fixture(scope="module")
def graphs():
    jg = j_gen.community(300, n_comm=3, avg_deg=5.0, seed=0)
    g = Graph.from_arrays(jg.n, jg.indptr, jg.indices, jg.r_indptr,
                          jg.r_indices)
    return g, jg


def _queries(jg, n, seed=1, k=(3, 4), **kw):
    return [(int(s), int(t), int(kk), kw)
            for s, t, kk in j_gen.random_queries(jg, n, k, seed=seed)]


class Twin:
    """One streaming server of each package on the same graph, policy and
    (separate but identical) model clocks; every call goes to both."""

    def __init__(self, graphs, policy=None, engine_kw=None, **server_kw):
        g, jg = graphs
        kw = dict(min_cap=64, **(engine_kw or {}))
        self.engine = BatchPathEngine(g, EngineConfig(**kw), device=CPU)
        self.j_engine = JEngine(jg, JConfig(kernel_backend="jnp", **kw))
        self.clock, self.j_clock = model_clock(), model_clock()
        policy = dict(policy or {})
        self.srv = serve.StreamingServer(
            self.engine, clock=self.clock,
            policy=serve.AdmissionPolicy(**policy), **server_kw)
        self.j_srv = j_serve.StreamingServer(
            self.j_engine, clock=self.j_clock,
            policy=j_serve.AdmissionPolicy(**policy), **server_kw)
        self.admitted, self.j_admitted = [], []
        for srv, log in ((self.srv, self.admitted),
                         (self.j_srv, self.j_admitted)):
            submit = srv.sched.submit

            def record(clusters, submit=submit, log=log):
                log.append([list(cl) for cl in clusters])
                return submit(clusters)
            srv.sched.submit = record

    def submit(self, s, t, k, kw=None, now=None):
        kw = kw or {}
        qid = self.srv.submit(PathQuery(s, t, k, **kw), now)
        assert self.j_srv.submit(JPathQuery(s, t, k, **kw), now) == qid
        return qid

    def delta(self, **pairs):
        self.srv.apply_delta(GraphDelta.from_pairs(**pairs))
        self.j_srv.apply_delta(JGraphDelta.from_pairs(**pairs))

    def both(self, fn):
        a, b = fn(self.srv), fn(self.j_srv)
        assert a == b
        return a

    def advance(self, dt):
        self.clock.advance(dt)
        self.j_clock.advance(dt)

    def check(self):
        """Everything the two servers did so far is equal."""
        assert self.admitted == self.j_admitted
        assert sorted(self.srv.results) == sorted(self.j_srv.results)
        for qid, r in self.srv.results.items():
            _same_result(r, self.j_srv.results[qid])
        assert len(self.srv.batch_log) == len(self.j_srv.batch_log)
        for a, b in zip(self.srv.batch_log, self.j_srv.batch_log):
            assert a["kernel_backend"] == "torch"
            assert _drop(a, UNEQUAL) == _drop(b, UNEQUAL)
        assert [_drop(d, ("t_apply_s",)) for d in self.srv.delta_log] == \
            [_drop(d, ("t_apply_s",)) for d in self.j_srv.delta_log]
        for name in ("n_shed", "n_deadline_miss", "n_failovers",
                     "n_fast_path", "dead_groups", "_service_ewma"):
            assert getattr(self.srv, name) == getattr(self.j_srv, name), \
                name
        for name in ("steals", "failovers", "requeued"):
            assert getattr(self.srv.sched, name) == \
                getattr(self.j_srv.sched, name), name
        assert self.clock.t == self.j_clock.t
        assert self.clock.dispatches == self.j_clock.dispatches


def _drop(d, keys):
    return {k: v for k, v in d.items() if k not in keys}


def _same_result(mine, ref):
    assert mine.status.value == ref.status.value
    assert mine.shed_reason == ref.shed_reason
    if mine.status is ResultStatus.SHED:
        return
    q = mine.query
    assert q.key == ref.query.key and q.output.value == ref.query.output.value
    if q.output.value == "paths":
        assert np.array_equal(mine.paths, np.asarray(ref.paths)), q
    elif q.output.value == "count":
        assert mine.count == ref.count, q
    assert mine.exists == ref.exists, q


# ----------------------------------------------------------------------
# admission policy (pure functions, both packages)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    (3, 0.05, None), (3, 0.2, None), (3, 0.0, -0.01), (3, 0.0, 0.5),
    (0, 99.0, None), (8, 0.0, None), (32, 0.0, None), (40, 0.0, 0.1),
])
def test_due_equals_reference(args):
    kw = dict(max_batch=32, min_batch=8, max_delay_s=0.1)
    assert serve.AdmissionPolicy(**kw).due(*args) == \
        j_serve.AdmissionPolicy(**kw).due(*args)


def test_order_key_weighted_fairness_and_edf():
    weights = {"gold": 4.0, "silver": 2.0}
    pol = serve.AdmissionPolicy(tenant_weights=weights)
    j_pol = j_serve.AdmissionPolicy(tenant_weights=weights)
    cases = [("gold", 1.0, None), ("bronze", 1.0, None),
             ("bronze", 5.0, None), ("silver", 0.3, 5.0),
             ("gold", 99.0, None), ("bronze", 0.1, 2.0)]
    keys = [pol.order_key(PathQuery(0, 1, 3, tenant=t), w, d)
            for t, w, d in cases]
    assert keys == [j_pol.order_key(JPathQuery(0, 1, 3, tenant=t), w, d)
                    for t, w, d in cases]
    # deadline queries first (EDF), then decreasing weighted wait
    assert keys[5] < keys[3] < keys[4] < keys[2] < keys[0] < keys[1]


def test_service_model_clock_equals_the_benchmarks():
    from benchmarks.exp11_open_loop import ServiceModelClock as JClock
    mine, ref = serve.ServiceModelClock(0.3, 0.02), JClock(0.3, 0.02)
    for clock in (mine, ref):
        clock.advance(1.5)
        for n in (16, 4, 1, 9):
            clock.advance_batch(123.0, n)
    assert (mine(), mine.dispatches) == (ref(), ref.dispatches)
    assert isinstance(mine, serve.VirtualClock)


# ----------------------------------------------------------------------
# the scenarios of test_serving_slo.py, through both packages
# ----------------------------------------------------------------------

def test_overload_sheds_paths_and_fast_paths_cheap_outputs(graphs):
    tw = Twin(graphs, policy=dict(max_batch=8, max_delay_s=math.inf,
                                  min_batch=64, max_queue=2))
    qs = _queries(graphs[1], 5)
    qids = [tw.submit(*q[:3]) for q in qs[:3]]
    assert tw.srv.results[qids[2]].shed_reason == "overload"
    qid_e = tw.submit(*qs[3][:3], dict(output="exists"))
    qid_c = tw.submit(*qs[4][:3], dict(output="count"))
    for qid in (qid_e, qid_c):
        assert tw.srv.results[qid].ok
    assert tw.srv.n_shed == 1
    tw.check()
    tw.srv.drain()
    tw.j_srv.drain()
    assert len(tw.srv.results) == 5
    tw.check()


def test_take_returns_shed_result_once(graphs):
    tw = Twin(graphs, policy=dict(max_batch=4, min_batch=4,
                                  max_delay_s=math.inf, max_queue=0))
    qid = tw.submit(*_queries(graphs[1], 1)[0][:3])
    tw.check()
    r = tw.srv.take(qid)
    assert r.status is ResultStatus.SHED and r.shed_reason == "overload"
    with pytest.raises(KeyError):
        tw.srv.take(qid)


@pytest.mark.parametrize("shed_expired", [True, False])
def test_expired_deadline(graphs, shed_expired):
    tw = Twin(graphs, policy=dict(max_batch=8, min_batch=1,
                                  max_delay_s=10.0,
                                  shed_expired=shed_expired))
    q = _queries(graphs[1], 3)
    qid_dead = tw.submit(*q[0][:3], dict(deadline_s=1.0))
    qid_live = tw.submit(*q[1][:3])
    qid_late = tw.submit(*q[2][:3], dict(deadline_s=2.0, tenant="gold"))
    tw.advance(5.0)          # every deadline long gone before admission
    tw.both(lambda s: s.drain())
    tw.check()
    assert tw.srv.results[qid_live].ok
    if shed_expired:
        assert tw.srv.results[qid_dead].shed_reason == "deadline"
        assert tw.srv.results[qid_late].shed_reason == "deadline"
        assert tw.srv.n_shed == 2
    else:
        # executed anyway, but counted as SLO misses
        assert tw.srv.results[qid_dead].ok and tw.srv.results[qid_late].ok
        assert tw.srv.n_deadline_miss == 2


def test_spent_slack_cuts_batch_before_min_batch(graphs):
    tw = Twin(graphs, policy=dict(max_batch=64, min_batch=64,
                                  max_delay_s=math.inf))
    for srv in (tw.srv, tw.j_srv):
        srv._service_ewma = 1.5     # as if recent batches took 1.5 s
    q = _queries(graphs[1], 1)[0]
    tw.submit(*q[:3], dict(deadline_s=2.0))
    assert not tw.both(lambda s: s.pump())   # 0.5 s of slack remains
    tw.advance(0.7)
    assert tw.both(lambda s: s.pump())       # slack spent: cut, not shed
    assert len(tw.srv.batch_log) == 1
    assert all(r.ok for r in tw.srv.results.values())
    tw.check()


def test_weighted_tenant_admitted_first_under_contention(graphs):
    tw = Twin(graphs, policy=dict(max_batch=4, min_batch=1,
                                  max_delay_s=0.1,
                                  tenant_weights={"gold": 8.0}))
    for i, q in enumerate(_queries(graphs[1], 8, seed=3)):
        tw.submit(*q[:3], dict(tenant="gold" if i % 2 else "bronze"))
    tw.advance(0.2)
    tw.both(lambda s: s.pump())
    assert tw.srv.batch_log[0]["tenants"] == {"gold": 4}
    tw.both(lambda s: s.drain())
    assert len(tw.srv.results) == 8          # bronze still served
    tw.check()


def test_edf_orders_deadlines_across_tenants(graphs):
    tw = Twin(graphs, policy=dict(max_batch=3, min_batch=1,
                                  max_delay_s=0.1,
                                  tenant_weights={"gold": 4.0,
                                                  "silver": 2.0}))
    tenants = ("gold", "silver", "bronze")
    for i, q in enumerate(_queries(graphs[1], 9, seed=8)):
        kw = dict(tenant=tenants[i % 3])
        if i % 3 == 1:
            kw["deadline_s"] = 30.0 - i
        tw.submit(*q[:3], kw, now=0.01 * i)
    tw.advance(0.2)
    tw.both(lambda s: s.drain())
    tw.check()
    # the first batch holds the three deadline queries (EDF beats the
    # weighted waits of gold)
    assert sorted(q for cl in tw.admitted[0] for q in cl) == [1, 4, 7]
    assert tw.srv.batch_log[0]["tenants"] == {"silver": 3}


def test_advance_batch_protocol(graphs):
    tw = Twin(graphs, policy=dict(max_batch=4, min_batch=1,
                                  max_delay_s=0.0))
    for q in _queries(graphs[1], 3, seed=4):
        tw.submit(*q[:3])
    tw.both(lambda s: s.drain())
    tw.check()
    # the model charges C0 + C1 * n per dispatch, never the real wall
    assert tw.clock() == tw.clock.dispatches * C0 + 3 * C1
    # e2e on the model timeline: wait + charged service, never real wall
    assert tw.srv.batch_log[-1]["e2e_p50_s"] >= C0


def test_auto_fast_path_answers_exists_at_submit(graphs):
    tw = Twin(graphs, policy=dict(max_batch=8, min_batch=8,
                                  max_delay_s=math.inf), planner="auto")
    qs = _queries(graphs[1], 4, seed=9)
    qid_e = tw.submit(*qs[0][:3], dict(output="exists"))
    assert qid_e in tw.srv.results and tw.srv.n_fast_path == 1
    for q in qs[1:]:
        tw.submit(*q[:3], dict(output="count"))
    tw.both(lambda s: s.drain())
    tw.check()


def test_group_failure_requeues_and_results_land_exactly_once(graphs):
    tw = Twin(graphs, policy=dict(max_batch=16, min_batch=1,
                                  max_delay_s=0.0),
              engine_kw=dict(cache_bytes=32 << 20), n_groups=3, gamma=0.9)

    def injector_for(cls):
        state = {"n": 0}

        def injector(grp, item):
            if grp == 0:
                state["n"] += 1
                if state["n"] == 2:      # die executing the second item
                    raise cls(grp)
        return injector

    tw.srv.fail_injector = injector_for(serve.GroupFailure)
    tw.j_srv.fail_injector = injector_for(j_serve.GroupFailure)
    qids = [tw.submit(*q[:3]) for q in _queries(graphs[1], 16, seed=5)]
    tw.both(lambda s: s.drain())
    tw.check()
    assert tw.srv.n_failovers == 1 and tw.srv.dead_groups == {0}
    assert tw.srv.sched.requeued >= 1
    assert sorted(tw.srv.results) == sorted(qids)
    assert all(tw.srv.results[qid].ok for qid in qids)
    log = tw.srv.batch_log[-1]
    assert log["failovers"] == 1 and log["requeued"] >= 1
    assert tw.engine.cache.info()["entries"] > 0


def test_failover_results_are_oracle_exact(graphs):
    g = graphs[0]
    srv = serve.StreamingServer(
        BatchPathEngine(g, EngineConfig(min_cap=64, cache_bytes=1 << 24),
                        device=CPU),
        n_groups=2, clock=model_clock(),
        policy=serve.AdmissionPolicy(max_batch=8, min_batch=1,
                                     max_delay_s=0.0))
    seen = []

    def injector(grp, item):
        seen.append((grp, item.cluster_id))
        if len(seen) == 1:
            raise serve.GroupFailure(grp)

    srv.fail_injector = injector
    qs = _queries(graphs[1], 8, seed=12)
    qids = [srv.submit(q[:3]) for q in qs]
    srv.drain()
    assert srv.n_failovers == 1 and sorted(srv.results) == qids
    for qid, (s, t, k, _) in zip(qids, qs):
        expect = oracle.path_set(oracle.enumerate_paths_bruteforce(g, s, t,
                                                                   k))
        assert oracle.path_set(srv.results[qid].paths) == expect


def test_all_groups_dead_raises(graphs):
    tw = Twin(graphs, policy=dict(max_batch=4, min_batch=1,
                                  max_delay_s=0.0), n_groups=2)

    def injector_for(cls):
        def injector(grp, item):
            raise cls(grp)
        return injector

    tw.srv.fail_injector = injector_for(serve.GroupFailure)
    tw.j_srv.fail_injector = injector_for(j_serve.GroupFailure)
    tw.submit(*_queries(graphs[1], 1, seed=6)[0][:3])
    for srv in (tw.srv, tw.j_srv):
        with pytest.raises(RuntimeError, match="dead"):
            srv.drain()
    assert tw.srv.dead_groups == tw.j_srv.dead_groups == {0, 1}


def test_other_errors_are_not_failovers(graphs):
    """Only GroupFailure marks a group dead; any other error propagates
    (a kernel that fails to build or launch must never pass for a replica
    failure)."""
    tw = Twin(graphs, policy=dict(max_batch=4, min_batch=1,
                                  max_delay_s=0.0))

    def injector(grp, item):
        raise OSError("kernel build failed")

    tw.srv.fail_injector = injector
    tw.srv.submit(PathQuery(*_queries(graphs[1], 1, seed=6)[0][:3]))
    with pytest.raises(OSError, match="kernel build"):
        tw.srv.drain()
    assert tw.srv.n_failovers == 0 and not tw.srv.dead_groups


def test_revive_group_serves_again(graphs):
    tw = Twin(graphs, policy=dict(max_batch=4, min_batch=1,
                                  max_delay_s=0.0), n_groups=2)
    tw.both(lambda s: s.kill_group(0))
    assert tw.srv.n_failovers == 1
    qs = _queries(graphs[1], 2, seed=7)
    tw.submit(*qs[0][:3])
    tw.both(lambda s: s.drain())       # group 1 carries the batch alone
    tw.both(lambda s: s.revive_group(0))
    tw.submit(*qs[1][:3])
    tw.both(lambda s: s.drain())
    assert len(tw.srv.results) == 2
    assert all(r.ok for r in tw.srv.results.values())
    tw.check()


def test_stream_with_delta_in_the_middle(graphs):
    g, jg = graphs
    tw = Twin(graphs, policy=dict(max_batch=4, min_batch=2,
                                  max_delay_s=0.5),
              engine_kw=dict(cache_bytes=1 << 24))
    qs = _queries(jg, 12, seed=10, k=(3, 5))
    outputs = ({}, dict(output="count"), dict(output="exists"))
    s0, t0, _, _ = qs[0]
    u = int(g.neighbors(s0)[0])
    for i, q in enumerate(qs):
        tw.submit(*q[:3], outputs[i % 3], now=0.1 * i)
        if i == 5:
            # a delta that cuts the first query's first edge and adds one
            tw.delta(remove=[(s0, u)], add=[(u, s0), (s0, t0)])
        tw.both(lambda s: s.pump())
    tw.both(lambda s: s.drain())
    tw.check()
    assert len(tw.srv.delta_log) == 1 and tw.srv.delta_log[0]["n_added"]
    assert sum(b["n_deltas"] for b in tw.srv.batch_log) == 1
    # results after the delta are exact on the new graph
    g_new = tw.engine.g
    for qid in range(6, len(qs)):
        r = tw.srv.results[qid]
        if r.query.output.value == "paths":
            s, t, k = r.query.key
            expect = oracle.path_set(
                oracle.enumerate_paths_bruteforce(g_new, s, t, k))
            assert oracle.path_set(r.paths) == expect


# ----------------------------------------------------------------------
# the session facade, serve_batch and the results backlog
# ----------------------------------------------------------------------

def test_session_streaming_equals_reference(graphs):
    g, jg = graphs
    kw = dict(n_groups=2, clock=model_clock(),
              policy=serve.AdmissionPolicy(max_batch=4, min_batch=2,
                                           max_delay_s=0.5))
    sess = PathSession(g, EngineConfig(min_cap=64, cache_bytes=1 << 24),
                       device=CPU, **kw)
    j_sess = JPathSession(
        jg, JConfig(min_cap=64, cache_bytes=1 << 24, kernel_backend="jnp"),
        n_groups=2, clock=model_clock(),
        policy=j_serve.AdmissionPolicy(max_batch=4, min_batch=2,
                                       max_delay_s=0.5))
    assert sess.batch_log == [] and sess.results() == {}
    qs = _queries(jg, 6, seed=11)
    qids = [sess.submit(PathQuery(*q[:3])) for q in qs]
    assert qids == [j_sess.submit(JPathQuery(*q[:3])) for q in qs]
    assert sess.pump() == j_sess.pump()
    early = sess.results(drain=False)
    assert sorted(early) == sorted(j_sess.results(drain=False))
    rest = sess.results()
    j_rest = j_sess.results()
    assert sorted(rest) == sorted(j_rest)
    assert sorted(early) + sorted(rest) == sorted(qids)
    for qid, r in rest.items():
        _same_result(r, j_rest[qid])
    assert [_drop(b, UNEQUAL) for b in sess.batch_log] == \
        [_drop(b, UNEQUAL) for b in j_sess.batch_log]
    qid = sess.submit(PathQuery(*qs[0][:3]))
    sess.pump()
    sess.server.drain()
    assert sess.result(qid).ok
    with pytest.raises(KeyError):
        sess.result(qid)


def test_session_delta_queues_until_a_batch_boundary(graphs):
    g, jg = graphs
    sess = PathSession(g, EngineConfig(min_cap=64), device=CPU,
                       clock=model_clock())
    s, t, k, _ = next(q for q in _queries(jg, 8, seed=13)
                      if q[1] not in g.neighbors(q[0]))

    def has_edge():
        return t in sess.engine.g.neighbors(s)

    # batch mode: applied now, report returned
    rep = sess.apply_delta(GraphDelta.from_pairs(add=[(s, t)]))
    assert rep["n_added"] == 1 and has_edge()
    # streaming mode: queued, applied by the next run (a batch boundary)
    sess.submit(PathQuery(s, t, k))
    assert sess.apply_delta(GraphDelta.from_pairs(remove=[(s, t)])) is None
    assert has_edge()
    after = sess.run([(s, t, k)])
    assert not has_edge() and len(sess.server.delta_log) == 1
    expect = oracle.path_set(oracle.enumerate_paths_bruteforce(
        sess.engine.g, s, t, k))
    assert oracle.path_set(after[0].paths) == expect
    assert (s, t) not in expect
    # update_graph discards queued deltas expressed against the old graph
    sess.apply_delta(GraphDelta.from_pairs(add=[(s, t)]))
    sess.update_graph(g)
    assert sess.server.discard_pending_deltas() == []
    assert len(sess.results()) == 1 and not has_edge()
    assert len(sess.server.delta_log) == 1


@pytest.mark.parametrize("output", ["paths", "count", "exists"])
def test_backlog_holds_no_device_tensors(graphs, output):
    g, jg = graphs
    sess = PathSession(g, EngineConfig(min_cap=64), device=CPU)
    for q in _queries(jg, 4, seed=14):
        sess.submit(PathQuery(*q[:3], output=output))
    sess.server.drain()
    for r in sess.server.results.values():
        held = [v for v in vars(r).values()] + (
            [getattr(r._store, a) for a in r._store.__slots__]
            if r._store is not None else [])
        assert not any(isinstance(v, torch.Tensor) for v in held)
        assert r._store is None or r._store.materialized


def test_serve_batch_equals_session_run(graphs):
    g, jg = graphs
    qs = [q[:3] for q in _queries(jg, 10, seed=15, k=(3, 5))]
    engine = BatchPathEngine(g, EngineConfig(min_cap=64), device=CPU)
    results, info = serve.serve_batch(engine, qs, n_groups=2)
    report = PathSession(g, EngineConfig(min_cap=64), device=CPU).run(qs)
    assert sorted(results) == list(range(len(qs)))
    for i, r in enumerate(report):
        assert oracle.path_set(results[i].paths) == \
            oracle.path_set(r.paths)
        assert results[i].count == r.count
    j_results, j_info = j_serve.serve_batch(
        JEngine(jg, JConfig(min_cap=64, kernel_backend="jnp")), qs,
        n_groups=2)
    for i in results:
        _same_result(results[i], j_results[i])
    assert _drop(info, ON_HOST_CLOCK) == _drop(j_info, ON_HOST_CLOCK)
