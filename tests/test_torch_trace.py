"""The port's span tracer (``repro_torch.obs.trace``) and work-stealing
scheduler (``repro_torch.ft.scheduler``) against the JAX package's.

The tracer's unit cases of ``tests/test_obs.py`` (nesting, the ring
buffer, timing while disabled, the Chrome export, ``summarize`` /
``coverage`` and the CLI) run on the port's module, and its annotator
(entered for a span's lifetime, as the reference's) and the
``torch.profiler`` bridge (``obs/torchprof.py``) beside them; the
engine's spans are held to the reference's names, and with
``trace_annotations`` so are the ``record_function`` ranges a CPU
profiler sees: one ``trace=True`` batch (each
planner, and one streaming micro-batch) gives the same ``stage_names``
in both packages. The scheduler is driven through the same calls in both
packages (assignment, steals, requeue on ``fail_group``), and a snapshot
written by either one restores in the other.
"""
import json
import threading

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.engine import BatchPathEngine as JEngine  # noqa: E402
from repro.core.engine import EngineConfig as JConfig  # noqa: E402
from repro.core.graph import Graph as JGraph  # noqa: E402
from repro.ft.scheduler import WorkStealingScheduler as JScheduler  # noqa: E402,E501
from repro.launch import serve as j_serve  # noqa: E402
from repro.obs import trace as j_trace  # noqa: E402
from repro_torch.core import (BatchPathEngine, EngineConfig,  # noqa: E402
                              Graph, GraphDelta, PathSession, oracle)
from repro_torch.ft import WorkStealingScheduler  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.obs import trace as obstrace  # noqa: E402

CPU = "cpu"
OFFSETS = (1, 2, 3)
# not 64 (the circulant of tests/test_recompile.py, whose cold start must
# compile: the JAX package's jit cache is process-wide)
N = 40
QS = [(0, 3, 3), (8, 11, 3), (16, 19, 3)]


def circulant(n=N, offsets=OFFSETS):
    src = np.repeat(np.arange(n, dtype=np.int64), len(offsets))
    dst = (src + np.tile(np.array(offsets, np.int64), n)) % n
    return Graph.from_edges(n, src, dst), JGraph.from_edges(n, src, dst)


@pytest.fixture(autouse=True)
def _clean_tracers():
    """Both tracers are process singletons: leave them disabled and
    empty so these cases cannot leak recording into other tests."""
    yield
    for mod in (obstrace, j_trace):
        mod.disable()
        mod.tracer().reset()
        mod.tracer().annotator = None


# ----------------------------------------------------------------------
# trace.py unit behaviour (the cases of test_obs.py)
# ----------------------------------------------------------------------

def test_nesting_depth_and_order():
    tr = obstrace.Tracer(enabled=True)
    with tr.span("outer") as so:
        with tr.span("inner", level=1) as si:
            pass
    assert [s.name for s in tr.spans()] == ["inner", "outer"]
    assert si.depth == 1 and so.depth == 0
    assert si.tid == so.tid == threading.get_ident()
    assert 0 <= si.duration <= so.duration


def test_exception_safety_records_and_unwinds():
    tr = obstrace.Tracer(enabled=True)
    with pytest.raises(ValueError):
        with tr.span("outer"):
            with tr.span("boom"):
                raise ValueError("x")
    by_name = {s.name: s for s in tr.spans()}
    assert by_name["boom"].attrs["error"] == "ValueError"
    assert by_name["outer"].attrs["error"] == "ValueError"
    assert tr._stack() == []
    with tr.span("after") as sp:
        pass
    assert sp.depth == 0


def test_disabled_tracer_still_times():
    tr = obstrace.Tracer(enabled=False)
    with tr.span("stage") as sp:
        sum(range(1000))
    assert sp.duration > 0.0          # t_* stats work untraced
    assert len(tr) == 0               # ...but nothing is recorded


def test_set_and_elapsed():
    tr = obstrace.Tracer(enabled=True)
    with tr.span("s", a=1) as sp:
        assert sp.elapsed >= 0.0
        sp.set(hit=True)
    assert sp.attrs == {"a": 1, "hit": True}


def test_ring_buffer_bounded():
    tr = obstrace.Tracer(enabled=True, capacity=4)
    for i in range(10):
        with tr.span(f"s{i}"):
            pass
    assert [s.name for s in tr.spans()] == ["s6", "s7", "s8", "s9"]
    tr.configure(capacity=2)
    assert [s.name for s in tr.spans()] == ["s8", "s9"]


def test_thread_local_stacks_give_thread_roots():
    tr = obstrace.Tracer(enabled=True)

    def worker():
        with tr.span("worker.root"):
            pass

    with tr.span("main.root"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    by_name = {s.name: s for s in tr.spans()}
    assert by_name["worker.root"].depth == 0
    assert by_name["worker.root"].tid != by_name["main.root"].tid


def _nested_doc(mod):
    tr = mod.Tracer(enabled=True)
    with tr.span("engine.run", n_queries=3):
        with tr.span("msbfs.level", level=0):
            pass
        with tr.span("join.keyed", lam=2):
            pass
    return tr


def test_chrome_trace_round_trip(tmp_path):
    tr = _nested_doc(obstrace)
    path = tmp_path / "trace.json"
    doc = tr.export(path)
    loaded = obstrace.load(path)
    assert loaded == json.loads(json.dumps(doc))
    assert loaded["displayTimeUnit"] == "ms"
    assert obstrace.stage_names(loaded) == \
        {"engine.run", "msbfs.level", "join.keyed"}
    ev = {e["name"]: e for e in loaded["traceEvents"] if e.get("ph") == "X"}
    assert ev["engine.run"]["args"] == {"n_queries": 3, "depth": 0}
    assert ev["msbfs.level"]["args"]["depth"] == 1
    assert ev["msbfs.level"]["ts"] >= ev["engine.run"]["ts"]
    assert any(e.get("ph") == "M" for e in loaded["traceEvents"])
    # the same layout as the reference's export, up to times and ids
    ref = _nested_doc(j_trace).to_chrome()

    def shape(d):
        return [(e["name"], e["ph"], e.get("cat"),
                 {k: v for k, v in e["args"].items()})
                for e in d["traceEvents"]]
    assert shape(doc) == shape(ref)


def test_summarize_and_coverage():
    tr = obstrace.Tracer(enabled=True)
    with tr.span("engine.run"):
        for lv in range(3):
            with tr.span("msbfs.level", level=lv):
                sum(range(20000))
    doc = tr.to_chrome()
    rows = {r["name"]: r for r in obstrace.summarize(doc)}
    assert rows["msbfs.level"]["count"] == 3
    assert rows["engine.run"]["total_ms"] >= \
        rows["msbfs.level"]["total_ms"] * 0.9
    cov = obstrace.coverage(doc, root="engine.run")
    assert 0.5 <= cov <= 1.0
    # the reference's readout of the same document
    assert obstrace.summarize(doc) == j_trace.summarize(doc)
    assert cov == j_trace.coverage(doc, root="engine.run")
    assert obstrace.coverage(doc, root="absent") == 0.0


def test_singleton_enable_disable():
    tr = obstrace.enable()
    assert tr is obstrace.tracer() and tr.enabled
    with obstrace.span("via.module"):
        pass
    assert "via.module" in {s.name for s in tr.spans()}
    obstrace.disable()
    n = len(tr)
    with obstrace.span("dropped"):
        pass
    assert len(tr) == n


def test_enable_annotate_installs_record_function():
    tr = obstrace.enable(annotate=True)
    assert tr.enabled and tr.annotator is torch.profiler.record_function
    obstrace.enable(fence=True)                # annotate=False removes it
    assert tr.annotator is None and tr.fence
    obstrace.enable(annotate=True)
    obstrace.disable()
    with tr.span("untraced"):                  # disabled: not entered
        pass
    tr.configure(annotator=None)


class _Recorder:
    """A fake annotator: logs the names entered and exited."""

    def __init__(self):
        self.log = []

    def __call__(self, name):
        rec = self

        class Ctx:
            def __enter__(self):
                rec.log.append(("enter", name))

            def __exit__(self, *exc):
                rec.log.append(("exit", name, exc[0] is not None))
        return Ctx()


def test_annotator_lifetime_equals_reference():
    logs = []
    for mod in (obstrace, j_trace):
        ann = _Recorder()
        tr = mod.Tracer(enabled=True, annotator=ann)
        with tr.span("outer"):
            with tr.span("inner"):
                pass
        with pytest.raises(ValueError):
            with tr.span("boom"):
                raise ValueError("x")
        tr.configure(enabled=False)
        with tr.span("off"):
            pass
        tr.configure(enabled=True, annotator=None)
        with tr.span("detached"):
            pass
        tr.configure(annotator=ann)
        tr.configure(fence=False)              # keeps the annotator
        with tr.span("kept"):
            pass
        logs.append(ann.log)
    assert logs[0] == logs[1]
    assert logs[0][:4] == [("enter", "outer"), ("enter", "inner"),
                           ("exit", "inner", False), ("exit", "outer", False)]


def test_torchprof_api(tmp_path):
    from repro_torch.obs import torchprof
    assert torchprof.available()
    assert torchprof.annotation_factory() is torch.profiler.record_function
    tr = obstrace.Tracer(enabled=True)
    assert torchprof.attach(tr).annotator is torch.profiler.record_function
    assert torchprof.detach(tr).annotator is None
    # no CUDA device here: the memory functions report that, nothing else
    assert torchprof.sample_device_memory() is None
    assert torchprof.save_memory_profile(tmp_path / "m.pickle") is False
    assert torchprof.stop_trace() is None      # nothing running
    with torchprof.profile_run(None) as prof:
        assert prof is None
    with torchprof.profile_run(tmp_path / "prof", device=CPU) as prof:
        with pytest.raises(RuntimeError, match="already running"):
            torchprof.start_trace(tmp_path / "other")
        with torchprof.annotation("stage.x"):
            torch.ones(4).sum()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "stage.x" in names
    (trace,) = (tmp_path / "prof").glob("torchprof_*.trace.json")
    doc = json.loads(trace.read_text())
    assert any(e.get("name") == "stage.x" for e in doc["traceEvents"])


def test_fence_synchronizes_only_cuda_tensors():
    cpu = torch.zeros(3)
    fake = type("T", (), {"device": torch.device("cuda", 1)})()
    assert obstrace._cuda_devices([cpu, {"x": (cpu, 3)}], set()) == set()
    assert obstrace._cuda_devices({"a": [cpu, fake]}, set()) == \
        {torch.device("cuda", 1)}
    tr = obstrace.Tracer(enabled=True, fence=True)
    with tr.span("fenced") as sp:
        sp.fence([cpu, {"y": cpu}])       # nothing to synchronize
    assert tr.spans()[0].name == "fenced"


# ----------------------------------------------------------------------
# CLI (python -m repro_torch.obs)
# ----------------------------------------------------------------------

def _write_trace(tmp_path):
    p = tmp_path / "t.json"
    _nested_doc(obstrace).export(p)
    return p


def test_cli_summarize(tmp_path, capsys):
    from repro_torch.obs.__main__ import main
    p = _write_trace(tmp_path)
    assert main(["summarize", str(p)]) == 0
    out = capsys.readouterr().out
    assert "msbfs.level" in out and "coverage" in out


def test_cli_export_filter(tmp_path):
    from repro_torch.obs.__main__ import main
    p = _write_trace(tmp_path)
    out = tmp_path / "f.json"
    assert main(["export", str(p), "-o", str(out), "--filter", "msbfs."]) == 0
    assert obstrace.stage_names(obstrace.load(out)) == {"msbfs.level"}


def test_cli_summarize_empty_trace_fails(tmp_path):
    from repro_torch.obs.__main__ import main
    p = tmp_path / "empty.json"
    p.write_text('{"traceEvents": []}')
    assert main(["summarize", str(p)]) == 1


# ----------------------------------------------------------------------
# engine and serving spans
# ----------------------------------------------------------------------

def _engines(**cfg):
    g, jg = circulant()
    base = dict(min_cap=256, cache_bytes=8 << 20)
    base.update(cfg)
    return (BatchPathEngine(g, EngineConfig(**base), device=CPU),
            JEngine(jg, JConfig(kernel_backend="jnp", **base)))


@pytest.mark.parametrize("planner", ["batch", "basic", "batch+", "pathenum",
                                     "auto"])
def test_traced_batch_has_the_reference_stage_names(tmp_path, planner):
    eng, j_eng = _engines(trace=True)
    for e in (eng, j_eng):
        e.run(QS, planner=planner)      # cold, then one traced warm run
        e.obs.reset()
    rep, j_rep = eng.run(QS, planner=planner), j_eng.run(QS, planner=planner)
    for r in (*rep, *j_rep):
        r.paths                         # the host transfer is a span too
    doc = eng.obs.export(tmp_path / "t.json")
    names = obstrace.stage_names(doc)
    assert names == j_trace.stage_names(j_eng.obs.to_chrome())
    assert "engine.run" in names
    assert obstrace.coverage(doc, root="engine.run") >= 0.9


def test_serve_cli_profile_writes_an_annotated_trace(tmp_path, capsys):
    out = tmp_path / "prof"
    serve.main(["--n", "400", "--queries", "4", "--k-min", "3", "--k-max",
                "3", "--validate", "1", "--device", "cpu",
                "--profile", str(out)])
    assert "profile:" in capsys.readouterr().out
    (path,) = out.glob("torchprof_*.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())
             ["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"serve.batch", "engine.run", "index.build"} <= names


@pytest.mark.parametrize("planner", ["batch", "basic"])
def test_annotated_batch_names_equal_span_and_reference_names(planner):
    from torch.profiler import ProfilerActivity, profile
    eng, j_eng = _engines(trace=True, trace_annotations=True)
    for e in (eng, j_eng):
        e.run(QS, planner=planner)      # cold, then one traced warm run
        e.obs.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rep = eng.run(QS, planner=planner)
        for r in rep:
            r.paths
    j_rep = j_eng.run(QS, planner=planner)
    for r in j_rep:
        r.paths
    for a, b in zip(rep, j_rep):
        assert oracle.path_set(a.paths) == oracle.path_set(b.paths)
        assert a.count == b.count
    annotated = {e.name() for e in prof.profiler.kineto_results.events()
                 if e.is_user_annotation()}
    spans = {s.name for s in eng.obs.spans()}
    assert annotated == spans == j_trace.stage_names(j_eng.obs.to_chrome())
    # every span was one record_function range
    n_ranges = sum(1 for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation())
    assert n_ranges == len(eng.obs.spans())


def test_traced_streaming_batch_has_the_reference_stage_names():
    eng, j_eng = _engines(trace=True)
    srv = serve.StreamingServer(eng, policy=serve.AdmissionPolicy(
        max_batch=8, max_delay_s=0.0))
    j_srv = j_serve.StreamingServer(j_eng, policy=j_serve.AdmissionPolicy(
        max_batch=8, max_delay_s=0.0))
    for e in (eng, j_eng):
        e.obs.reset()
    for s in (srv, j_srv):
        for q in QS:
            s.submit(q)
        s.drain()
    names = obstrace.stage_names(eng.obs.to_chrome())
    assert names == j_trace.stage_names(j_eng.obs.to_chrome())
    assert {"serve.batch", "serve.assemble", "engine.run",
            "transfer.paths"} <= names
    doc = eng.obs.to_chrome()
    assert obstrace.coverage(doc, root="serve.batch") >= 0.9


def test_stats_are_span_durations_traced_or_not():
    for trace in (False, True):
        eng, _ = _engines(trace=trace)
        r = eng.run(QS)
        for k in ("t_wall_s", "t_cluster", "t_detect", "t_build_index",
                  "t_enumerate"):
            assert k in r.stats and r.stats[k] >= 0.0, (trace, k)
        if trace:
            by_name = {s.name: s for s in eng.obs.spans()}
            assert r.stats["t_wall_s"] == by_name["engine.run"].duration


def test_tracing_off_is_bit_identical():
    r0 = _engines(trace=False)[0].run(QS)
    r1 = _engines(trace=True, trace_fence=True)[0].run(QS)
    assert obstrace.tracer().fence
    for a, b in zip(r0, r1):
        assert np.array_equal(a.paths, b.paths)


def test_session_trace_kwarg_and_tracer_property(tmp_path):
    g, _ = circulant()
    sess = PathSession(g, device=CPU, trace=True)
    assert sess.tracer is obstrace.tracer() and sess.tracer.enabled
    assert sess.engine.cfg.trace is True
    sess.tracer.reset()
    sess.run(QS)
    doc = sess.tracer.export(tmp_path / "s.json")
    assert "engine.run" in obstrace.stage_names(doc)
    assert PathSession(g, device=CPU).engine.cfg.trace is False


def test_apply_delta_spans_and_stats():
    eng, _ = _engines(trace=True)
    eng.run(QS)
    eng.obs.reset()
    rep = eng.apply_delta(GraphDelta.from_pairs(add=[(20, 27)]))
    assert rep["t_apply_s"] > 0
    spans = {s.name: s for s in eng.obs.spans()}
    assert {"engine.apply_delta", "cache.invalidate"} <= set(spans)
    assert spans["engine.apply_delta"].attrs == {"n_added": 1,
                                                 "n_removed": 0}
    assert rep["t_apply_s"] == spans["engine.apply_delta"].duration
    s, t, k = QS[0]
    assert oracle.path_set(eng.run([QS[0]])[0].paths) == oracle.path_set(
        oracle.enumerate_paths_bruteforce(eng.g, s, t, k))


# ----------------------------------------------------------------------
# the work-stealing scheduler, against the reference
# ----------------------------------------------------------------------

def _drive(sched, fail_at=None):
    """Submit two waves, drain with three groups (group 2 never asks, so
    the others steal its work; group ``fail_at`` dies holding its second
    item);
    returns the trace of (group, cluster id) pairs."""
    out = [sched.submit([[0, 1], [2], [3, 4, 5], [6], [7, 8]])]
    out.append(sched.submit_one([9, 10]))
    steps = []
    while sched.pending():
        progressed = False
        for grp in (0, 1):
            it = sched.next_for(grp)
            if it is None:
                continue
            progressed = True
            steps.append((grp, it.cluster_id, list(it.queries), it.cost))
            if grp == fail_at and [st[0] for st in steps].count(grp) == 2:
                steps.append(("requeued", sched.fail_group(grp)))
                fail_at = None
                continue
            sched.complete(it.cluster_id, True)
        if not progressed:
            break
    return out, steps, sched.steals, sched.failovers, sched.requeued


@pytest.mark.parametrize("fail_at", [None, 0, 1])
def test_scheduler_equals_reference(fail_at):
    def cost(qs):
        return float(len(qs)) ** 1.5

    mine = _drive(WorkStealingScheduler(3, cost_fn=cost), fail_at)
    ref = _drive(JScheduler(3, cost_fn=cost), fail_at)
    assert mine == ref
    assert mine[2] > 0                           # group 2's work was stolen
    if fail_at is not None:
        assert mine[3] == 1 and mine[4] == 1


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_scheduler_snapshot_restores_across_packages(tmp_path, writer):
    make = {"port": WorkStealingScheduler, "reference": JScheduler}
    reader = "reference" if writer == "port" else "port"
    sched = make[writer](2)
    sched.submit([[0, 1], [2], [3, 4, 5]])
    first = sched.next_for(0)
    sched.complete(first.cluster_id, True)
    sched.next_for(1)                            # in flight at the "crash"
    path = tmp_path / "sched.json"
    sched.snapshot(path)
    mine = make[reader].restore(path, n_groups=2)
    same = make[writer].restore(path, n_groups=2)
    for a in (mine, same):
        assert sorted(a.done) == [first.cluster_id]
    assert [[(i.cluster_id, i.queries, i.cost) for i in q]
            for q in mine.queues] == \
        [[(i.cluster_id, i.queries, i.cost) for i in q] for q in same.queues]
    assert mine.pending() == same.pending() == 2
    assert mine.submit([[6]]) == same.submit([[6]])   # ids do not collide
    mine.snapshot(tmp_path / "mine.json")
    same.snapshot(tmp_path / "same.json")
    assert json.loads((tmp_path / "mine.json").read_text()) == \
        json.loads((tmp_path / "same.json").read_text())
