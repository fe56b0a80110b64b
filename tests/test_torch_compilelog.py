"""The port's compile telemetry (``repro_torch.core.compilelog``) against
the JAX package's recorder, and the cases of ``tests/test_recompile.py``
that hold on the CPU.

The same sequence of compile events goes to ``repro.core.compilelog.
CompileLog`` (as the ``"Compiling <name> with global shapes"`` records
jax emits, passed to ``emit`` without installing the handler) and to the
port's recorder: ``snapshot``, ``since``, ``retraces_since`` and
``annotate`` must be equal. The port's events come from
``kernels/build.py``: a library built or loaded once counts once, a new
library file of a source already ready counts again (a retrace). On the
CPU nothing is built or loaded, so an engine with ``log_compiles=True``
reports 0 compiles and 0 retraces in every window -- its reports carry
the same fields as the JAX engine's -- through repeated batches and 20
in-bucket delta rounds under both delta backends.
"""
import logging
import os
import stat

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compilelog as j_compilelog  # noqa: E402
from repro.core.delta import GraphDelta as JGraphDelta  # noqa: E402
from repro.core.engine import BatchPathEngine as JEngine  # noqa: E402
from repro.core.engine import EngineConfig as JConfig  # noqa: E402
from repro.core.graph import Graph as JGraph  # noqa: E402
from repro_torch.core import (BatchPathEngine, EngineConfig,  # noqa: E402
                              Graph, GraphDelta, compilelog, oracle)
from repro_torch.kernels import build  # noqa: E402

CPU = "cpu"
TELEMETRY = ("n_compiles", "n_retraces", "compiled_kernels")

# a run of compile events: first loads, then reloads (retraces)
EVENTS = ("msbfs_step", "path_join", "ell_spmm", "msbfs_step",
          "path_join", "path_join", "pairwise_popcount")


def _jax_emit(log, name: str) -> None:
    log.emit(logging.LogRecord(
        "jax._src.interpreters.pxla", logging.WARNING, __file__, 0,
        f"Compiling {name} with global shapes and types "
        f"[ShapedArray(int32[256])]. Argument mapping: (...).", None, None))


@pytest.fixture
def isolated_build(monkeypatch):
    """A build layer with no library ready and no hook installed (the
    process-wide state of ``kernels/build.py`` and the recorder are put
    back afterwards)."""
    monkeypatch.setattr(build, "_READY", {})
    monkeypatch.setattr(build, "_HOOKS", [])
    monkeypatch.setattr(compilelog, "_RECORDER", None)
    return build


# ----------------------------------------------------------------------
# the recorder against the reference's
# ----------------------------------------------------------------------

@pytest.mark.parametrize("split", [0, 1, 3, 5, len(EVENTS)])
def test_recorder_equals_reference(split):
    ref = j_compilelog.CompileLog()           # a handler, never installed
    mine = compilelog.CompileLog()
    for name in EVENTS[:split]:
        _jax_emit(ref, name)
        mine.record(name)
    ref_snap, snap = ref.snapshot(), mine.snapshot()
    assert snap == ref_snap
    for name in EVENTS[split:]:
        _jax_emit(ref, name)
        mine.record(name)
    assert mine.snapshot() == ref.snapshot()
    assert mine.total == ref.total == len(EVENTS)
    assert mine.since(snap) == ref.since(ref_snap)
    assert mine.compiles_since(snap) == ref.compiles_since(ref_snap)
    assert mine.retraces_since(snap) == ref.retraces_since(ref_snap)
    assert mine.annotate({}, snap) == ref.annotate({}, ref_snap)


def test_recorder_accounting():
    # the reference's TestRecorder case on the port's recorder
    cl = compilelog.CompileLog()
    snap = {"a": 2, "b": 1}
    cl.counts.update({"a": 3, "b": 1, "c": 2})
    assert cl.since(snap) == {"a": 1, "c": 2}
    assert cl.retraces_since(snap) == 1
    stats = cl.annotate({}, snap)
    assert stats == {"n_compiles": 3, "n_retraces": 1,
                     "compiled_kernels": {"a": 1, "c": 2}}


def test_enable_is_a_process_singleton(isolated_build):
    assert compilelog.active() is None
    cl = compilelog.enable()
    assert compilelog.enable() is cl and compilelog.active() is cl
    assert build._HOOKS == [cl.record]
    cl.install()                              # idempotent
    assert build._HOOKS == [cl.record]
    cl.uninstall()
    assert compilelog.active() is None and build._HOOKS == []
    assert compilelog.enable() is cl and build._HOOKS == [cl.record]


# ----------------------------------------------------------------------
# the hook of kernels/build.py
# ----------------------------------------------------------------------

def test_a_library_counts_once_and_a_new_file_retraces(isolated_build,
                                                        tmp_path):
    cl = compilelog.enable()
    snap = cl.snapshot()
    build._made_ready("msbfs_step", tmp_path / "libmsbfs_step-a.so")
    build._made_ready("msbfs_step", tmp_path / "libmsbfs_step-a.so")
    assert cl.since(snap) == {"msbfs_step": 1}
    warm = cl.snapshot()
    # the source's hash changed mid-run: a new file of a ready name
    build._made_ready("msbfs_step", tmp_path / "libmsbfs_step-b.so")
    assert cl.annotate({}, warm) == {
        "n_compiles": 1, "n_retraces": 1,
        "compiled_kernels": {"msbfs_step": 1}}
    assert build.ready() == {"msbfs_step": tmp_path / "libmsbfs_step-b.so"}


def test_loading_a_built_library_is_one_compile(isolated_build, monkeypatch):
    # _cdll's first call loads the library (build() finds it on disk):
    # one compile; the library cache serves every later launch
    cl = compilelog.enable()
    loaded = []

    class FakeLib:
        def __init__(self, path):
            loaded.append(path)
            self.error_string = lambda code: b""

    monkeypatch.setattr(build, "build", lambda names: {})
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    snap = cl.snapshot()
    load = build._cdll.__wrapped__            # the uncached body
    load("path_join")
    assert cl.since(snap) == {"path_join": 1} and len(loaded) == 1
    load("path_join")                         # the same file again
    assert cl.since(snap) == {"path_join": 1}


def test_build_then_load_counts_once(isolated_build, monkeypatch, tmp_path):
    # a stand-in nvcc that writes its -o file: build() compiles, then the
    # load of the same file adds nothing
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$#" -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi; shift\n'
                    'done\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    cl = compilelog.enable()
    snap = cl.snapshot()
    report = build.build(["ell_spmm"])
    assert list(report) == ["ell_spmm"]
    assert os.path.exists(build.library_path("ell_spmm"))
    assert cl.since(snap) == {"ell_spmm": 1}
    build._made_ready("ell_spmm", build.library_path("ell_spmm"))  # the load
    assert build.build(["ell_spmm"]) == {}    # already built: no nvcc
    assert cl.annotate({}, snap)["n_compiles"] == 1


# ----------------------------------------------------------------------
# the engine (tests/test_recompile.py on the CPU)
# ----------------------------------------------------------------------

OFFSETS = (1, 2, 3)
N = 64
CHURN_QS = [(0, 3, 3), (8, 11, 3)]
# the JAX engine runs on another circulant than test_recompile.py's (its
# cold start must compile: the JAX package's jit cache is process-wide)
N_BESIDE = 40
QS_BESIDE = [(0, 3, 3), (8, 11, 3), (16, 19, 3)]


def circulant(n=N, offsets=OFFSETS) -> Graph:
    src = np.repeat(np.arange(n, dtype=np.int64), len(offsets))
    dst = (src + np.tile(np.array(offsets, np.int64), n)) % n
    return Graph.from_edges(n, src, dst)


def _engine(**cfg) -> BatchPathEngine:
    base = dict(min_cap=256, cache_bytes=8 << 20, log_compiles=True)
    base.update(cfg)
    return BatchPathEngine(circulant(), EngineConfig(**base), device=CPU)


def _assert_oracle_exact(engine, report, queries):
    for qi, (s, t, k) in enumerate(queries):
        truth = oracle.path_set(
            oracle.enumerate_paths_bruteforce(engine.g, s, t, k))
        assert oracle.path_set(report[qi].paths) == truth, f"q{qi}"


def _zero(stats) -> bool:
    return (stats["n_compiles"], stats["n_retraces"],
            stats["compiled_kernels"]) == (0, 0, {})


def test_reports_carry_telemetry_beside_the_jax_engine():
    n = N_BESIDE
    src = np.repeat(np.arange(n, dtype=np.int64), len(OFFSETS))
    dst = (src + np.tile(np.array(OFFSETS, np.int64), n)) % n
    mine = BatchPathEngine(Graph.from_edges(n, src, dst),
                           EngineConfig(min_cap=256, cache_bytes=8 << 20,
                                        log_compiles=True), device=CPU)
    ref = JEngine(JGraph.from_edges(n, src, dst),
                  JConfig(min_cap=256, cache_bytes=8 << 20,
                          log_compiles=True, kernel_backend="interpret"))
    assert mine.compile_log is compilelog.active()
    assert ref.compile_log is not None
    delta = [(5, 17)]
    for step in ("cold", "warm", "delta", "after"):
        if step == "delta":
            a = mine.apply_delta(GraphDelta.from_pairs(add=delta))
            b = ref.apply_delta(JGraphDelta.from_pairs(add=delta))
            assert set(TELEMETRY) <= set(a) and set(TELEMETRY) <= set(b)
            assert _zero(a)
            continue
        a, b = mine.run(QS_BESIDE), ref.run(QS_BESIDE)
        assert set(TELEMETRY) <= set(a.stats) and set(TELEMETRY) <= set(b.stats)
        assert _zero(a.stats), (step, a.stats)
        if step == "warm":
            assert b.stats["n_compiles"] == b.stats["n_retraces"] == 0
        for x, y in zip(a, b):
            assert oracle.path_set(x.paths) == oracle.path_set(y.paths)


def test_off_by_default_leaves_reports_unchanged():
    eng = BatchPathEngine(circulant(), EngineConfig(min_cap=256),
                          device=CPU)
    assert eng.compile_log is None
    rep = eng.run(CHURN_QS)
    assert not set(TELEMETRY) & set(rep.stats)


def test_different_query_batches_compile_nothing():
    eng = _engine()

    def batch(i):
        return [(8 * j + i, (8 * j + i + 3) % N, 3) for j in range(6)]

    for i in range(4):
        r = eng.run(batch(i))
        assert _zero(r.stats), (i, r.stats)
        _assert_oracle_exact(eng, r, batch(i))


@pytest.mark.parametrize("backend", ["host", "msbfs"])
def test_20_delta_rounds_zero_retraces(backend):
    eng = _engine(delta_backend=backend)
    cl = eng.compile_log
    eng.run(CHURN_QS)
    rep0 = eng.apply_delta(GraphDelta.from_pairs(add=[(20, 27)]))
    assert rep0["device_update"] == "incremental" and _zero(rep0)
    eng.run(CHURN_QS)
    snap = cl.snapshot()
    for i in range(1, 21):                          # 20 churn rounds
        rep = eng.apply_delta(GraphDelta.from_pairs(add=[(20 + i, 27 + i)]))
        assert rep["device_update"] == "incremental"
        assert rep["cache_evicted"] == 0            # hop-cold churn
        assert _zero(rep), (i, rep)
        r = eng.run(CHURN_QS)
        assert _zero(r.stats), (i, r.stats)
        assert eng.g.m == 192 + i + 1
        _assert_oracle_exact(eng, r, CHURN_QS)
    assert cl.compiles_since(snap) == 0             # the whole window
