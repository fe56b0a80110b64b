#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                    # the full workload, one card
    python3 chip_smoke.py --n 65536 --queries 32 --sharing-queries 16
                                             # a quicker, smaller run

Phases 4 and 5 drive the first slice's path (``plan_caps=False``, BATCH
and BASIC); phases 6 and 7 the engine's default configuration
(``EngineConfig()``: walk-count capacity planning on ``ell_spmm``) under
every planner, and the cross-batch cache.

Phases, each printing one JSON line (``"phase": ...``):

1. device   -- the card's name and power limit (``nvidia-smi``), torch/CUDA.
2. build    -- compile the CUDA kernels (and the peak-rate probes) from
               ``src/repro_torch/csrc``, one ``nvcc`` per source.
3. workload -- the 2**20-vertex community graph (about 8.4 M edges) and
               256 random (s, t, k) queries, k in 4..6, from fixed seeds.
4. main     -- ``PathSession(g, EngineConfig(plan_caps=False),
               device="cuda").run(queries, planner="batch")``: cold once
               (the run whose kernel launches are counted), warm twice;
               results checked against the brute-force oracle on a few
               queries and against a ``Planner.BASIC`` run on all.
               Then one more run with the kernel wrappers wrapped, to keep
               the inputs of each kernel's heaviest call (not timed).
5. sharing  -- a second batch on the same graph, 64 overlapping queries
               (``similar_queries``, similarity 0.8, k in 7..8), whose
               shared HC-s path queries and splice joins are what the
               paper is about and whose frontiers outgrow ``min_cap``:
               launches counted, oracle and BASIC checks, then a wrapped
               run that keeps the heaviest join-kernel inputs.
6. planners -- ``PathSession(g, EngineConfig(), device="cuda")``, the
               default configuration, runs the sharing batch under
               ``batch``, ``batch+``, ``basic+``, ``pathenum`` and
               ``auto``, each with its own launch counts (``ell_spmm``
               must launch) and stage times; every path set must equal
               the ``plan_caps=False`` BATCH run of phase 5. The overflow
               retries of node enumeration are counted with and without
               ``plan_caps`` (by wrapping ``_run_node_once``). ``auto``
               then answers the 256-query main batch (routes, wall time,
               path sets equal to phase 4's), and a last wrapped
               ``batch`` run keeps the inputs of the heaviest
               ``ell_spmm`` call.
7. cache    -- ``EngineConfig(cache_bytes=256 << 20)``: the sharing batch
               twice (the second must materialize nothing, hit, and give
               identical rows), then ``update_graph(g)`` and a run that
               must materialize again.
8. peaks    -- measured peak rates of 32-bit ``popc`` on the CUDA cores
               and of the tensor cores' 1-bit AND+popc MMA (no published
               H100 rate exists for either), used in the popcount bound.
9. kernels  -- each kernel again on the inputs of its heaviest call in the
               main path (and, for the join kernels, in the sharing
               batch; for ``ell_spmm`` also two synthetic shapes on the
               graph's ELL table with random float32 features, F = 128
               sum and F = 8 max), held against its plain PyTorch version
               on the card (exact equality: the outputs are integers, or
               float32 sums taken in the same order), timed with CUDA
               events (median of 10 warm runs) beside the plain version,
               one PyTorch library call where one computes the same
               function, and the least time the card could take.

Then a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failed check
exits non-zero before that line; without a CUDA device the script exits
non-zero at once. It imports nothing of JAX and nothing of ``repro``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
# results per clock per SM on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput): 32-bit population
# count, and 32-bit integer compare/add. The popcount bound also measures
# both popc and the 1-bit tensor-core MMA (phase "peaks").
POPC_PER_CLK_SM = 16
INT_PER_CLK_SM = 64
# published H100 SXM float32 rate outside the tensor cores (NVIDIA data
# sheet), operations/s
F32_OPS_PER_S = 67e12

KERNEL_ROWS = {
    "msbfs_step": ("src/repro_torch/csrc/msbfs_step.cu",
                   "src/repro/kernels/msbfs_expand/kernel.py:95"),
    "pairwise_popcount": ("src/repro_torch/csrc/pairwise_popcount.cu",
                          "src/repro/kernels/pairwise_popcount/kernel.py:39"),
    "path_member": ("src/repro_torch/csrc/path_join.cu",
                    "src/repro/kernels/path_join/kernel.py:109"),
    "rowwise_overlap": ("src/repro_torch/csrc/path_join.cu",
                        "src/repro/kernels/path_join/kernel.py:70"),
    "ell_spmm": ("src/repro_torch/csrc/ell_spmm.cu",
                 "src/repro/kernels/ell_spmm/kernel.py:47"),
}
# the kernels of the first slice's path (plan_caps=False), which phases 4
# and 5 drive; ell_spmm runs only where capacities are planned (phase 6)
FIRST_SLICE = ("msbfs_step", "pairwise_popcount", "path_member",
               "rowwise_overlap")
# the planners phase 6 drives with the default configuration
PLANNERS = ("batch", "batch+", "basic+", "pathenum", "auto")


STAT_KEYS = ("t_build_index", "t_cluster", "t_detect", "t_enumerate",
             "t_wall_s")


class SmokeFailure(RuntimeError):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def smi(query: str, units: bool = True) -> str:
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# recording the main path's kernel calls
# ----------------------------------------------------------------------

def popcount_total(torch, words) -> int:
    """Number of set bits in int32 words (exact)."""
    from repro_torch.kernels.pairwise_popcount.ops import popcount32
    return int(popcount32(words.to(torch.int64) & 0xFFFFFFFF).sum())


class Recorder:
    """Wraps one kernel wrapper in its module while active; keeps a copy
    of the inputs of the heaviest call (by ``work``)."""

    def __init__(self, module, fn_name: str, work):
        self.module, self.fn_name, self.work = module, fn_name, work
        self.fn = getattr(module, fn_name)
        self.best, self.best_work = None, -1

    def __call__(self, *args):
        import torch
        saved = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                      for a in args)
        out = self.fn(*args)
        w = self.work(saved, out)
        if w > self.best_work:
            self.best, self.best_work = saved, w
        return out

    def __enter__(self):
        setattr(self.module, self.fn_name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.fn_name, self.fn)


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def phase_device(torch) -> dict:
    name_power = smi("name,power.limit")
    print(name_power, flush=True)
    info = {"phase": "device", "nvidia_smi": name_power,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "max_sm_clock_mhz": float(smi("clocks.max.sm", units=False)),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit(info)
    return info


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build(build.SOURCES + build.PROBES)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": sorted(report),
          "ptxas": {k: [ln.strip() for ln in v["log"].splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in report.items()}})


def phase_workload(n: int, nq: int):
    from repro_torch.core import generators
    t0 = time.perf_counter()
    g = generators.community(n=n, n_comm=max(n // 2500, 1), avg_deg=8.0,
                             p_intra=0.9, seed=0)
    t_graph = time.perf_counter() - t0
    queries = generators.random_queries(g, nq, k_range=(4, 6), seed=1)
    emit({"phase": "workload", "n": g.n, "m": g.m,
          "max_out_degree": int(g.out_degree().max()),
          "max_in_degree": int(g.in_degree().max()),
          "queries": len(queries),
          "k_hist": {k: sum(1 for q in queries if q[2] == k)
                     for k in (4, 5, 6)},
          "t_graph_s": t_graph, "t_setup_s": time.perf_counter() - t0})
    return g, queries


def check_paths(g, q, paths) -> None:
    s, t, k = q
    require(paths.ndim == 2 and paths.shape[1] == k + 1,
            f"query {q}: paths shape {paths.shape}")
    for row in paths:
        p = [int(x) for x in row if x >= 0]
        require(p[0] == s and p[-1] == t and len(p) <= k + 1
                and len(set(p)) == len(p), f"query {q}: bad path {p}")
        require(all(x < g.n for x in p), f"query {q}: vertex out of range")


def check_results(g, queries, report, ks) -> tuple[int, float]:
    """Every path well formed; the brute-force oracle on two queries of
    each hop budget in ``ks``. Returns (queries checked, seconds)."""
    from repro_torch.core import oracle
    for q, r in zip(queries, report):
        check_paths(g, q, r.paths)
    picked = []
    for k in ks:
        picked += [i for i, q in enumerate(queries) if q[2] == k][:2]
    t0 = time.perf_counter()
    for i in picked:
        s, t, k = queries[i]
        expect = set(oracle.enumerate_paths_bruteforce(g, s, t, k))
        got = oracle.path_set(report[i].paths)
        require(got == expect and len(report[i].paths) == len(expect),
                f"query {queries[i]}: {len(got)} paths, oracle {len(expect)}")
    return len(picked), time.perf_counter() - t0


def check_same(queries, batch, basic, what: str = "BATCH and BASIC") -> None:
    """Two runs must give the same path set for every query."""
    from repro_torch.core import oracle
    for q, a, b in zip(queries, batch, basic):
        require(oracle.path_set(a.paths) == oracle.path_set(b.paths)
                and len(a.paths) == len(b.paths),
                f"query {q}: {what} disagree")


def make_recorders(torch, names) -> dict:
    from repro_torch.kernels.ell_spmm import ops as eops
    from repro_torch.kernels.msbfs_expand import ops as mops
    from repro_torch.kernels.pairwise_popcount import ops as pops
    from repro_torch.kernels.path_join import ops as jops
    makers = {
        "msbfs_step": lambda: Recorder(
            mops, "msbfs_step_cuda",
            lambda a, out: popcount_total(torch, out)),
        "pairwise_popcount": lambda: Recorder(
            pops, "pairwise_popcount_cuda",
            lambda a, out: a[0].shape[0] ** 2 * a[0].shape[1]),
        "path_member": lambda: Recorder(
            jops, "path_member_cuda",
            lambda a, out: a[0].shape[0] * a[0].shape[1] * a[1].shape[1]),
        "rowwise_overlap": lambda: Recorder(
            jops, "rowwise_overlap_cuda",
            lambda a, out: a[0].shape[0] * a[0].shape[1] * a[1].shape[1]),
        # every call has the same shape: the heaviest carries the most
        # walks (non-zero features)
        "ell_spmm": lambda: Recorder(
            eops, "ell_spmm_cuda",
            lambda a, out: int(torch.count_nonzero(a[1]))),
    }
    return {k: makers[k]() for k in names}


@contextlib.contextmanager
def recording(recorders: dict):
    with contextlib.ExitStack() as active:
        for r in recorders.values():
            active.enter_context(r)
        yield


def phase_main(torch, g, queries):
    from repro_torch.core import EngineConfig, PathSession
    from repro_torch.kernels import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    session = PathSession(g, EngineConfig(plan_caps=False), device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    dg = session.engine.dg

    reset_launches()
    t0 = time.perf_counter()
    cold = session.run(queries, planner="batch")
    t_cold = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    require(all(launches[k] > 0 for k in FIRST_SLICE),
            f"a kernel of the main path never launched: {launches}")

    warm = []
    for _ in range(2):
        t0 = time.perf_counter()
        rep = session.run(queries, planner="batch")
        counts = [r.count for r in rep]
        warm.append(dict({k: rep.stats[k] for k in STAT_KEYS},
                         host_wall_s=time.perf_counter() - t0))
        require(counts == [r.count for r in cold], "warm run differs")

    counts = [r.count for r in cold]
    n_oracle, t_oracle = check_results(g, queries, cold, (4, 5, 6))
    reset_launches()
    t0 = time.perf_counter()
    basic = session.run(queries, planner="basic")
    t_basic = time.perf_counter() - t0
    basic_launches = dict(LAUNCHES)
    check_same(queries, cold, basic)

    recorders = make_recorders(torch, FIRST_SLICE)
    with recording(recorders):
        rec = session.run(queries, planner="batch")
    require([r.count for r in rec] == counts, "recorded run differs")

    emit({"phase": "main", "device_graph": {
              "ell_cap": dg.ell_cap, "r_ell_cap": dg.r_ell_cap},
          "t_engine_init_s": t_init, "t_cold_s": t_cold,
          "cold": {k: cold.stats[k] for k in STAT_KEYS},
          "warm": warm,
          "n_clusters": cold.stats["n_clusters"],
          "n_psi_nodes": cold.stats["n_psi_nodes"],
          "n_materialized": cold.stats["n_materialized"],
          "n_rows_assembled": cold.stats["n_rows_assembled"],
          "total_paths": sum(counts), "max_paths": max(counts),
          "queries_without_paths": sum(1 for c in counts if c == 0),
          "launches": launches,
          "oracle_checked": n_oracle, "t_oracle_s": t_oracle,
          "basic_equal": True, "t_basic_s": t_basic,
          "basic_stats": {k: basic.stats[k] for k in
                          ("t_build_index", "t_enumerate", "t_wall_s")},
          "basic_launches": basic_launches})
    return session, recorders, launches, cold


def phase_sharing(torch, g, session, nq: int):
    from repro_torch.core import generators
    from repro_torch.kernels import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    queries = generators.similar_queries(g, nq, similarity=0.8,
                                         k_range=(7, 8), seed=2)
    t_gen = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    rep = session.run(queries, planner="batch")
    t_run = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    require(all(launches[k] > 0 for k in FIRST_SLICE),
            f"a kernel of the sharing batch never launched: {launches}")
    require(rep.stats["n_shared"] > 0, "the sharing batch shared nothing")
    counts = [r.count for r in rep]
    n_oracle, t_oracle = check_results(g, queries, rep, (7, 8))
    t0 = time.perf_counter()
    basic = session.run(queries, planner="basic")
    t_basic = time.perf_counter() - t0
    check_same(queries, rep, basic)

    joins = ("path_member", "rowwise_overlap")
    recorders = make_recorders(torch, joins)
    with recording(recorders):
        rec = session.run(queries, planner="batch")
    require([r.count for r in rec] == counts, "recorded run differs")
    rows = {k: recorders[k].best[0].shape[0] for k in joins}
    require(all(n > session.engine.cfg.min_cap for n in rows.values()),
            f"the sharing batch never outgrew min_cap: {rows}")
    emit({"phase": "sharing", "queries": len(queries),
          "k_hist": {k: sum(1 for q in queries if q[2] == k)
                     for k in (7, 8)},
          "t_gen_s": t_gen, "t_run_s": t_run,
          "stats": {k: rep.stats[k] for k in STAT_KEYS},
          **{k: rep.stats[k] for k in (
              "n_clusters", "n_psi_nodes", "n_materialized", "n_shared",
              "n_dedup", "n_share_edges", "n_rows_assembled")},
          "total_paths": sum(counts), "max_paths": max(counts),
          "queries_without_paths": sum(1 for c in counts if c == 0),
          "launches": launches, "heaviest_join_rows": rows,
          "oracle_checked": n_oracle, "t_oracle_s": t_oracle,
          "basic_equal": True, "t_basic_s": t_basic})
    return recorders, launches, queries, rep


class RetryCounter:
    """Counts an engine's node enumerations while active, and how many of
    them the overflow retry repeated (``_run_node_once`` returns None when
    a buffer overflowed and the node must run again with larger caps)."""

    def __init__(self, engine):
        self.engine, self.fn = engine, engine._run_node_once
        self.calls = self.retries = 0

    def __call__(self, *args):
        out = self.fn(*args)
        self.calls += 1
        self.retries += out is None
        return out

    def __enter__(self):
        self.engine._run_node_once = self
        return self

    def __exit__(self, *exc):
        del self.engine._run_node_once       # back to the class's method

    def as_dict(self) -> dict:
        return {"node_runs": self.calls, "retries": self.retries}


def phase_planners(torch, g, main_session, main_queries, main_report,
                   queries, share_report):
    from repro_torch.core import EngineConfig, PathSession
    from repro_torch.kernels import LAUNCHES, reset_launches

    session = PathSession(g, EngineConfig(), device="cuda")
    runs, launches = {}, {}
    for planner in PLANNERS:
        with RetryCounter(session.engine) as rc:
            reset_launches()
            t0 = time.perf_counter()
            rep = session.run(queries, planner=planner)
            host_wall = time.perf_counter() - t0
            launches[planner] = dict(LAUNCHES)
        require(launches[planner]["ell_spmm"] > 0,
                f"{planner}: ell_spmm never launched on the default config")
        check_same(queries, share_report, rep,
                   f"plan_caps=False BATCH and default-config {planner}")
        runs[planner] = {
            "stats": {k: v for k, v in rep.stats.items()
                      if k.startswith(("t_", "n_", "routed_"))},
            "host_wall_s": host_wall, "launches": launches[planner],
            "routes": None if rep.routes is None else
            {r: rep.routes.count(r) for r in set(rep.routes)},
            "retry": rc.as_dict()}
    # the first slice's configuration on the same batch, for its retries
    with RetryCounter(main_session.engine) as rc_off:
        rep = main_session.run(queries, planner="batch")
    check_same(queries, share_report, rep, "two plan_caps=False BATCH runs")

    reset_launches()
    t0 = time.perf_counter()
    auto = session.run(main_queries, planner="auto")
    t_auto = time.perf_counter() - t0
    auto_launches = dict(LAUNCHES)
    check_same(main_queries, main_report, auto,
               "plan_caps=False BATCH and default-config AUTO (main batch)")

    recorders = make_recorders(torch, ("ell_spmm",))
    with recording(recorders):
        rec = session.run(queries, planner="batch")
    check_same(queries, share_report, rec, "recorded batch run")
    emit({"phase": "planners", "queries": len(queries), "runs": runs,
          "retry_plan_caps_false_batch": rc_off.as_dict(),
          "auto_main": {
              "queries": len(main_queries), "host_wall_s": t_auto,
              "routes": {r: auto.routes.count(r) for r in set(auto.routes)},
              "cluster_planners": {
                  p: auto.stats.get("cluster_planners", []).count(p)
                  for p in ("basic", "batch")},
              "stats": {k: v for k, v in auto.stats.items()
                        if k.startswith(("t_", "n_", "routed_"))},
              "launches": auto_launches, "paths_equal_main": True},
          "paths_equal_sharing": True})
    return recorders, launches["batch"]


def phase_cache(g, queries, share_report):
    import numpy as np
    from repro_torch.core import EngineConfig, PathSession
    session = PathSession(g, EngineConfig(cache_bytes=256 << 20),
                          device="cuda")
    keys = ("t_wall_s", "n_materialized", "n_cache_hits", "n_cache_misses")
    out = {}
    cold = session.run(queries)
    warm = session.run(queries)
    require(warm.stats["n_materialized"] == 0
            and warm.stats["n_cache_hits"] > 0,
            f"the warm run did not hit the cache: {warm.stats}")
    for a, b in zip(cold, warm):
        require(np.array_equal(a.paths, b.paths), "cache hit changed rows")
    check_same(queries, share_report, cold, "BATCH and cached BATCH")
    t0 = time.perf_counter()
    session.update_graph(g)
    t_update = time.perf_counter() - t0
    after = session.run(queries)
    require(after.stats["n_materialized"] > 0
            and after.stats["n_cache_hits"] == 0,
            f"update_graph left the cache warm: {after.stats}")
    for name, rep in (("cold", cold), ("warm", warm), ("after_update", after)):
        out[name] = {k: rep.stats[k] for k in keys}
    emit({"phase": "cache", **out, "t_update_graph_s": t_update,
          "cache_info": session.cache.info(), "rows_identical": True})


def phase_peaks(torch, dev_info) -> dict:
    """Peak rates of the two units that can compute popcount(AND): the
    CUDA cores' 32-bit ``popc`` and the tensor cores' 1-bit MMA."""
    import ctypes
    from repro_torch.kernels import build
    P, I = ctypes.c_void_p, ctypes.c_int
    lib = build.load("peak_probe", {
        "popc_peak_launch": [P, P, I, I, I, P],
        "b1_mma_peak_launch": [P, P, I, I, I, P],
        "probe_chains": []})
    chains = lib.probe_chains()
    blocks, threads = 4 * dev_info["sms"], 256
    inp = torch.randint(-2 ** 31, 2 ** 31 - 1, (256,), dtype=torch.int32,
                        device="cuda")
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(fn, iters):
        def run():
            build.check(lib, fn(inp.data_ptr(), out.data_ptr(), blocks,
                                threads, iters, stream), "peak probe")
        return run

    clock_hz = dev_info["max_sm_clock_mhz"] * 1e6
    per_clk_sm = clock_hz * dev_info["sms"]
    it_popc, it_mma = 4096, 2048
    ms_popc = cuda_ms(torch, launcher(lib.popc_peak_launch, it_popc), reps=5)
    ms_mma = cuda_ms(torch, launcher(lib.b1_mma_peak_launch, it_mma), reps=5)
    popc_per_s = blocks * threads * it_popc * chains / (ms_popc / 1e3)
    mmas = blocks * (threads // 32) * it_mma * chains
    b1_pairs_per_s = mmas * 16 * 8 * 256 / (ms_mma / 1e3)
    peaks = {"phase": "peaks", "popc_ms": ms_popc, "b1_mma_ms": ms_mma,
             "popc_per_s": popc_per_s,
             "popc_per_clk_sm": popc_per_s / per_clk_sm,
             "b1_bit_pairs_per_s": b1_pairs_per_s,
             "b1_bit_pairs_per_clk_sm": b1_pairs_per_s / per_clk_sm,
             "clock_for_per_clk": "max SM clock (nvidia-smi)"}
    emit(peaks)
    return peaks


def cuda_ms(torch, fn, setup=None, reps: int = 10) -> float:
    """Median over ``reps`` warm runs of ``fn(*setup())``, CUDA events."""
    args = setup() if setup else ()
    fn(*args)                                    # warm-up
    times = []
    for _ in range(reps):
        args = setup() if setup else ()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(torch, pairs) -> int:
    err = 0
    for a, b in pairs:
        require(a.shape == b.shape and a.dtype == b.dtype,
                f"shape/dtype mismatch {a.shape} {a.dtype} vs "
                f"{b.shape} {b.dtype}")
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                               .abs().max()))
    return err


def float_err(torch, a, b) -> float:
    """0.0 when two float tensors are equal bit for bit, else the largest
    absolute difference (inf where only one side is finite or NaN)."""
    require(a.shape == b.shape and a.dtype == b.dtype,
            f"shape/dtype mismatch {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    if torch.equal(a.view(torch.int32), b.view(torch.int32)):
        return 0.0
    d = (a.double() - b.double()).abs()
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def csr_of_ell(torch, ell):
    """The adjacency of a padded ELL table (pad = V) as a CSR matrix of
    ones, pad entries dropped: ``A @ X[:V]`` is the ``sum`` aggregate."""
    V = ell.shape[0]
    keep = ell != V
    crow = torch.zeros(V + 1, dtype=torch.int64, device=ell.device)
    crow[1:] = torch.cumsum(keep.sum(dim=1), dim=0)
    col = ell[keep].to(torch.int64)
    vals = torch.ones(col.shape[0], dtype=torch.float32, device=ell.device)
    return torch.sparse_csr_tensor(crow, col, vals, size=(V, V))


def measure_ell_spmm(torch, ell, xs, op) -> dict:
    """Kernel against plain version (bit for bit), both timed, with the
    ``torch.sparse.mm`` yardstick (sum only) and the bound."""
    from repro_torch.kernels.ell_spmm import ops as eops
    V, D = ell.shape
    F = xs.shape[1]
    err = float_err(torch, eops.ell_spmm_cuda(ell, xs, op),
                    eops.ell_spmm_ref(ell, xs, op))
    library_ms = None
    if op == "sum":
        a = csr_of_ell(torch, ell)
        x = xs[:V].contiguous()
        got = torch.sparse.mm(a, x)
        # another order of summation: a yardstick of time, checked loosely
        # (relative to the sum of magnitudes) only to show it computes the
        # same function
        scale = float(eops.ell_spmm_ref(ell, xs.abs(), op).max()) or 1.0
        require(float((got - eops.ell_spmm_ref(ell, xs, op)).abs().max())
                <= 1e-5 * scale, "torch.sparse.mm computes another function")
        library_ms = cuda_ms(torch, torch.sparse.mm, lambda: (a, x))
        del a, x, got
    nbytes = V * D * 4 + (V + 1) * F * 4 + V * F * 4
    return {"shape": {"V": V, "D": D, "F": F, "op": op}, "err": err,
            "ms": cuda_ms(torch, eops.ell_spmm_cuda, lambda: (ell, xs, op)),
            "plain_ms": cuda_ms(torch, eops.ell_spmm_ref,
                                lambda: (ell, xs, op)),
            "library_ms": library_ms, "nbytes": nbytes,
            "t_ops_ms": V * D * F / F32_OPS_PER_S * 1e3}


def phase_kernels(torch, dev_info, peaks, main_rec, launches, share_rec,
                  share_launches, plan_rec, plan_launches) -> list[dict]:
    from repro_torch.kernels.msbfs_expand import ops as mops
    from repro_torch.kernels.pairwise_popcount import ops as pops
    from repro_torch.kernels.path_join import ops as jops

    clock_hz = dev_info["max_sm_clock_mhz"] * 1e6
    int_rate = INT_PER_CLK_SM * dev_info["sms"] * clock_hz
    rows = []
    # each kernel's launches on the path that runs it
    launches = dict(launches, ell_spmm=plan_launches["ell_spmm"])

    def bound(nbytes, t_ops_ms):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return {"bound_ms": max(t_bytes, t_ops_ms),
                "bound_by": "bytes" if t_bytes >= t_ops_ms else "operations",
                "bytes": nbytes}

    def row(name, shape, err, ms, plain_ms, nbytes, t_ops_ms,
            library_ms=None, **extra):
        src, replaces = KERNEL_ROWS[name]
        r = {"name": name, "route": "cuda", "source": src,
             "replaces": replaces, "launches": launches[name],
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             **bound(nbytes, t_ops_ms), "library_ms": library_ms,
             "shape": shape, **extra}
        emit({"phase": "kernel", **r})
        require(err == 0, f"{name}: kernel disagrees with its plain version")
        rows.append(r)

    # -- msbfs_step: in place on visited/dist, so each run gets copies
    ell, fr, vis, dist, hop = main_rec["msbfs_step"].best
    V, D = ell.shape
    W = fr.shape[1]

    def fresh():
        return ell, fr, vis.clone(), dist.clone(), hop

    a, b = fresh(), fresh()
    out_k = mops.msbfs_step_cuda(*a)
    out_p = mops.msbfs_step_ref(*b)
    torch.cuda.synchronize()
    err = max_abs_err(torch, [(out_k, out_p), (a[2], b[2]), (a[3], b[3])])
    new_bits = popcount_total(torch, out_k)
    row("msbfs_step", {"V": V, "D": D, "W": W, "hop": hop}, err,
        cuda_ms(torch, mops.msbfs_step_cuda, fresh),
        cuda_ms(torch, mops.msbfs_step_ref, fresh),
        nbytes=V * D * 4 + (V + 1) * W * 4 * 2 + V * W * 4 * 2 + new_bits,
        t_ops_ms=V * W * D / int_rate * 1e3, new_bits=new_bits)

    # -- pairwise_popcount: out is symmetric, so the function needs the
    # Q(Q+1)/2 pairs i <= j only. Two units can do that work: the CUDA
    # cores' popc (what the kernel uses; rate: the larger of the
    # programming guide's and the measured one) and the tensor cores'
    # 1-bit AND+popc MMA (measured; no rate is published for the H100).
    # The bound takes the faster.
    (words,) = main_rec["pairwise_popcount"].best
    Q, W = words.shape
    k_out = pops.pairwise_popcount_cuda(words)
    p_out = pops.intersections(words)
    torch.cuda.synchronize()
    err = max_abs_err(torch, [(k_out, p_out)])
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    gam = mops.unpack_bits(words, W * 32).float()
    lib = (gam @ gam.T).to(torch.int32)
    require(torch.equal(lib, k_out), "float32 matmul disagrees")
    pairs = Q * (Q + 1) // 2
    popc_rate = max(POPC_PER_CLK_SM * dev_info["sms"] * clock_hz,
                    peaks["popc_per_s"])
    t_popc = pairs * W / popc_rate * 1e3
    t_b1 = pairs * W * 32 / peaks["b1_bit_pairs_per_s"] * 1e3
    row("pairwise_popcount", {"Q": Q, "W": W}, err,
        cuda_ms(torch, pops.pairwise_popcount_cuda, lambda: (words,)),
        cuda_ms(torch, pops.intersections, lambda: (words,)),
        nbytes=Q * W * 4 + Q * Q * 4, t_ops_ms=min(t_popc, t_b1),
        library_ms=cuda_ms(torch, lambda g: g @ g.T, lambda: (gam,)),
        library_call="float32 gam @ gam.T over the unpacked (Q, 32*W) "
                     "Gamma, TF32 off",
        ops={"pairs": pairs, "popc": pairs * W, "bit_pairs": pairs * W * 32},
        t_ops_popc_ms=t_popc, t_ops_b1_mma_ms=t_b1,
        popc_per_s=popc_rate, b1_bit_pairs_per_s=peaks["b1_bit_pairs_per_s"])
    del gam

    # -- path_member / rowwise_overlap: the main batch's heaviest call is
    # the row; the sharing batch's heaviest (frontiers past min_cap) is
    # held against the plain version and timed as well
    def path_member(rec):
        verts, cand = rec["path_member"].best
        N, L = verts.shape
        D = cand.shape[1]
        err = max_abs_err(torch, [(jops.path_member_cuda(verts, cand),
                                   jops.path_member_ref(verts, cand))])
        return ({"N": N, "L": L, "D": D}, err,
                cuda_ms(torch, jops.path_member_cuda, lambda: (verts, cand)),
                cuda_ms(torch, jops.path_member_ref, lambda: (verts, cand)),
                N * L * 4 + 2 * N * D * 4, N * D * L / int_rate * 1e3)

    def rowwise_overlap(rec):
        a_v, b_v = rec["rowwise_overlap"].best
        N, LA = a_v.shape
        LB = b_v.shape[1]
        err = max_abs_err(torch, [(jops.rowwise_overlap_cuda(a_v, b_v),
                                   jops.rowwise_overlap_ref(a_v, b_v))])
        return ({"N": N, "LA": LA, "LB": LB}, err,
                cuda_ms(torch, jops.rowwise_overlap_cuda, lambda: (a_v, b_v)),
                cuda_ms(torch, jops.rowwise_overlap_ref, lambda: (a_v, b_v)),
                N * (LA + LB + 1) * 4, N * LA * LB / int_rate * 1e3)

    for name, measure in (("path_member", path_member),
                          ("rowwise_overlap", rowwise_overlap)):
        shape2, err2, ms2, plain2, nbytes2, t_ops2 = measure(share_rec)
        require(err2 == 0, f"{name}: kernel disagrees with its plain "
                           f"version on the sharing batch")
        shape, err, ms, plain_ms, nbytes, t_ops = measure(main_rec)
        row(name, shape, err, ms, plain_ms, nbytes=nbytes, t_ops_ms=t_ops,
            sharing={"launches": share_launches[name], "shape": shape2,
                     "max_abs_err": err2, "ms": ms2, "plain_ms": plain2,
                     **bound(nbytes2, t_ops2)})

    # -- ell_spmm: the heaviest call of the default configuration (F = 1,
    # sum), then two synthetic shapes on the same ELL table with random
    # float32 features: equal bit for bit only by the order of the adds
    ell, xs, op = plan_rec["ell_spmm"].best
    gen = torch.Generator(device="cuda").manual_seed(0)
    synthetic = []
    for F, sop in ((128, "sum"), (8, "max")):
        fill = 0.0 if sop == "sum" else float("-inf")
        x = torch.randn((ell.shape[0], F), generator=gen, device="cuda")
        xs_syn = torch.cat([x, torch.full((1, F), fill, device="cuda")])
        del x
        m = measure_ell_spmm(torch, ell, xs_syn, sop)
        del xs_syn
        require(m["err"] == 0, f"ell_spmm disagrees with its plain version "
                               f"at {m['shape']}")
        synthetic.append({"shape": m["shape"], "max_abs_err": m["err"],
                          "ms": m["ms"], "plain_ms": m["plain_ms"],
                          "library_ms": m["library_ms"],
                          **bound(m["nbytes"], m["t_ops_ms"])})
        torch.cuda.empty_cache()
    m = measure_ell_spmm(torch, ell, xs, op)
    row("ell_spmm", m["shape"], m["err"], m["ms"], m["plain_ms"],
        nbytes=m["nbytes"], t_ops_ms=m["t_ops_ms"],
        library_ms=m["library_ms"],
        library_call="torch.sparse.mm of the CSR adjacency (pad entries "
                     "dropped) and X[:V]; sum only",
        launches_from="default-config BATCH run of the sharing batch "
                      "(phase planners)",
        nonzero_features=plan_rec["ell_spmm"].best_work,
        synthetic=synthetic)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20,
                    help="graph vertices (default 2**20)")
    ap.add_argument("--queries", type=int, default=256,
                    help="queries in the batch (default 256)")
    ap.add_argument("--sharing-queries", type=int, default=64,
                    help="queries in the sharing batch (default 64)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    dev_info = phase_device(torch)
    phase_build()
    g, queries = phase_workload(args.n, args.queries)
    session, main_rec, launches, main_report = phase_main(torch, g, queries)
    share_rec, share_launches, share_queries, share_report = phase_sharing(
        torch, g, session, args.sharing_queries)
    plan_rec, plan_launches = phase_planners(
        torch, g, session, queries, main_report, share_queries, share_report)
    phase_cache(g, share_queries, share_report)
    peaks = phase_peaks(torch, dev_info)
    rows = phase_kernels(torch, dev_info, peaks, main_rec, launches,
                         share_rec, share_launches, plan_rec, plan_launches)
    emit({"phase": "done", "t_total_s": time.perf_counter() - t_start})
    print(dev_info["nvidia_smi"], flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": dev_info["kind"],
                                 "count": dev_info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
