#!/usr/bin/env python3
"""Trace where the sharded executor's time goes on one GPU.

    python3 probes/sharded_stalls.py [OUT.json]   # from a checkout's root

Needs one CUDA card. It builds the kernels and ``chip_smoke.py``'s
workload (the 2**20-vertex community graph, its 256-query main batch and
the 64-query sharing batch), then, with ``EngineConfig(trace=True)`` so
every stage is a span of the process tracer (thread by thread):

1. *cold*: ``--fresh N`` times (default 1) a fresh four-replica engine
   and its main batch (``plan_caps=False``, as phase ``sharded`` runs it
   first), then four times a fresh four-replica
   engine (``mesh=["cuda:0"] * 4``, ``balance_clusters=True``) and its
   first BATCH run of the sharing batch: plain; with the replicas and
   their streams made before the run; with ``sys.setswitchinterval`` at
   0.1 ms; and under ``torch.profiler`` tracing the host and the card
   (the CUDA runtime calls that waited longest). Each run's replica
   walls, each replica thread's stage spans and the caching allocator's
   counts (bytes reserved, device allocations and frees, retries after
   a failed allocation).
2. *warm*: the last engine's second run, the same spans.
3. *serving* (unless ``--no-serving``): ``chip_smoke.py``'s streaming
   phase, then its 1.0x level replayed on a one-replica and a
   four-replica engine; per micro-batch the batch wall and the spans
   inside it, summed by name and thread.

Prints one line, ``PROBE`` and a JSON summary; writes every span total
to ``--out`` (default ``build/sharded_stalls.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def span_totals(spans, t0=None, t1=None) -> dict:
    """Spans summed by (thread, name): count and seconds. Threads are
    named by order of first appearance: ``main``, then ``r1``, ``r2``
    ... for the replica workers."""
    import threading
    main = threading.get_ident()
    names, out = {}, {}
    for sp in spans:
        if t0 is not None and not (sp.t0 >= t0 and sp.t1 <= t1):
            continue
        th = "main" if sp.tid == main else names.setdefault(
            sp.tid, f"r{len(names) + 1}")
        key = f"{th}:{sp.name}"
        c, s = out.get(key, (0, 0.0))
        out[key] = (c + 1, s + sp.duration)
    return {k: {"n": c, "s": round(s, 6)} for k, (c, s) in
            sorted(out.items(), key=lambda kv: -kv[1][1])}


def host_waits(prof, torch, top: int = 12) -> dict:
    """The CUDA runtime calls of a host + card profile, summed by name,
    and the longest single host events."""
    cuda, longest = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            continue
        dur = (e.end_ns() - e.start_ns()) / 1e6
        name = e.name()
        if name.startswith("cuda") or name.startswith("cu"):
            n, tot, mx = cuda.get(name, (0, 0.0, 0.0))
            cuda[name] = (n + 1, tot + dur, max(mx, dur))
        longest.append((dur, name, e.start_thread_id()))
    longest.sort(reverse=True)
    return {"runtime_calls": {k: {"n": n, "ms": round(t, 3),
                                  "max_ms": round(m, 3)}
                              for k, (n, t, m) in sorted(
                                  cuda.items(), key=lambda kv: -kv[1][1])},
            "longest": [(round(d, 3), n, t) for d, n, t in longest[:top]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build",
                                                  "sharded_stalls.json"))
    ap.add_argument("--fresh", type=int, default=1)
    ap.add_argument("--no-serving", action="store_true")
    args = ap.parse_args(argv)
    out_path = args.out
    import torch
    if not torch.cuda.is_available():
        print("sharded_stalls: no CUDA device", file=sys.stderr)
        return 2
    root = os.getcwd()
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import EngineConfig, PathSession, generators
    from repro_torch.obs import trace as obstrace

    cs.phase_build()
    g, queries = cs.phase_workload(1 << 20, 256)
    share = generators.similar_queries(g, 64, similarity=0.8,
                                       k_range=(7, 8), seed=2)
    mesh = ["cuda:0"] * 4
    tr = obstrace.tracer()
    summary, full = {}, {}

    PathSession(g, EngineConfig(), device="cuda").run(share)   # warm
    summary["allocator_warm"] = cs.allocator_counts(torch)
    for i in range(args.fresh):
        t0 = time.perf_counter()
        s4 = PathSession(g, EngineConfig(plan_caps=False, trace=True),
                         mesh=mesh, device="cuda")
        rep = s4.run(queries, planner="batch")
        summary[f"main_4_{i}"] = {
            "t_wall_s": rep.stats["t_wall_s"],
            "t_place_s": rep.stats.get("t_place_s"),
            "host_s": time.perf_counter() - t0,
            "replica_t_wall_s": [d["t_wall_s"] for d in
                                 rep.stats["per_device"]],
            "allocator": cs.allocator_counts(torch)}
        del s4, rep

    def cold(variant: str):
        s4 = PathSession(g, EngineConfig(balance_clusters=True, trace=True),
                         mesh=mesh, device="cuda")
        if variant == "replicas_first":
            s4.engine.executor.replicas()
        torch.cuda.synchronize()
        tr.reset()
        before = cs.allocator_counts(torch)
        prof = None
        old = sys.getswitchinterval()
        if variant == "switch_0.1ms":
            sys.setswitchinterval(1e-4)
        t0 = time.perf_counter()
        try:
            if variant == "profiled":
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    rep = s4.run(share, planner="batch")
                    torch.cuda.synchronize()
            else:
                rep = s4.run(share, planner="batch")
        finally:
            sys.setswitchinterval(old)
        host = time.perf_counter() - t0
        row = {"t_wall_s": rep.stats["t_wall_s"], "host_s": host,
               "t_fanout_s": rep.stats.get("t_fanout_s"),
               "replica_t_wall_s": [d["t_wall_s"] for d in
                                    rep.stats["per_device"]],
               "replica_queries": [d["n_queries"] for d in
                                   rep.stats["per_device"]],
               "allocator": [before, cs.allocator_counts(torch)]}
        spans = span_totals(tr.spans())
        if prof is not None:
            row["host"] = host_waits(prof, torch)
        return s4, row, spans

    for variant in ("plain", "replicas_first", "switch_0.1ms", "profiled"):
        s4, row, spans = cold(variant)
        summary[f"cold_{variant}"] = row
        full[f"cold_{variant}"] = spans
        row["top_spans"] = dict(list(spans.items())[:14])
        if variant == "profiled":
            tr.reset()
            t0 = time.perf_counter()
            rep = s4.run(share, planner="batch")
            spans = span_totals(tr.spans())
            summary["warm"] = {
                "t_wall_s": rep.stats["t_wall_s"],
                "replica_t_wall_s": [d["t_wall_s"] for d in
                                     rep.stats["per_device"]],
                "top_spans": dict(list(spans.items())[:14])}
            full["warm"] = spans
        del s4

    # serving: the 1.0x level on one replica and on four
    level = None if args.no_serving else cs.phase_streaming(torch, g)
    for name, kw in () if level is None else (("one", {}),
                                              ("four", {"mesh": mesh})):
        engine = PathSession(level["g_start"], EngineConfig(
            min_cap=64, cache_bytes=64 << 20, trace=True), device="cuda",
            **kw).engine
        tr.reset()
        rep = cs.stream_replay(engine, level["events"], level["policy"],
                               level["cost"])
        spans = tr.spans()
        batches = []
        for sp in spans:
            if sp.name == "serve.batch":
                batches.append({"wall_s": sp.duration,
                                "spans": span_totals(spans, sp.t0, sp.t1)})
        walls = sorted(b["wall_s"] for b in batches)
        agg = {}
        for b in batches:
            for k, v in b["spans"].items():
                n, s = agg.get(k, (0, 0.0))
                agg[k] = (n + v["n"], s + v["s"])
        summary[f"serving_{name}"] = {
            "batches": len(batches), "wall_p50_s": walls[len(walls) // 2],
            "wall_sum_s": sum(walls),
            "spans_in_batches": {k: {"n": n, "s": round(s, 4)} for k, (n, s)
                                 in sorted(agg.items(),
                                           key=lambda kv: -kv[1][1])[:24]}}
        full[f"serving_{name}"] = batches
        del engine, rep

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"summary": summary, "spans": full}, f)
    print("PROBE", json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
