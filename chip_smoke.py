#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                    # the full workload, one card
    python3 chip_smoke.py --n 65536 --queries 32 --sharing-queries 16
                                             # a quicker, smaller run

Phases 4 and 5 drive the first slice's path (``plan_caps=False``, BATCH
and BASIC); phase 6 the observability layer (stage spans annotated under
``torch.profiler``, compile telemetry, the launch audit); phases 7 and 8
the engine's default configuration (``EngineConfig()``: walk-count
capacity planning on ``ell_spmm``) under every planner, and the
cross-batch cache; phase 9 incremental graph deltas under both
``delta_backend`` values; phase 10 streaming serving
(``PathSession.submit`` / ``pump`` / ``results`` over the
``StreamingServer``, driven by exp11's open-loop arrival streams); phase
11 sharded execution (four engine replicas on the card, each on its own
CUDA stream); phase 12 the kernel ops API (``msbfs_hop_packed``,
``path_overlap`` and the join-validity matrices); phase 13 the
transformer's serving path
(granite-8b prefill and KV-cache decode on the ``flash_attention``
kernel).

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
               the inputs of each kernel's heaviest call (not timed; for
               ``path_member`` and ``rowwise_overlap`` the fused expand
               level and joins that carry them). In every engine phase
               each ``path_member`` launch is a fused level and each
               ``rowwise_overlap`` launch a fused join
               (``LAUNCHES["level_fused"]``, ``["join_fused"]``), and the
               similarity stage launches ``gamma_pack`` and
               ``pairwise_popcount`` once per direction. The recorded run
               is repeated with the index and similarity stages on the
               plain versions of their kernels (``msbfs_step_ref``;
               ``gamma_pack_ref`` + ``intersections``): the distances, μ,
               the clusters, the Ψ plans and every path set must be equal.
5. sharing  -- a second batch on the same graph, 64 overlapping queries
               (``similar_queries``, similarity 0.8, k in 7..8), whose
               shared HC-s path queries and splice joins are what the
               paper is about and whose frontiers outgrow ``min_cap``:
               launches counted, oracle and BASIC checks, then a wrapped
               run that keeps the heaviest join-kernel inputs, checked
               against the plain index and similarity stages as in phase
               4. Then a
               card-only ``torch.profiler`` window over one warm BATCH
               run (device busy share, device events per level and per
               join, copies to the host) and over one expand level, one
               keyed and one splice join of that batch, each with its
               readback of count and overflow: at most 3 launches each
               (the keyed join's pair-setup ops apart, listed by name)
               and one copy to the host.
6. obs      -- the observability layer on the card. One warm sharing
               BATCH run with ``EngineConfig(trace=True,
               trace_annotations=True, log_compiles=True)`` under
               ``torchprof.profile_run`` (CPU and CUDA activity; Chrome
               trace under ``build/obs/``): each stage span's host wall
               beside the device time of the kernels launched inside it
               (each device event charged through its CUDA runtime call to
               the annotations open on the launching thread) and its busy
               share; at most 5% of the device time may fall outside every
               stage. One warm main-batch run with the Python stacks on
               (``with_stack=True``): the host functions that take most of
               ``t_detect`` (self and total time inside ``detect.cluster``).
               Then a fresh process (``--obs-child``) holds the compile
               log to ``tests/test_recompile.py``'s contract: its cold run
               compiles exactly the kernel libraries it loads, two warm
               runs and three in-bucket deltas (``delta_backend="msbfs"``)
               none; and it runs ``repro_torch.analysis``'s launch audit of
               the CUDA arm, whose launch and sync counts must be within
               the committed ``LAUNCH_BUDGETS.json``. Every failed check
               is listed in the phase line and fails the run.
7. planners -- ``PathSession(g, EngineConfig(), device="cuda")``, the
               default configuration, runs the sharing batch under
               ``batch``, ``batch+``, ``basic+``, ``pathenum`` and
               ``auto``, each with its own launch counts (``ell_spmm``
               must launch, every time through its F = 1 kernel
               ``ell_gather_f1_kernel``) and stage times; every path set
               must equal
               the ``plan_caps=False`` BATCH run of phase 5. The overflow
               retries of node enumeration are counted with and without
               ``plan_caps`` (by wrapping ``_run_node_once``). ``auto``
               then answers the 256-query main batch (routes, wall time,
               path sets equal to phase 4's), and a last wrapped
               ``batch`` run keeps the inputs of the heaviest
               ``ell_spmm`` call.
8. cache    -- ``EngineConfig(cache_bytes=256 << 20)``: the sharing batch
               twice (the second must materialize nothing, hit, and give
               identical rows), then ``update_graph(g)`` and a run that
               must materialize again.
9. delta    -- ``EngineConfig(cache_bytes=256 << 20)`` with
               ``delta_backend="host"`` and ``"msbfs"``, two sessions side
               by side on one batch: the sharing batch, else (when its hop
               balls leave fewer than 8 x 128 vertices outside them) the
               main batch, else the main batch's k = 4 queries. A cold
               run, then four deltas, each applied to both sessions and
               followed by a rerun: *far* (128 deletions + 128 absent
               insertions among the vertices beyond every query's hop
               radius: the cache stays warm), *near* (one edge of a
               returned path: evicts, and the path is gone), *wide*
               (0.25% of m deletions + as many insertions: full
               invalidation) and *cap* (in-edges into a vertex of maximum
               in-degree past ``r_ell_cap``: the tables are rebuilt with
               caps that do not shrink). The two reports must agree; the
               ``"msbfs"`` session must launch ``msbfs_step`` in
               ``apply_delta`` and its distances equal ``host_set_dist``'s
               within the radius; every rerun's path sets equal a fresh
               session's on the new graph, and a few queries the oracle's.
               ``t_apply_s`` is printed beside an ``update_graph`` of the
               same graph.
10. streaming -- exp11's open-loop serving (``benchmarks/exp11_open_loop.py``)
               on the same graph: ``EngineConfig(min_cap=64,
               cache_bytes=64 << 20)`` (capacity planning on), planner
               ``batch``, two replica groups. Admission: micro-batches of
               4..16, max delay 1.5 quanta, at most 32 waiting, expired
               deadlines shed, tenants gold / silver / bronze (25 / 35 /
               40%, weights 4 / 2 / 1, deadlines 4 / 10 / no quanta);
               sources Zipf-skewed (a = 1.05) over one seeded
               permutation, k in 3..4, outputs 60% paths, 25% count, 15%
               exists; half of the targets Zipf-drawn as in exp11 (at
               2**20 beyond k hops: empty answers), half the end of a
               random walk of 1..k hops from the source (a path exists); a balanced delta of 4 edges in and 4 out every 24
               arrivals. A ``ServiceModelClock`` charges c0 + c1 * Q per
               dispatch (c0, c1 from warm walls at 4 and 16 queries), so
               admission is deterministic. Levels: Poisson at 0.5x and
               1.0x and a two-state MMPP at 3.0x the calibrated
               capacity, 128 arrivals each (exp11's floor; its default is
               320). Checks: every qid resolves exactly once (OK or a
               typed SHED), 8 OK path results a level (4 non-empty, 4
               empty where there are) equal the brute-force oracle on the
               graph they were answered on, the 3.0x level sheds;
               ``msbfs_step``, ``gamma_pack``, ``pairwise_popcount``, the
               fused level and join and ``ell_gather_f1`` launch in each
               stream (each level, the replay, the failover segment: the
               counts are set to 0 before each); the 1.0x level
               runs with the span tracer on (its Chrome export, loaded
               back, is summarized in the phase line) and is replayed from
               its start graph with the same batches, sheds, completion
               times and results; then a failover segment (48 queries,
               three groups, group 0 dies on its second item): results
               exactly once, one failover, the cache kept, a revived
               group serves.
11. sharded -- ``mesh=["cuda:0"] * 4``: four engine replicas on the card,
               replica 0 on the caller's stream, the others each on its
               own. The main batch (``plan_caps=False``, 239 clusters)
               under ``batch``: rows in the same order, counts and
               clusters equal to phase 4's run, ``per_device`` with 4
               entries adding up to the run. ``n_devices=1`` is the
               identity: the sharing batch under ``batch`` and ``auto``
               equal to phase 7's runs, with no ``per_device``. The
               sharing batch forms one cluster, which no mesh splits, so
               the four-replica engine runs it with ``balance_clusters``
               (4 clusters); its first, cold run goes under a card-only
               profiler between two readings of the caching allocator,
               and each lightly loaded replica must finish within
               ``SHARDED_COLD_MAX_S``. It is held to the identity engine
               given the same partition under ``batch``, ``basic`` and
               ``auto``: rows, counts, clusters, cluster planners;
               ``auto``'s cluster routes follow the router's rule (RED
               iff a cluster's summed estimate clears ``red_min_cost``),
               and if none is RED at the default 2**22 the run is
               repeated with the heaviest cluster's cost as the
               threshold, where RED must appear. The six path kernels launch in the sharing batch's
               run; warm walls with four replicas and one (medians of 3);
               one warm run under a card-only profiler, where the fused
               level must run on at least two streams (busy share,
               device time over the fan-out's wall, the most streams
               with a kernel in flight at once). Deltas: a plain and a
               four-replica engine (64 MB caches) on the main batch's
               k = 4 queries, phase 9's far and near deltas applied to
               both: equal ``n_touched``, 4 equal cache epochs, replica
               tables equal to the primary's, rows equal after each.
               Serving: phase 10's traced 1.0x level replayed from its
               start graph over a four-replica engine: the same qids
               resolve exactly once to the same outcomes at the same
               model times, the same batch cuts, no steals, every
               micro-batch of more than one cluster placed on the 4
               replicas (``per_device``, ``n_devices``), and a batch wall
               p50 within ``SHARDED_SERVE_MAX_X`` of phase 10's.
12. ops     -- the ops API on the main path's inputs: ``msbfs_hop_packed``
               on the frontier of the heaviest ``msbfs_step`` call of the
               main batch, ``path_overlap`` on 4096 x 4096 rows of 6
               vertex ids with -1 pads, ``splice_join_valid`` on the
               sharing batch's heaviest splice join and
               ``keyed_join_valid`` on its heaviest keyed join with
               NA*NB <= 2**26, whose valid-pair sums must equal the joins'
               counts.
13. lm      -- the graph state freed first. granite-8b ``CONFIG`` (36
               layers, d_model 4096, 32 q-heads, 8 kv-heads, hd 128,
               d_ff 14336, vocab 49152: 8.25 G parameters) in bf16, drawn
               on the card from a seeded ``torch.Generator`` with the JAX
               package's init law. ``LM.prefill`` of 4 requests x 2048
               prompt tokens from ``TokenStream(vocab, 4, 2048, seed=0)``
               (the ``prefill_32k`` shape with seq 32768 -> 2048 and batch
               32 -> 4): cold once, warm twice. Then ``decode_step`` into
               a bf16 cache of 544: the first 512 prompt tokens
               teacher-forced, then 32 greedy steps (per-step latency and
               tokens/s of the first 28; the last 4, and a fourth
               prefill, under ``torch.profiler`` tracing the card only,
               for the device time by kernel family and the busy share
               of that same window). Checks: (a) full width, float32, 4
               layers (TF32 off): ``decode_step``'s teacher-forced
               logits at all 512 positions equal ``lm_forward`` + unembed
               over the same tokens at atol = rtol = 2e-3 (the JAX
               package's decode test); (b) the same at full depth in
               bf16, relative L2 error at most 5e-2 at every position;
               (c) every logit finite; (d) ``flash_attention`` launched
               exactly once per layer per ``prefill`` / ``lm_forward`` /
               ``decode_step``, each prefill and forward on the wgmma
               route and each decode step on the split-K route (check (a)
               on the float32 route).
14. peaks   -- measured peak rates of 32-bit ``popc`` on the CUDA cores
               and of the tensor cores' 1-bit AND+popc MMA (no published
               H100 rate exists for either), used in the popcount bound.
15. kernels -- first a card-only ``torch.profiler`` window over one
               ``similarity_matrix`` call of the main batch (device time
               by kernel name against the call's host wall). Then each
               kernel again on the inputs of its heaviest call in the
               main path (and, for the join kernels, in the sharing
               batch; for ``msbfs_step`` also the W = 1 sweep of phase
               ``delta``; for ``ell_spmm`` also two synthetic shapes on
               the graph's ELL table with random float32 features, F = 128
               sum and F = 8 max; for ``path_overlap`` also the half
               rows of phase ``ops``'s splice and keyed joins), held
               against its plain PyTorch
               version on the card (exact equality: the outputs are
               integers, or float32 sums taken in the same order;
               ``path_member`` and ``rowwise_overlap`` on the prefixes,
               candidates and half rows of the heaviest fused level and
               join), timed
               with CUDA events (median of 10 warm runs) beside the plain
               version, one PyTorch library call where one computes the
               same function, and the least time the card could take.
               ``flash_attention`` runs on seeded random inputs at six
               shapes: the prefill's (4 x 2048, causal), the last decode
               step's (one query over 544 cached keys), a mid-cache
               decode step (300 valid keys of 544, the tail NaN), one
               query tail of the published ``prefill_32k`` length (512
               queries at ``q_offset`` 32256 over 32768 keys), and a
               prompt chunk of 8 queries after 292 cached keys (300 of
               544 valid) at hd 128 and at hd 96; the decode and chunk
               rows read a layer slice of a two-layer cache. In bf16 it
               is held to its plain version at atol = rtol = 1e-2 and a
               relative L2 error of at most 1e-2 in every output row (one
               query, one q-head); in float32 at 3e-5 / 1e-4. Each shape
               must take its route (wgmma for the prefill, the long row
               and the chunk at hd 128, mma for the chunk at hd 96,
               split-K for the decode rows, whose output is also held
               to ``flash_attention_splitk_ref`` at the same bf16
               tolerance). Its library call is
               ``scaled_dot_product_attention``. Each shape is also
               timed as 50 launches captured in one CUDA graph and
               replayed between one pair of CUDA events (``device_ms``,
               per launch; SDPA the same way), since a single launch's
               ``ms`` includes the Python wrapper, which at the decode
               rows takes longer than the kernels; ``ell_spmm``'s F = 1
               row likewise. Rows ``expand_level`` and ``join``: the
               fused passes on the heaviest recorded level and keyed join
               of the main batch (and of the sharing batch, its splice
               join, and the counting join on each keyed join's inputs),
               equal to their plain compositions on every output, timed
               alone, as 50 calls in one CUDA graph and beside the plain
               composition, bound by bytes. ``msbfs_step``,
               ``gamma_pack``, ``pairwise_popcount``, ``msbfs_expand``
               and ``path_overlap`` (on each of its three inputs) are
               also timed as 50 calls in one CUDA graph (``device_ms``;
               each ``msbfs_step`` call restores visited from a saved copy
               first, and the copies' own graph time is subtracted), and
               ``msbfs_step`` so on every level of the main batch's index
               build (``levels``: per hop and summed).
               ``pairwise_popcount``'s library calls are three exact
               products of the unpacked Γ, each required equal to the
               kernel: float32 (TF32 off), bf16 with float32 output
               (reduced-precision reduction off) and ``torch._int_mm`` on
               int8; ``library_ms`` is the fastest. ``path_overlap``'s
               operations are those of its kernel's formulation
               (``overlap_work``): the int8 tensor-core multiply-adds of
               each A tile's count product, and two ALU operations per
               (p, q) pair on tiles whose dictionary overflows;
               ``alu_bound_ms`` keeps the count of a compare per pair of
               every output for comparison.

Then a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failed check
exits non-zero before that line; without a CUDA device the script exits
non-zero at once. It imports nothing of JAX and nothing of ``repro``.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import json
import os
import re
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
# published H100 SXM dense bf16 tensor-core rate, operations/s
BF16_OPS_PER_S = 989e12
# published H100 SXM dense int8 tensor-core rate, operations/s
INT8_OPS_PER_S = 1979e12

KERNEL_ROWS = {
    "msbfs_step": ("src/repro_torch/csrc/msbfs_step.cu",
                   "src/repro/kernels/msbfs_expand/kernel.py:95"),
    "pairwise_popcount": ("src/repro_torch/csrc/pairwise_popcount.cu",
                          "src/repro/kernels/pairwise_popcount/kernel.py:39"),
    # the packing of Γ that feeds pairwise_popcount_pallas on the TPU path
    "gamma_pack": ("src/repro_torch/csrc/pairwise_popcount.cu",
                   "src/repro/kernels/pairwise_popcount/ops.py:15"),
    "path_member": ("src/repro_torch/csrc/path_join.cu",
                    "src/repro/kernels/path_join/kernel.py:109"),
    "rowwise_overlap": ("src/repro_torch/csrc/path_join.cu",
                        "src/repro/kernels/path_join/kernel.py:70"),
    "ell_spmm": ("src/repro_torch/csrc/ell_spmm.cu",
                 "src/repro/kernels/ell_spmm/kernel.py:47"),
    "msbfs_expand": ("src/repro_torch/csrc/msbfs_step.cu",
                     "src/repro/kernels/msbfs_expand/kernel.py:44"),
    "path_overlap": ("src/repro_torch/csrc/path_join.cu",
                     "src/repro/kernels/path_join/kernel.py:39"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:79"),
    # the fused passes that carry path_member and rowwise_overlap on the
    # engine's path: one expand level, one join
    "expand_level": ("src/repro_torch/csrc/path_join.cu",
                     "src/repro/kernels/path_join/kernel.py:109"),
    "join": ("src/repro_torch/csrc/path_join.cu",
             "src/repro/kernels/path_join/kernel.py:70"),
}
# each fused pass and the kernel whose count it also adds to
FUSED = {"level_fused": "path_member", "join_fused": "rowwise_overlap"}
# launches allowed per expand level and per join (memsets included; the
# keyed join's pair setup apart)
FUSED_LAUNCH_BUDGET = 3
# the kernels of the first slice's path (plan_caps=False), which phases 4
# and 5 drive; ell_spmm runs only where capacities are planned (phase 7)
FIRST_SLICE = ("msbfs_step", "pairwise_popcount", "gamma_pack",
               "path_member", "rowwise_overlap")
# the similarity stage's launches per batch: one of each per direction
SIMILARITY_LAUNCHES = 2
# the planners phase 7 drives with the default configuration
PLANNERS = ("batch", "batch+", "basic+", "pathenum", "auto")
# the kernels of the ops API, which phase 12 drives
OPS_KERNELS = ("msbfs_expand", "path_overlap")
# phase 9: the far delta's deletions and insertions (exp10's background
# churn), and the pool it needs beyond every hop ball (exp10's "strict")
FAR_EDGES = 128
FAR_POOL = 8 * FAR_EDGES
# the wide delta's deletions (and insertions) per edge: exp10's rate
WIDE_RATE = 0.0025
# phase streaming: exp11's open-loop serving (benchmarks/exp11_open_loop.py)
# on this graph: micro-batches of at most 16, tenants (name, admission
# weight, deadline in batch quanta), the output mix, the offered loads
# (arrival process, multiple of the calibrated capacity), Zipf-skewed
# endpoints over one seeded permutation of the vertices, k in 3..4
# (exp11's traffic), but with STREAM_REACH of the targets the end of a
# random walk of 1..k hops from the source: exp11's Zipf pairs at 2**20 lie
# beyond 4 hops, and a stream of empty answers never enumerates or joins
STREAM_MAX_BATCH = 16
STREAM_TENANTS = (("gold", 4.0, 4.0), ("silver", 2.0, 10.0),
                  ("bronze", 1.0, None))
STREAM_TENANT_P = (0.25, 0.35, 0.40)
STREAM_OUTPUTS = (("paths", 0.60), ("count", 0.25), ("exists", 0.15))
STREAM_LEVELS = (("poisson", 0.5), ("poisson", 1.0), ("mmpp", 3.0))
STREAM_ZIPF_A = 1.05
STREAM_K = (3, 4)
STREAM_REACH = 0.5
# arrivals per level: exp11's floor, cut from its 320
STREAM_ARRIVALS = 128
# OK path results per level held to the brute-force oracle (half of them
# non-empty, half empty, where a level has them)
STREAM_ORACLE = 8
# the level run with the tracer on, and replayed for determinism
STREAM_TRACED = 1.0
# the failover segment: queries, replica groups, gamma (exp11's)
STREAM_FAILOVER = (48, 3, 0.9)
# the kernels every stream must launch (LAUNCHES names)
STREAM_KERNELS = ("msbfs_step", "gamma_pack", "pairwise_popcount",
                  "level_fused", "join_fused", "ell_gather_f1")
# phase sharded: four engine replicas on the one card
SHARDED_MESH = ["cuda:0"] * 4
# the most seconds a lightly loaded replica (one query of the balanced
# sharing batch; 0.08-0.15 s cold on an H100) may take in the first,
# cold four-replica run: a wait that every replica shares shows there
SHARDED_COLD_MAX_S = 1.0
# the most a sharded micro-batch's wall p50 may be over the one-replica
# server's on the same stream (1.6-2.0x on an H100: the replica threads'
# host work contends for the interpreter)
SHARDED_SERVE_MAX_X = 3.0
# phase 13: the published configuration served, prefill_32k cut in
# sequence (32768 -> 2048) and batch (32 -> 4), the decode cache's
# teacher-forced and greedy steps, and check (a)'s depth
LM_ARCH = "granite-8b"
LM_BATCH, LM_PROMPT = 4, 2048
LM_TEACHER, LM_GREEDY = 512, 32
LM_PROFILED = 4              # the last greedy steps, under torch.profiler
LM_CHECK_LAYERS = 4
LM_F32_TOL = 2e-3            # tests/test_models.py's decode == prefill
LM_BF16_REL_L2 = 5e-2        # bf16 rounding over 36 layers
# the kernel row's shapes: (name, B, Sq, Skv, Hq, Hkv, hd, q_offset,
# kv_valid_len); None = the defaults (Skv - Sq, Skv). The rows with a
# kv_valid_len read layer 1 of a two-layer (2, B, Skv, Hkv, hd) cache: a
# decode step, and a prompt chunk of 8 queries (32 rows) at hd 128 (the
# wgmma route) and at hd 96 (the mma.sync route).
ATTN_SHAPES = (("prefill", 4, 2048, 2048, 32, 8, 128, None, None),
               ("decode", 4, 1, 544, 32, 8, 128, 543, 544),
               ("decode_mid", 4, 1, 544, 32, 8, 128, 299, 300),
               ("long", 1, 512, 32768, 32, 8, 128, 32256, None),
               ("chunk", 4, 8, 544, 32, 8, 128, 292, 300),
               ("chunk_hd96", 4, 8, 544, 32, 8, 96, 292, 300))
# bf16 against the float32 plain version: p is rounded to bf16 before the
# PV product and the output to bf16, about 2**-8 of a value each, so a
# row of 128 has 3e-3 to 5e-3 of relative L2 error; one 64-key tile
# dropped at the long row (32768 keys) moves a row by about
# sqrt(64 / 32768) = 4.4e-2
# the route each shape must take (kernels/flash_attention/ops.py)
ATTN_ROUTE = {"prefill": "wgmma", "decode": "splitk",
              "decode_mid": "splitk", "long": "wgmma", "chunk": "wgmma",
              "chunk_hd96": "mma"}
ATTN_GRAPH_LAUNCHES = 50              # launches in a device_ms graph
ATTN_BF16_TOL = 1e-2                  # atol = rtol, elementwise
ATTN_BF16_ROW_REL_L2 = 1e-2
ATTN_F32_TOL = (3e-5, 1e-4)           # atol, rtol


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
    of the inputs of the heaviest call (by ``work``), and with
    ``keep_all`` of every call in order (``calls``)."""

    def __init__(self, module, fn_name: str, work, keep_all: bool = False):
        self.module, self.fn_name, self.work = module, fn_name, work
        self.fn = getattr(module, fn_name)
        self.best, self.best_work = None, -1
        self.keep_all, self.calls = keep_all, []

    def __call__(self, *args):
        import torch
        saved = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                      for a in args)
        out = self.fn(*args)
        w = self.work(saved, out)
        if w > self.best_work:
            self.best, self.best_work = saved, w
        if self.keep_all:
            self.calls.append(saved)
        return out

    def __enter__(self):
        setattr(self.module, self.fn_name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.fn_name, self.fn)


class CallRecorder:
    """Wraps one function of a module while active (positional and keyword
    arguments); keeps the arguments of the heaviest call (by ``work``) by
    reference: the engine writes no tensor after it is made."""

    def __init__(self, module, fn_name: str, work):
        self.module, self.fn_name, self.work = module, fn_name, work
        self.fn = getattr(module, fn_name)
        self.best, self.best_work = None, -1

    def __call__(self, *args, **kw):
        w = self.work(args, kw)
        if w > self.best_work:
            self.best, self.best_work = {"args": args, "kw": dict(kw)}, w
        return self.fn(*args, **kw)

    def __enter__(self):
        setattr(self.module, self.fn_name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.fn_name, self.fn)


def level_recorder(by_cap: bool = False):
    """The fused expand level (``enumerate.expand_level_cuda``), by valid
    frontier rows (or its cap) x prefix length x candidates; ``rows`` is
    the cap."""
    from repro_torch.core import enumerate as enum
    rec = CallRecorder(enum, "expand_level_cuda", lambda a, kw: (
        a[0].shape[0] if by_cap else min(int(a[1]), a[0].shape[0]))
        * (kw["level"] + 1) * a[2].shape[1])
    rec.rows = lambda: rec.best["args"][0].shape[0]
    return rec


class JoinKernelRecorder:
    """The three fused joins of ``core/join.py`` while active, each by
    pair ids x the two half lengths; ``parts[kind].best`` is the heaviest
    call of each kind, ``best`` the heaviest of all (with its kind)."""

    KINDS = {"keyed": ("keyed_join_cuda", "out_cap", "a_col", "b_col"),
             "keyed_count": ("keyed_join_count_cuda", "pair_cap", "a_col",
                             "b_col"),
             "splice": ("cross_join_cuda", "out_cap", "p_col", "c_col")}

    def __init__(self, by_cap: bool = False):
        from repro_torch.core import join
        self.by_cap = by_cap
        self.parts = {
            kind: CallRecorder(join, fn, lambda a, kw, c=cap, x=x, y=y:
                               self.pairs(a, kw, c) * (kw[x] + 1)
                               * (kw[y] + 1))
            for kind, (fn, cap, x, y) in self.KINDS.items()}

    def pairs(self, args, kw, cap_key) -> int:
        """Pair ids a join visits: all of its cap for a keyed join (its
        pair count is known only inside), prefixes x children for a splice
        join (or its cap, ``by_cap``)."""
        if cap_key == "out_cap" and "p_col" in kw and not self.by_cap:
            return min(int(args[1]) * int(args[3]), kw[cap_key])
        return kw[cap_key]

    @property
    def best(self):
        kind = max(self.parts, key=lambda k: self.parts[k].best_work)
        if self.parts[kind].best is None:
            return None
        return dict(self.parts[kind].best, kind=kind)

    def rows(self) -> int:
        b = self.best
        return b["kw"][self.KINDS[b["kind"]][1]]

    def __enter__(self):
        for r in self.parts.values():
            r.__enter__()
        return self

    def __exit__(self, *exc):
        for r in self.parts.values():
            r.__exit__(*exc)


def join_halves(rec: dict):
    """The half rows a recorded join compares, pair by pair: (A[:a_col +
    1], B[:b_col + 1]) of a keyed join, (prefix, child) of a splice join."""
    from repro_torch.core import join
    kw = rec["kw"]
    if rec["kind"] == "splice":
        p_verts, p_count, c_verts, c_count = rec["args"]
        p_idx, c_idx, _, _ = join._splice_pairs(
            p_count, c_count, kw["out_cap"], p_verts.device)
        return (p_verts[p_idx][:, :kw["p_col"] + 1],
                c_verts[c_idx][:, :kw["c_col"] + 1])
    a, b_verts, b_count = rec["args"]
    cap = kw["out_cap"] if rec["kind"] == "keyed" else kw["pair_cap"]
    a_pos, b_idx, _, _ = join._enumerate_pairs(a, b_verts, b_count,
                                               kw["b_col"], cap)
    return (a.verts[a_pos][:, :kw["a_col"] + 1],
            b_verts[b_idx][:, :kw["b_col"] + 1])


def require_similarity(launches: dict, what: str) -> None:
    """The similarity stage ran on its two kernels, once per direction."""
    require(launches["gamma_pack"] == launches["pairwise_popcount"]
            == SIMILARITY_LAUNCHES,
            f"{what}: {launches['gamma_pack']} gamma_pack and "
            f"{launches['pairwise_popcount']} pairwise_popcount launches, "
            f"{SIMILARITY_LAUNCHES} of each expected")


def require_fused(launches: dict, what: str) -> None:
    """Every launch of path_member and rowwise_overlap on an engine path
    was a fused pass, and the counts agree."""
    for fused, kernel in FUSED.items():
        require(launches[fused] == launches[kernel],
                f"{what}: {launches[kernel]} {kernel} launches, "
                f"{launches[fused]} of them {fused}")


class JoinRecorder:
    """Wraps one of the engine module's joins while active; keeps a copy
    of the valid rows of both sides of the heaviest call that did not
    overflow (by the number of row pairs it considered, at most
    ``max_pairs``) with its column arguments and output count."""

    def __init__(self, name: str, sides, max_pairs: int = 1 << 62):
        from repro_torch.core import engine
        self.module, self.name, self.sides = engine, name, sides
        self.fn = getattr(engine, name)
        self.max_pairs = max_pairs
        self.best, self.best_work = None, -1

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        a, b = self.sides(args)
        work = a.shape[0] * b.shape[0]
        if (not bool(out.overflow) and work <= self.max_pairs
                and work > self.best_work):
            self.best_work = work
            self.best = {"a": a.clone(), "b": b.clone(), "args": args,
                         "kw": dict(kw), "count": int(out.count)}
        return out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def join_recorders() -> dict:
    """The splice join (``cross_join``: prefix rows x cached child rows)
    and the keyed join (``keyed_join``: sorted forward rows x backward
    rows, NA*NB <= 2**26) of the engine."""
    return {
        "splice": JoinRecorder(
            "cross_join", lambda a: (a[0][:int(a[1])], a[2][:int(a[3])])),
        "keyed": JoinRecorder(
            "keyed_join", lambda a: (a[0].verts[:int(a[0].count)],
                                     a[1][:int(a[2])]),
            max_pairs=1 << 26),
    }


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
    makers = {
        # every level: phase kernels times a whole index build's levels
        "msbfs_step": lambda: Recorder(
            mops, "msbfs_step_cuda",
            lambda a, out: popcount_total(torch, out), keep_all=True),
        "pairwise_popcount": lambda: Recorder(
            pops, "pairwise_popcount_cuda",
            lambda a, out: a[0].shape[0] ** 2 * a[0].shape[1]),
        "gamma_pack": lambda: Recorder(
            pops, "gamma_pack_cuda",
            lambda a, out: a[0].shape[0] * a[0].shape[1] * a[1].shape[0]),
        # the engine runs these two inside its fused level and joins
        "path_member": level_recorder,
        "rowwise_overlap": JoinKernelRecorder,
        # the fused passes at the largest capacities the planner gives them
        "level_cap": lambda: level_recorder(by_cap=True),
        "join_cap": lambda: JoinKernelRecorder(by_cap=True),
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
    require_similarity(launches, "main")
    require_fused(launches, "main")

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
    require_fused(basic_launches, "main, BASIC")
    check_same(queries, cold, basic)

    recorders = make_recorders(torch, FIRST_SLICE)
    with recording(recorders), stage_log() as klog:
        rec = session.run(queries, planner="batch")
    require([r.count for r in rec] == counts, "recorded run differs")
    plain_stages_check = check_plain_stages(torch, session, queries, klog,
                                            rec, "main")
    from repro_torch.core.index import build_index
    index = build_index(dg, queries)      # for phase kernels' profile

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
          "basic_launches": basic_launches,
          "plain_stages": plain_stages_check})
    return session, recorders, launches, cold, index, warm


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
    require_similarity(launches, "sharing")
    require_fused(launches, "sharing")
    require(rep.stats["n_shared"] > 0, "the sharing batch shared nothing")
    counts = [r.count for r in rep]
    n_oracle, t_oracle = check_results(g, queries, rep, (7, 8))
    t0 = time.perf_counter()
    basic = session.run(queries, planner="basic")
    t_basic = time.perf_counter() - t0
    check_same(queries, rep, basic)

    joins = ("path_member", "rowwise_overlap")
    recorders = make_recorders(torch, joins)
    join_rec = join_recorders()
    with recording(recorders), recording(join_rec), stage_log() as klog:
        rec = session.run(queries, planner="batch")
    require([r.count for r in rec] == counts, "recorded run differs")
    plain_stages_check = check_plain_stages(torch, session, queries, klog,
                                            rec, "sharing")
    require(all(r.best is not None for r in join_rec.values()),
            "the sharing batch ran no splice or no keyed join")
    rows = {k: recorders[k].rows() for k in joins}
    require(all(n > session.engine.cfg.min_cap for n in rows.values()),
            f"the sharing batch never outgrew min_cap: {rows}")
    profile = profile_batch(torch, session, queries, recorders)
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
          "heaviest_joins": {k: {"rows": [r.best["a"].shape[0],
                                          r.best["b"].shape[0]],
                                 "count": r.best["count"]}
                             for k, r in join_rec.items()},
          "oracle_checked": n_oracle, "t_oracle_s": t_oracle,
          "basic_equal": True, "t_basic_s": t_basic, "profile": profile,
          "plain_stages": plain_stages_check})
    return recorders, join_rec, launches, queries, rep


def device_kind(name: str) -> str:
    """A device event of the profiler: a copy to the host, a memset, or a
    kernel."""
    low = name.lower()
    return ("dtoh" if "memcpy" in low and "dtoh" in low else
            "copy" if "memcpy" in low else
            "memset" if "memset" in low else "kernel")


# windows traced again when the profiler hands back no device event at all
# (on the H100 a short window, run after other windows, sometimes came
# back empty although its kernels ran; an empty trace is no trace)
TRACE_TRIES = 3


def trace_device(torch, fn, setup=None) -> tuple[list, float]:
    """``fn()`` under ``torch.profiler`` tracing the card only: each device
    event as (name, stream, start ns, end ns), and the host wall
    (synchronized at both ends), in seconds. A window with no device
    event is run again, at most ``TRACE_TRIES`` times in all;
    ``setup()``, where given, runs before each try, outside the window. The launch counts are set to 0
    after it, so on return they are those of the window whose events
    come back."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import reset_launches
    for _ in range(TRACE_TRIES):
        if setup is not None:
            setup()
        reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [(e.name(), e.device_resource_id(), e.start_ns(),
                   e.end_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
        if events:
            break
    return events, wall


def device_ns(events) -> int:
    """The summed time of a window's device events, in nanoseconds."""
    return sum(t1 - t0 for *_, t0, t1 in events)


# a kernel that only waits (``torch.cuda._sleep``), launched first in a
# short profiler window: on the H100 the profiler drops such a window's
# first device event (without the marker a level's window showed its
# kernel and copy but not its memset; with it, all three and no marker)
MARKER = "spin_kernel"


def launches_of(events, fused: str) -> dict:
    """Count a window's device events: the fused kernel, memsets, copies
    to the host, and every other kernel by name (the marker apart)."""
    out = {"fused": 0, "memset": 0, "dtoh": 0, "copy": 0, "other": {},
           "marker": 0}
    for name, *_ in events:
        kind = device_kind(name)
        if kind == "kernel" and MARKER in name:
            out["marker"] += 1
        elif kind == "kernel" and fused in name:
            out["fused"] += 1
        elif kind == "kernel":
            short = name.split("(")[0][-80:]
            out["other"][short] = out["other"].get(short, 0) + 1
        else:
            out[kind] += 1
    return out


def profile_batch(torch, session, queries, recorders=None) -> dict:
    """A card-only profiler window over one warm BATCH run of the sharing
    batch (device busy share, launches per level and per join), and, with
    ``recorders``, over one expand level and one keyed and one splice join
    of that batch's heaviest recorded calls, each with its host readback of
    count and overflow: at most FUSED_LAUNCH_BUDGET launches (memsets
    included, the keyed join's named pair-setup ops apart) and one copy to
    the host."""
    from repro_torch.core import enumerate as enum
    from repro_torch.core import join
    from repro_torch.core.pathset import read_status
    from repro_torch.kernels import LAUNCHES

    events, wall = trace_device(
        torch, lambda: session.run(queries, planner="batch"))
    levels, joins = LAUNCHES["level_fused"], LAUNCHES["join_fused"]
    require_fused(LAUNCHES, "sharing, profiled")
    kinds = {}
    for name, *_ in events:
        kinds[device_kind(name)] = kinds.get(device_kind(name), 0) + 1
    busy_ms = device_ns(events) / 1e6
    out = {"batch": {"wall_s": wall, "device_ms": busy_ms,
                     "device_busy_share": busy_ms / (wall * 1e3),
                     "events": kinds, "levels": levels, "joins": joins,
                     "events_per_level_or_join":
                         sum(kinds.values()) / max(levels + joins, 1),
                     "dtoh_per_level_or_join":
                         kinds.get("dtoh", 0) / max(levels + joins, 1)}}
    if recorders is None:
        return out

    lvl = recorders["path_member"].best

    def one_level():
        got = enum.expand_level(*lvl["args"], **lvl["kw"])
        read_status(got.frontier.count, got.frontier.overflow)

    def one_join(kind):
        rec = recorders["rowwise_overlap"].parts[kind].best
        fn = join.keyed_join if kind == "keyed" else join.cross_join

        def run():
            got = fn(*rec["args"], **rec["kw"])
            read_status(got.count, got.overflow)
        return run

    for what, fn, fused in (("level", one_level, "expand_level_kernel"),
                            ("keyed_join", one_join("keyed"), "join_kernel"),
                            ("splice_join", one_join("splice"),
                             "join_kernel")):
        fn()                                      # warm
        events, _ = trace_device(
            torch, lambda: (torch.cuda._sleep(10000), fn()))
        n = launches_of(events, fused)
        out[what] = n
        require(n["fused"] == 1 and n["fused"] + n["memset"]
                <= FUSED_LAUNCH_BUDGET and n["dtoh"] == 1,
                f"{what}: {n} (at most {FUSED_LAUNCH_BUDGET} launches, one "
                f"of them the fused kernel, and one copy to the host)")
        if what != "keyed_join":
            require(not n["other"], f"{what}: other kernels launched: {n}")
    return out


SIMILARITY_CALLS = 5          # calls in the similarity profile's window


def profile_similarity(torch, index) -> dict:
    """A card-only profiler window over ``SIMILARITY_CALLS`` calls of
    ``similarity_matrix`` on the main batch's index (built outside the
    window), after the marker kernel: device time per call by kernel name
    against the host wall per call, which ends in the copy of both (Q, Q)
    matrices to the host."""
    from repro_torch.core.similarity import similarity_matrix
    from repro_torch.kernels import LAUNCHES
    mu = similarity_matrix(index)                    # warm
    t0 = time.perf_counter()
    for _ in range(SIMILARITY_CALLS):
        similarity_matrix(index)
    torch.cuda.synchronize()
    wall_unprofiled = (time.perf_counter() - t0) / SIMILARITY_CALLS

    def calls():
        torch.cuda._sleep(10000)
        torch.cuda.synchronize()
        for _ in range(SIMILARITY_CALLS):
            similarity_matrix(index)
    events, wall = trace_device(torch, calls)
    require(LAUNCHES["gamma_pack"] == LAUNCHES["pairwise_popcount"]
            == SIMILARITY_LAUNCHES * SIMILARITY_CALLS,
            f"similarity_matrix, profiled: {LAUNCHES}")
    by_name = {}
    for name, _, t0, t1 in events:
        if MARKER in name:
            continue
        short = name.split("(")[0][-80:]
        by_name[short] = by_name.get(short, 0.0) \
            + (t1 - t0) / 1e3 / SIMILARITY_CALLS
    kernels = {k: v for k, v in by_name.items() if device_kind(k) == "kernel"}
    require("gamma_pack_kernel" in kernels
            and "pairwise_popcount_kernel" in kernels,
            f"the similarity profile misses a kernel: {sorted(by_name)}")
    device_us = sum(by_name.values())
    return {"calls": SIMILARITY_CALLS,
            "wall_ms": wall_unprofiled * 1e3,
            "profiled_wall_ms": wall * 1e3 / SIMILARITY_CALLS,
            "device_ms": device_us / 1e3,
            "device_busy_share": device_us / 1e3
            / (wall * 1e3 / SIMILARITY_CALLS),
            "device_us_by_name": dict(sorted(by_name.items(),
                                             key=lambda kv: -kv[1])),
            "Q": len(index.queries), "Su": index.dist_s.shape[1],
            "Tu": index.dist_t.shape[1], "mu_mean": float(mu.mean())}


class OutputLog:
    """Wraps functions of a module while active and keeps every result."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.fns = {n: getattr(module, n) for n in names}
        self.out = {n: [] for n in names}

    def __enter__(self):
        for n, fn in self.fns.items():
            def logged(*args, _fn=fn, _n=n, **kw):
                res = _fn(*args, **kw)
                self.out[_n].append(res)
                return res
            setattr(self.module, n, logged)
        return self

    def __exit__(self, *exc):
        for n, fn in self.fns.items():
            setattr(self.module, n, fn)


# what the engine computes from the index and similarity stages' kernels
STAGE_OUTPUTS = ("build_index", "similarity_matrix", "cluster_queries",
                 "detect_common_queries")


def stage_log():
    from repro_torch.core import engine
    return OutputLog(engine, STAGE_OUTPUTS)


@contextlib.contextmanager
def plain_stages():
    """The index and similarity stages on the plain versions of their
    kernels (``msbfs_step_ref``; ``gamma_pack_ref`` + ``intersections``),
    on the card's tensors."""
    from repro_torch.core import msbfs, similarity
    from repro_torch.kernels.msbfs_expand import ops as mops
    from repro_torch.kernels.pairwise_popcount import ops as pops
    saved = (msbfs.msbfs_step, similarity.gamma_intersections)
    msbfs.msbfs_step = mops.msbfs_step_ref
    similarity.gamma_intersections = (
        lambda dist, col, ks, n: pops.intersections(
            pops.gamma_pack_ref(dist, col, ks, n)))
    try:
        yield
    finally:
        msbfs.msbfs_step, similarity.gamma_intersections = saved


def check_plain_stages(torch, session, queries, klog, report,
                       what: str) -> dict:
    """Run the batch once more with the index and similarity stages on
    their plain versions; the distances, μ, the clusters, the Ψ plans and
    every path set must equal the kernels' run (``klog``, ``report``)."""
    import numpy as np
    from repro_torch.kernels import LAUNCHES, reset_launches
    reset_launches()
    t0 = time.perf_counter()
    with plain_stages(), stage_log() as plog:
        plain = session.run(queries, planner="batch")
    t_plain = time.perf_counter() - t0
    require(LAUNCHES["msbfs_step"] == LAUNCHES["gamma_pack"]
            == LAUNCHES["pairwise_popcount"] == 0,
            f"{what}: the plain stages launched a kernel: {LAUNCHES}")
    k, p = klog.out, plog.out
    require(all(len(k[n]) == len(p[n]) > 0 for n in STAGE_OUTPUTS),
            f"{what}: the stages ran "
            f"{ {n: (len(k[n]), len(p[n])) for n in STAGE_OUTPUTS} } times")
    for a, b in zip(k["build_index"], p["build_index"]):
        require(torch.equal(a.dist_s, b.dist_s)
                and torch.equal(a.dist_t, b.dist_t),
                f"{what}: the index distances differ from the plain path")
    require(all(np.array_equal(a, b) for a, b in
                zip(k["similarity_matrix"], p["similarity_matrix"])),
            f"{what}: μ differs from the plain path")
    require(k["cluster_queries"] == p["cluster_queries"],
            f"{what}: the clusters differ from the plain path")
    require(k["detect_common_queries"] == p["detect_common_queries"],
            f"{what}: the Ψ plans differ from the plain path")
    check_same(queries, report, plain, f"{what}: kernels and plain stages")
    return {"equal": True, "t_plain_run_s": t_plain,
            "clusters": len(k["cluster_queries"][0]),
            "plans": len(k["detect_common_queries"])}


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


# ----------------------------------------------------------------------
# phase obs: the profiler bridge, compile telemetry and the launch audit
# ----------------------------------------------------------------------

# where phase obs writes its Chrome trace (git ignores build/)
OBS_DIR = os.path.join(ROOT, "build", "obs")
# the engine's stage spans whose host wall and device time are printed
OBS_STAGES = ("engine.run", "index.build", "cluster.queries",
              "detect.cluster", "enumerate.cluster", "enumerate.node",
              "msbfs.level", "join.splice", "join.keyed", "cache.get",
              "cache.put", "assemble.query", "transfer.paths",
              "route.estimate", "route.green", "executor.place",
              "replica.run")
# the host functions of t_detect printed, by self time and by total time
OBS_TOP = 12
# the compile window: a fresh process (nothing loaded yet) on a graph of
# OBS_WINDOW_N vertices, OBS_WINDOW_QUERIES overlapping queries, two warm
# runs and OBS_DELTAS in-bucket deltas of OBS_DELTA_EDGES deletions and as
# many insertions each; the same process then runs the launch audit (its
# short profiler windows come back incomplete more often in a process that
# has run long ones, as this phase's)
OBS_WINDOW_N = 1 << 16
OBS_WINDOW_QUERIES = 16
OBS_DELTAS = 3
OBS_DELTA_EDGES = 4
OBS_WINDOW_TIMEOUT_S = 300


# the Chrome trace's categories of device events and of the host's CUDA
# runtime and driver calls
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_API_CATS = ("cuda_runtime", "cuda_driver")


def stage_device_times(doc: dict, names) -> dict:
    """Device time of the kernels launched inside each stage span, from
    the Chrome trace of one profiler window with CPU and CUDA activity
    whose spans were annotated (``record_function``).

    A device event is charged to the CUDA runtime call that launched it
    (the host event with its correlation id: ``ctypes`` launches included,
    which no PyTorch op encloses), and that call's thread and start time
    place it in the annotations open on that thread: ``device_ms`` counts
    it in every stage span around the launch (each name once),
    ``self_device_ms`` only in the innermost. A replica thread's kernels
    thus land under that replica's spans. A device event whose call is
    not in the window falls back to the device timeline's annotation
    ranges (``placed_on_device``)."""
    names = set(names)
    calls, ann, dev_ann, dev = {}, {}, [], []
    for e in doc["traceEvents"]:
        cat = e.get("cat")
        if cat in _DEVICE_CATS:
            dev.append(e)
        elif cat in _API_CATS:
            calls[e["args"].get("correlation")] = (e["tid"], e["ts"])
        elif e.get("name") in names:
            span = (e["ts"], e["ts"] + e["dur"], e["name"])
            if cat == "user_annotation":
                ann.setdefault(e["tid"], []).append(span)
            elif cat == "gpu_user_annotation":
                dev_ann.append(span)
    per = {}
    total = unplaced = on_device = 0.0
    for e in dev:
        dur = e["dur"]
        total += dur
        where = calls.get(e["args"].get("correlation"))
        if where is not None:
            inside = [a for a in ann.get(where[0], ())
                      if a[0] <= where[1] <= a[1]]
        else:
            inside = [a for a in dev_ann
                      if a[0] <= e["ts"] and e["ts"] + dur <= a[1]]
            on_device += dur if inside else 0.0
        if not inside:
            unplaced += dur
            continue
        for name in {a[2] for a in inside}:
            row = per.setdefault(name, {"device_us": 0.0, "self_us": 0.0,
                                        "events": 0})
            row["device_us"] += dur
            row["events"] += 1
        per[max(inside)[2]]["self_us"] += dur
    return {"per": per, "device_us": total, "unplaced_us": unplaced,
            "placed_on_device_us": on_device, "device_events": len(dev),
            "api_calls": len(calls)}


_ADDRESS = re.compile(r" at 0x[0-9a-f]+")


def host_functions(doc: dict, window: str, top: int) -> dict:
    """The Python functions of a ``with_stack`` profile's Chrome trace
    inside the ``window`` annotations: self time (own time, callees
    excluded) and total time per function, the ``top`` of each, in ms."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in doc["traceEvents"]
                   if e.get("cat") == "user_annotation"
                   and e.get("name") == window)
    py = [e for e in doc["traceEvents"]
          if e.get("cat") == "python_function"]
    child_us = {}
    for e in py:
        pid = e["args"].get("Python parent id")
        child_us[pid] = child_us.get(pid, 0.0) + e["dur"]
    starts = [lo for lo, _ in spans]

    def inside(e) -> bool:
        i = bisect.bisect_right(starts, e["ts"])
        return i > 0 and e["ts"] <= spans[i - 1][1]

    self_us, total_us, calls = {}, {}, {}
    for e in py:
        if not inside(e):
            continue
        name = _ADDRESS.sub("", e["name"])     # one row per bound method
        self_us[name] = self_us.get(name, 0.0) + e["dur"] \
            - child_us.get(e["args"].get("Python id"), 0.0)
        total_us[name] = total_us.get(name, 0.0) + e["dur"]
        calls[name] = calls.get(name, 0) + 1
    window_us = sum(hi - lo for lo, hi in spans)

    def best(d):
        return [{"function": k, "ms": v / 1e3,
                 "share": v / max(window_us, 1e-9), "calls": calls[k]}
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"windows": len(spans), "window_ms": window_us / 1e3,
            "python_events": len(py), "by_self": best(self_us),
            "by_total": best(total_us)}


def telemetry(stats: dict) -> dict:
    return {k: stats[k] for k in ("n_compiles", "n_retraces",
                                  "compiled_kernels")}


def window_delta(g, dg, rng):
    """OBS_DELTA_EDGES deletions of edges and as many absent insertions
    between vertices with room in their ELL rows: an in-bucket delta."""
    import numpy as np
    from repro_torch.core import GraphDelta
    keys = edge_keys(g)
    room = np.flatnonzero((g.out_degree() < dg.ell_cap - OBS_DELTA_EDGES)
                          & (g.in_degree() < dg.r_ell_cap - OBS_DELTA_EDGES))
    gone = rng.choice(keys.size, size=OBS_DELTA_EDGES, replace=False)
    remove = list(zip((keys[gone] // g.n).tolist(),
                      (keys[gone] % g.n).tolist()))
    return GraphDelta.from_pairs(
        add=absent_pairs(g, room, OBS_DELTA_EDGES, rng, keys), remove=remove)


def obs_child(trace: str) -> dict:
    """What phase obs runs in a fresh process (``--obs-child TRACE``),
    beside the main batch's profile in its parent: the device time per
    stage of the sharing run's Chrome trace ``trace``, the compile window,
    then the launch audit of the CUDA arm against the committed
    budgets."""
    from repro_torch.analysis import launch_audit
    t0 = time.perf_counter()
    with open(trace) as f:
        out = {"stages": stage_device_times(json.load(f), OBS_STAGES)}
    out["stages"]["seconds"] = time.perf_counter() - t0
    out["compile_window"] = compile_window()
    t0 = time.perf_counter()
    audit = launch_audit.run_audit(arm="cuda")
    out["audit"] = {"ok": audit.ok, "seconds": time.perf_counter() - t0,
                    "violations": [f.render() for f in audit.violations],
                    "measured": audit.meta["measured"],
                    "launched": audit.meta.get("launched")}
    return out


def compile_window() -> dict:
    """The counterpart of ``tests/test_recompile.py`` in a fresh process
    (``--obs-child``): the cold run must compile exactly the kernel
    libraries it loaded, two warm runs and OBS_DELTAS in-bucket deltas
    (``delta_backend="msbfs"``, each followed by a run) none."""
    import numpy as np
    from repro_torch.core import EngineConfig, PathSession, generators
    from repro_torch.kernels import build
    before = set(build.ready())
    g = generators.community(n=OBS_WINDOW_N,
                             n_comm=max(OBS_WINDOW_N // 2500, 1),
                             avg_deg=8.0, p_intra=0.9, seed=0)
    queries = generators.similar_queries(g, OBS_WINDOW_QUERIES,
                                         similarity=0.8, k_range=(4, 5),
                                         seed=3)
    session = PathSession(g, EngineConfig(log_compiles=True,
                                          cache_bytes=64 << 20,
                                          delta_backend="msbfs"),
                          device="cuda")
    cold = session.run(queries, planner="batch")
    loaded = sorted(set(build.ready()) - before)
    out = {"loaded_before": sorted(before), "loaded": loaded,
           "cold": telemetry(cold.stats), "warm": [], "deltas": []}
    for _ in range(2):
        out["warm"].append(telemetry(session.run(queries,
                                                 planner="batch").stats))
    rng = np.random.default_rng(4)
    for _ in range(OBS_DELTAS):
        eng = session.engine
        rep = session.apply_delta(window_delta(eng.g, eng.dg, rng))
        after = session.run(queries, planner="batch")
        out["deltas"].append({
            "apply": telemetry(rep), "device_update": rep["device_update"],
            "cache_mode": rep["cache_mode"], "run": telemetry(after.stats)})
    return out


def check_compile_window(w: dict) -> list:
    """What the compile window must show (failures as strings)."""
    bad = []
    cold = w["cold"]
    if w["loaded_before"]:
        bad.append(f"the window's process had libraries before its "
                   f"first run: {w['loaded_before']}")
    if cold["n_compiles"] != len(w["loaded"]) or \
            sorted(cold["compiled_kernels"]) != w["loaded"] or \
            cold["n_retraces"]:
        bad.append(f"cold window: {cold} against the libraries loaded "
                   f"{w['loaded']}")
    if not w["loaded"]:
        bad.append("the cold run loaded no kernel library")
    warm = w["warm"] + [d[k] for d in w["deltas"] for k in ("apply", "run")]
    if any(t["n_compiles"] or t["n_retraces"] for t in warm):
        bad.append(f"a warm window compiled: {warm}")
    if any(d["device_update"] != "incremental" for d in w["deltas"]):
        bad.append(f"a delta left its bucket: {w['deltas']}")
    return bad


def host_profile(main_session, main_queries, tracer) -> tuple:
    """One warm main-batch run with the host's Python stacks on
    (``with_stack=True``; its ``detect.cluster`` spans annotated): the
    host functions inside ``detect.cluster`` and the run's report."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace as obstrace
    obstrace.enable(annotate=True)          # the main session's tracer
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     with_stack=True) as prof:
            main = main_session.run(main_queries, planner="batch")
    finally:
        tracer.configure(enabled=False, fence=False, annotator=None)
        tracer.reset()
    t0 = time.perf_counter()
    path = os.path.join(OBS_DIR, "main_with_stack.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    detect = host_functions(doc, "detect.cluster", OBS_TOP)
    detect["trace_mb"] = os.path.getsize(path) / 2 ** 20
    detect["parse_s"] = time.perf_counter() - t0
    return detect, main


def phase_obs(torch, g, main_session, main_queries, share_queries,
              main_warm) -> dict:
    """Phase obs: device time per stage of a warm sharing BATCH run under
    ``torchprof.profile_run`` (spans annotated), the host functions of the
    main batch's ``t_detect`` under a ``with_stack`` profile, the compile
    log (cold, warm, in-bucket deltas; a fresh process) and the launch
    audit of the CUDA arm against the committed budgets. Every failed
    check is listed in the phase line, and then fails the run."""
    from repro_torch.core import EngineConfig, PathSession
    from repro_torch.kernels import build
    from repro_torch.obs import torchprof
    from repro_torch.obs import trace as obstrace

    failed = []

    def check(cond: bool, what: str) -> None:
        if not cond:
            failed.append(what)

    t_phase = time.perf_counter()
    out = {"phase": "obs"}
    walls = out["walls_s"] = {}
    # 1. device time per stage
    session = PathSession(g, EngineConfig(trace=True, trace_annotations=True,
                                          log_compiles=True),
                          device="cuda")
    tracer = obstrace.tracer()
    walls["session"] = time.perf_counter() - t_phase
    cold = session.run(share_queries, planner="batch")
    walls["sharing_cold"] = time.perf_counter() - t_phase
    check(cold.stats["n_retraces"] == 0,
          f"the sharing batch's cold run retraced: {telemetry(cold.stats)}")
    tracer.reset()
    with torchprof.profile_run(OBS_DIR, device="cuda") as prof:
        rep = session.run(share_queries, planner="batch")
    walls["sharing_profiled"] = time.perf_counter() - t_phase
    check([r.count for r in rep] == [r.count for r in cold],
          "the profiled sharing run differs from its cold run")
    check(rep.stats["n_compiles"] == 0 and rep.stats["n_retraces"] == 0,
          f"the warm sharing run compiled: {telemetry(rep.stats)}")
    host = {}
    for sp in tracer.spans():
        row = host.setdefault(sp.name, [0, 0.0])
        row[0] += 1
        row[1] += sp.duration
    del prof
    # the fresh process: it reads the sharing run's trace, then runs the
    # compile window and the launch audit, while this one profiles the
    # main batch's host (whose kernels are few: the card stays free)
    t_child = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--obs-child",
         os.path.join(OBS_DIR, f"torchprof_{os.getpid()}.trace.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        detect, main = host_profile(main_session, main_queries, tracer)
    finally:
        try:
            child_out, child_err = child.communicate(
                timeout=OBS_WINDOW_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            child.kill()
            child_out, child_err = child.communicate()
    walls["main_functions"] = time.perf_counter() - t_phase
    lines = child_out.strip().splitlines()
    check(child.returncode == 0 and lines,
          f"phase obs's fresh process failed ({child.returncode}): "
          f"{child_err[-2000:]}")
    got = json.loads(lines[-1]) if child.returncode == 0 and lines else {}
    walls["child"] = time.perf_counter() - t_phase
    dev = got.get("stages", {"per": {}, "device_us": 0.0,
                             "unplaced_us": 0.0, "placed_on_device_us": 0.0,
                             "device_events": 0, "api_calls": 0})
    stages = {}
    for name in OBS_STAGES:
        if name not in host:
            continue
        n, wall = host[name]
        d = dev["per"].get(name, {"device_us": 0.0, "self_us": 0.0,
                                   "events": 0})
        stages[name] = {"spans": n, "host_ms": wall * 1e3,
                        "device_ms": d["device_us"] / 1e3,
                        "self_device_ms": d["self_us"] / 1e3,
                        "device_events": d["events"],
                        "busy_share": d["device_us"] / 1e6 / max(wall, 1e-12)}
    wall = host["engine.run"][1]
    out["sharing"] = {
        "t_wall_s": rep.stats["t_wall_s"],
        "stats": {k: rep.stats[k] for k in STAT_KEYS},
        "device_ms": dev["device_us"] / 1e3,
        "busy_share": dev["device_us"] / 1e6 / wall,
        "unplaced_ms": dev["unplaced_us"] / 1e3,
        "placed_on_device_ms": dev["placed_on_device_us"] / 1e3,
        "device_events": dev["device_events"],
        "api_calls": dev["api_calls"], "read_s": dev.get("seconds"),
        "stages": stages, "trace_dir": os.path.relpath(OBS_DIR, ROOT)}
    check(set(OBS_STAGES[:5]) <= set(stages),
          f"stage spans missing from the trace: {sorted(stages)}")
    check(dev["device_events"] > 0, "no device event in the profile")
    check(dev["unplaced_us"] <= 0.05 * dev["device_us"],
          f"{dev['unplaced_us'] / 1e3:.3f} of "
          f"{dev['device_us'] / 1e3:.3f} device ms outside every stage")
    for name in ("index.build", "cluster.queries", "enumerate.cluster"):
        check(stages.get(name, {}).get("device_ms", 0) > 0,
              f"no device time under {name}")
    # 2. where t_detect goes (profiled above, beside the fresh process)
    out["t_detect"] = {"profiled_t_detect_s": main.stats["t_detect"],
                       "profiled_t_wall_s": main.stats["t_wall_s"],
                       "warm_t_detect_s": main_warm[-1]["t_detect"],
                       "warm_t_wall_s": main_warm[-1]["t_wall_s"],
                       **detect}
    check(detect["windows"] == main.stats["n_clusters"],
          f"{detect['windows']} detect.cluster windows for "
          f"{main.stats['n_clusters']} clusters")
    check(detect["python_events"] > 0 and detect["by_self"],
          "the with_stack profile holds no Python function inside "
          "detect.cluster")
    # 3. the compile log and 4. the launch audit (the fresh process)
    if got:
        for what in check_compile_window(got["compile_window"]):
            check(False, what)
        check(got["audit"]["ok"],
              f"launch audit: {got['audit']['violations']}")
        out.update(compile_window=got["compile_window"], audit=got["audit"],
                   child_seconds=time.perf_counter() - t_child)
    out["compile_log_here"] = {"libraries_ready": sorted(build.ready())}
    out["failed"] = failed
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    require(not failed, f"phase obs: {failed}")
    return out


def phase_planners(torch, g, main_session, main_queries, main_report,
                   queries, share_report):
    from repro_torch.core import EngineConfig, PathSession
    from repro_torch.kernels import LAUNCHES, reset_launches

    session = PathSession(g, EngineConfig(), device="cuda")
    runs, launches, reports = {}, {}, {}
    for planner in PLANNERS:
        with RetryCounter(session.engine) as rc:
            reset_launches()
            t0 = time.perf_counter()
            rep = session.run(queries, planner=planner)
            host_wall = time.perf_counter() - t0
            launches[planner] = dict(LAUNCHES)
        require(launches[planner]["ell_spmm"] > 0,
                f"{planner}: ell_spmm never launched on the default config")
        require_fused(launches[planner], planner)
        require(launches[planner]["ell_gather_f1"]
                == launches[planner]["ell_spmm"],
                f"{planner}: {launches[planner]['ell_spmm']} ell_spmm calls, "
                f"{launches[planner]['ell_gather_f1']} through "
                f"ell_gather_f1_kernel (the walk counts are F = 1)")
        check_same(queries, share_report, rep,
                   f"plan_caps=False BATCH and default-config {planner}")
        if planner in ("batch", "auto"):
            reports[planner] = rep          # phase sharded's reference
        runs[planner] = {
            "stats": {k: v for k, v in rep.stats.items()
                      if k.startswith(("t_", "n_", "routed_"))},
            "host_wall_s": host_wall, "launches": launches[planner],
            "routes": None if rep.routes is None else
            {r: rep.routes.count(r) for r in set(rep.routes)},
            "retry": rc.as_dict()}
    # BATCH once more, warm: the first run of a session against a later one
    rerun = session.run(queries, planner="batch")
    check_same(queries, share_report, rerun, "a second default-config BATCH")
    runs["batch_rerun"] = {"stats": {k: rerun.stats[k] for k in STAT_KEYS}}
    # the first slice's configuration on the same batch, for its retries
    with RetryCounter(main_session.engine) as rc_off:
        rep = main_session.run(queries, planner="batch")
    check_same(queries, share_report, rep, "two plan_caps=False BATCH runs")

    reset_launches()
    t0 = time.perf_counter()
    auto = session.run(main_queries, planner="auto")
    t_auto = time.perf_counter() - t0
    auto_launches = dict(LAUNCHES)
    require_fused(auto_launches, "auto, main batch")
    check_same(main_queries, main_report, auto,
               "plan_caps=False BATCH and default-config AUTO (main batch)")

    recorders = make_recorders(torch, ("ell_spmm", "level_cap", "join_cap"))
    with recording(recorders):
        rec = session.run(queries, planner="batch")
    check_same(queries, share_report, rec, "recorded batch run")
    profile = profile_batch(torch, session, queries)
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
          "paths_equal_sharing": True, "profile_batch": profile})
    return recorders, launches["batch"], reports


def phase_cache(g, queries, share_report):
    import numpy as np
    from repro_torch.core import EngineConfig, PathSession
    from repro_torch.kernels import LAUNCHES, reset_launches
    session = PathSession(g, EngineConfig(cache_bytes=256 << 20),
                          device="cuda")
    reset_launches()
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
    require_fused(LAUNCHES, "cache")
    for name, rep in (("cold", cold), ("warm", warm), ("after_update", after)):
        out[name] = {k: rep.stats[k] for k in keys}
    emit({"phase": "cache", **out, "t_update_graph_s": t_update,
          "cache_info": session.cache.info(), "rows_identical": True})


def edge_keys(g):
    """The sorted ``src * n + dst`` keys of a graph's edges (CSR order)."""
    import numpy as np
    return np.repeat(np.arange(g.n, dtype=np.int64),
                     np.diff(g.indptr)) * g.n + g.indices


def absent_pairs(g, verts, count: int, rng, keys):
    """``count`` distinct absent non-loop edges between vertices of
    ``verts`` (exp10's ``_absent_pairs``, with the membership test on the
    sorted key array instead of a Python set of 8 M edges)."""
    import numpy as np
    got = np.zeros(0, np.int64)
    while got.size < count:
        u = rng.choice(verts, size=4 * count)
        v = rng.choice(verts, size=4 * count)
        key = (u * g.n + v)[u != v]
        pos = np.minimum(np.searchsorted(keys, key), keys.size - 1)
        key = np.concatenate([got, key[keys[pos] != key]])
        _, first = np.unique(key, return_index=True)
        got = key[np.sort(first)]                  # draw order, no repeats
    got = got[:count]
    return list(zip((got // g.n).tolist(), (got % g.n).tolist()))


def churn_pool(torch, dg, queries):
    """Vertices beyond every query's hop radius (exp10's ``_churn_pool``):
    the batch's own index distances, ``dist(s, v) > k`` and
    ``dist(v, t) > k`` for every query, which give the set that exp10's
    per-query host BFS gives."""
    from repro_torch.core import build_index
    index = build_index(dg, queries)
    ks = torch.tensor([q[2] for q in queries], dtype=torch.int8,
                      device=index.dist_s.device)
    n = dg.n
    cols_s = torch.from_numpy(index.src_col.astype("int64")).to(ks.device)
    cols_t = torch.from_numpy(index.tgt_col.astype("int64")).to(ks.device)
    hot = (index.dist_s[:n][:, cols_s] <= ks).any(dim=1)
    hot |= (index.dist_t[:n][:, cols_t] <= ks).any(dim=1)
    return torch.nonzero(~hot).flatten().cpu().numpy()


def far_delta(g, pool, rng):
    """FAR_EDGES deletions of existing edges inside the pool and as many
    absent insertions between pool vertices (exp10's ``_make_delta``)."""
    import numpy as np
    from repro_torch.core import GraphDelta
    keys = edge_keys(g)
    cold = np.zeros(g.n, bool)
    cold[pool] = True
    cand = np.flatnonzero(cold[keys // g.n] & cold[keys % g.n])
    require(cand.size >= FAR_EDGES, f"the pool holds {cand.size} edges")
    pick = cand[rng.choice(cand.size, size=FAR_EDGES, replace=False)]
    dels = list(zip((keys[pick] // g.n).tolist(),
                    (keys[pick] % g.n).tolist()))
    return GraphDelta.from_pairs(
        add=absent_pairs(g, pool, FAR_EDGES, rng, keys), remove=dels)


def wide_delta(g, rng):
    """WIDE_RATE * m deletions of existing edges anywhere and as many
    absent insertions (exp10's rate)."""
    import numpy as np
    from repro_torch.core import GraphDelta
    keys = edge_keys(g)
    count = int(WIDE_RATE * g.m)
    pick = keys[rng.choice(keys.size, size=count, replace=False)]
    dels = list(zip((pick // g.n).tolist(), (pick % g.n).tolist()))
    return GraphDelta.from_pairs(
        add=absent_pairs(g, np.arange(g.n), count, rng, keys), remove=dels)


def cap_delta(g, dg, rng):
    """In-edges into a vertex of maximum in-degree until its in-degree
    passes the in-neighbour table's cap."""
    import numpy as np
    from repro_torch.core import GraphDelta
    v = int(np.argmax(g.in_degree()))
    need = dg.r_ell_cap - int(g.in_degree()[v]) + 1
    have = np.append(g.neighbors(v, reverse=True), v)
    cand = np.setdiff1d(rng.choice(g.n, size=4 * need, replace=False), have)
    return GraphDelta.from_pairs(add=[(int(u), v) for u in cand[:need]])


class DistsRecorder:
    """Keeps what an engine's ``_delta_dists`` priced while active."""

    def __init__(self, engine):
        self.engine, self.fn = engine, engine._delta_dists
        self.calls = []

    def __call__(self, applied, k_max):
        out = self.fn(applied, k_max)
        self.calls.append((applied, k_max, out))
        return out

    def __enter__(self):
        self.engine._delta_dists = self
        return self

    def __exit__(self, *exc):
        del self.engine._delta_dists          # back to the class's method


def phase_delta(torch, g, batches):
    """Phase 8 (see the module docstring). ``batches``: the candidate
    (name, queries) in order of preference. Returns the W = 1 sweep's
    recorder, the batch taken and the far and near deltas."""
    import numpy as np
    from repro_torch.core import (DeviceGraph, EngineConfig, GraphDelta,
                                  PathSession, host_set_dist, oracle)
    from repro_torch.core.graph import pow2_ceil
    from repro_torch.core.msbfs import K_MAX_INT8, msbfs_set_dist_ell
    from repro_torch.kernels import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    dg0 = DeviceGraph.build(g, "cuda")
    pools = {}
    for batch, queries in batches:
        pool = churn_pool(torch, dg0, queries)
        pools[batch] = int(pool.size)
        if pool.size >= FAR_POOL:
            break
    require(pool.size >= FAR_POOL, f"no batch leaves a churn pool: {pools}")
    del dg0
    t_pool = time.perf_counter() - t0
    emit({"phase": "delta_pool", "pool_sizes": pools, "batch": batch,
          "queries": len(queries), "t_pool_s": t_pool})

    backends = ("host", "msbfs")
    sessions = {b: PathSession(g, EngineConfig(cache_bytes=256 << 20,
                                               delta_backend=b),
                               device="cuda") for b in backends}
    cold, last = {}, None
    for b, sess in sessions.items():
        t0 = time.perf_counter()
        rep = sess.run(queries)
        cold[b] = dict({k: rep.stats[k] for k in
                        ("t_wall_s", "n_materialized", "n_cache_hits")},
                       host_wall_s=time.perf_counter() - t0)
        if last is not None:
            check_same(queries, last, rep, "the two cold delta sessions")
        last = rep
    require(len(sessions["host"].cache) > 0, "the cold run cached nothing")

    rng = np.random.default_rng(3)
    steps, w1_rec, near_path, applied_deltas = [], None, None, {}
    for step in ("far", "near", "wide", "cap"):
        g_old = sessions["host"].engine.g
        dg_old = sessions["host"].engine.dg
        if step == "far":
            delta = far_delta(g_old, pool, rng)
        elif step == "near":
            qi = max(range(len(queries)), key=lambda i: last[i].count)
            row = [int(x) for x in last[qi].paths[0] if x >= 0]
            near_path = (qi, tuple(row))
            delta = GraphDelta.from_pairs(remove=[(row[0], row[1])])
        elif step == "wide":
            delta = wide_delta(g_old, rng)
        else:
            delta = cap_delta(g_old, dg_old, rng)
        out = {"step": step, "n_add": delta.n_add, "n_del": delta.n_del}
        applied_deltas[step] = delta
        reports, reruns = {}, {}
        for b, sess in sessions.items():
            entries = len(sess.cache)
            with DistsRecorder(sess.engine) as drec:
                reset_launches()
                rep = sess.apply_delta(delta)
                launches = dict(LAUNCHES)
            t0 = time.perf_counter()
            after = sess.run(queries)
            t_rerun = time.perf_counter() - t0
            require_fused(LAUNCHES, f"delta {step}, {b} rerun")
            reports[b], reruns[b] = rep, after
            out[b] = {"report": rep, "entries_before": entries,
                      "msbfs_step_launches": launches["msbfs_step"],
                      "rerun": dict({k: after.stats[k] for k in
                                     ("t_wall_s", "n_materialized",
                                      "n_cache_hits")},
                                    host_wall_s=t_rerun)}
            swept = rep["cache_mode"] == "delta" and entries > 0
            if b == "msbfs":
                require((launches["msbfs_step"] > 0) == swept,
                        f"{step}: msbfs_step launches {launches} in "
                        f"apply_delta (cache mode {rep['cache_mode']})")
                for applied, k_max, dists in drec.calls:
                    for name, reverse in (("from", False), ("to", True)):
                        host = host_set_dist(g_old, applied, k_max, reverse)
                        dev = dists[name].astype(np.int32)
                        near = (host <= k_max) | (dev <= k_max)
                        require(np.array_equal(host[near], dev[near]),
                                f"{step}: msbfs {name} distances differ "
                                f"from host_set_dist")
                if step == "far" and drec.calls:
                    # the W = 1 sweep's heaviest level, for phase kernels
                    applied, k_max, _ = drec.calls[0]
                    seed = torch.zeros(g.n + 1, dtype=torch.int8,
                                       device="cuda")
                    seed[torch.from_numpy(applied.touched).cuda()] = 1
                    w1_rec = make_recorders(torch, ("msbfs_step",))
                    with recording(w1_rec):
                        msbfs_set_dist_ell(
                            dg_old.r_ell_idx, seed, n=g.n,
                            k_max=min(pow2_ceil(k_max), K_MAX_INT8))
            else:
                require(launches["msbfs_step"] == 0,
                        f"{step}: the host backend launched msbfs_step")
        same = [{k: v for k, v in r.items() if k != "t_apply_s"}
                for r in reports.values()]
        require(same[0] == same[1], f"{step}: the backends' reports "
                                    f"differ: {reports}")
        rep = reports["host"]
        eng = sessions["host"].engine
        require(rep["n_added"] + rep["n_removed"] > 0, f"{step}: no-op")
        if step == "far":
            require(rep["cache_mode"] == "delta"
                    and rep["device_update"] == "incremental"
                    and rep["cache_kept"] > 0, f"far: {rep}")
            for b in backends:
                require(reruns[b].stats["n_materialized"]
                        < cold[b]["n_materialized"],
                        f"far: the {b} rerun materialized as much as cold")
        elif step == "near":
            require(rep["cache_evicted"] > 0, f"near: evicted nothing {rep}")
            qi, row = near_path
            for b in backends:
                require(row not in oracle.path_set(reruns[b][qi].paths),
                        f"near: the {b} rerun still returns {row}")
        elif step == "wide":
            require(rep["cache_mode"] == "full"
                    and rep["device_update"] == "incremental",
                    f"wide: {rep}")
        else:
            require(rep["device_update"] == "rebuild"
                    and eng.dg.ell_cap >= dg_old.ell_cap
                    and eng.dg.r_ell_cap > dg_old.r_ell_cap,
                    f"cap: {rep}, caps {dg_old.ell_cap}/{dg_old.r_ell_cap}"
                    f" -> {eng.dg.ell_cap}/{eng.dg.r_ell_cap}")
        out["caps"] = [eng.dg.ell_cap, eng.dg.r_ell_cap]
        # a fresh session on the new graph, shared by both backends
        t0 = time.perf_counter()
        fresh = PathSession(eng.g, EngineConfig(), device="cuda")
        frep = fresh.run(queries)
        t_fresh = time.perf_counter() - t0
        for b in backends:
            check_same(queries, frep, reruns[b],
                       f"{step}: a fresh session and the {b} rerun")
        t0 = time.perf_counter()
        fresh.update_graph(eng.g)
        torch.cuda.synchronize()
        out["t_update_graph_s"] = time.perf_counter() - t0
        out["t_fresh_s"] = t_fresh
        del fresh
        picked = sorted({0, len(queries) - 1}
                        | ({near_path[0]} if step == "near" else set()))
        t0 = time.perf_counter()
        for i in picked:
            s, t, k = queries[i]
            expect = oracle.path_set(
                oracle.enumerate_paths_bruteforce(eng.g, s, t, k))
            require(oracle.path_set(reruns["host"][i].paths) == expect,
                    f"{step}: query {queries[i]} disagrees with the oracle")
        out["oracle_checked"] = len(picked)
        out["t_oracle_s"] = time.perf_counter() - t0
        emit({"phase": "delta_step", **out})
        steps.append(out)
        last = reruns["host"]
    emit({"phase": "delta", "batch": batch, "queries": len(queries),
          "pool_sizes": pools, "cold": cold,
          "t_apply_s": {st["step"]: {b: st[b]["report"]["t_apply_s"]
                                     for b in backends} for st in steps},
          "t_update_graph_s": {st["step"]: st["t_update_graph_s"]
                               for st in steps}})
    return w1_rec, queries, [applied_deltas[s] for s in ("far", "near")]


class ZipfSampler:
    """exp11's Zipf-skewed vertex sampler: rank r has mass 1/r^a over one
    seeded permutation of the vertices. The CDF is built once; a draw is
    one uniform and a ``searchsorted``, which is what ``rng.choice(n,
    p=p)`` does (the same draws) after rebuilding the CDF of all n."""

    def __init__(self, np, n: int, seed: int, a: float = STREAM_ZIPF_A):
        p = np.arange(1, n + 1, dtype=np.float64) ** -a
        self.cdf = np.cumsum(p / p.sum())
        self.cdf /= self.cdf[-1]
        self.perm = np.random.default_rng(seed).permutation(n)
        self.np = np

    def draw(self, rng) -> int:
        i = self.np.searchsorted(self.cdf, rng.random(), side="right")
        return int(self.perm[i])


def walk_end(g, s: int, k: int, rng) -> int:
    """The end of a random walk of 1..k hops from ``s`` along out-edges
    (it stops early at a vertex with none): a path of at most k hops
    reaches it, unless it is ``s``."""
    v = s
    for _ in range(int(rng.integers(1, k + 1))):
        lo, hi = int(g.indptr[v]), int(g.indptr[v + 1])
        if hi == lo:
            break
        v = int(g.indices[lo + int(rng.integers(hi - lo))])
    return v


def stream_events(np, g, edge_src, zipf, seed: int, kind: str, rate: float,
                  n_arrivals: int, quantum_s: float, delta_every: int):
    """exp11's trace: (time, query) and (time, delta) events in time
    order; a balanced delta of 4 random edges in and 4 original edges
    out every ``delta_every`` arrivals. ``STREAM_REACH`` of the targets
    are a random walk's end (:func:`walk_end`), the rest Zipf draws."""
    from repro_torch.core import GraphDelta, PathQuery
    rng = np.random.default_rng(seed)
    if kind == "poisson":
        gaps = rng.exponential(1.0 / rate, size=n_arrivals)
    else:          # 2-state MMPP: 0.4x and 2.8x the rate, dwell ~12
        rates, state = (0.4 * rate, 2.8 * rate), 0
        gaps = np.empty(n_arrivals)
        for i in range(n_arrivals):
            gaps[i] = rng.exponential(1.0 / rates[state])
            if rng.random() < 1.0 / 12.0:
                state = 1 - state
    times = np.cumsum(gaps)
    events = []
    for t in times:
        s = zipf.draw(rng)
        k = int(rng.integers(STREAM_K[0], STREAM_K[1] + 1))
        d = walk_end(g, s, k, rng) if rng.random() < STREAM_REACH else s
        while d == s:
            d = zipf.draw(rng)
        r, acc, output = rng.random(), 0.0, STREAM_OUTPUTS[-1][0]
        for name, mass in STREAM_OUTPUTS:
            acc += mass
            if r < acc:
                output = name
                break
        tenant, _, dl = STREAM_TENANTS[rng.choice(len(STREAM_TENANTS),
                                                  p=STREAM_TENANT_P)]
        events.append((float(t), PathQuery(
            s, d, k, output=output, tenant=tenant,
            deadline_s=None if dl is None else dl * quantum_s)))
    for i in range(delta_every, n_arrivals, delta_every):
        adds = []
        while len(adds) < 4:
            u, v = rng.integers(0, g.n, size=2)
            if u != v:
                adds.append((int(u), int(v)))
        idx = rng.choice(len(g.indices), size=4, replace=False)
        dels = [(int(edge_src[j]), int(g.indices[j])) for j in idx]
        events.append((float(times[i]),
                       GraphDelta.from_pairs(add=adds, remove=dels)))
    events.sort(key=lambda e: e[0])
    return events


def stream_replay(engine, events, policy, cost, n_groups: int = 2,
                  gamma=None, fail_injector=None) -> dict:
    """exp11's open-loop client: arrivals stamped with their trace time,
    the model clock stepped to the next arrival or the oldest waiter's
    max_delay expiry, ``pump`` after each step. Returns the session, the
    arrival and completion times, the results and, per result, the graph
    it was answered on (the engine's graph after the pump that answered
    it: a pump flushes queued deltas before it admits)."""
    from repro_torch.core import GraphDelta, PathSession
    from repro_torch.launch.serve import ServiceModelClock
    clock = ServiceModelClock(*cost)
    session = PathSession(engine, planner="batch", n_groups=n_groups,
                          policy=policy, gamma=gamma, warm_bias_eps=0.0,
                          clock=clock)
    session.server.fail_injector = fail_injector
    admitted = []
    submit = session.server.sched.submit

    def record(clusters):
        admitted.append([list(cl) for cl in clusters])
        return submit(clusters)
    session.server.sched.submit = record
    arrival, done_t, results, graph_of, pending = {}, {}, {}, {}, {}

    def collect(drain=False):
        for qid, r in session.results(drain=drain).items():
            require(qid not in results, f"qid {qid} resolved twice")
            results[qid], done_t[qid] = r, clock()
            graph_of[qid] = engine.g
            pending.pop(qid, None)

    i = 0
    while i < len(events) or pending:
        targets = [events[i][0]] if i < len(events) else []
        if pending:
            targets.append(min(pending.values()) + policy.max_delay_s
                           + 1e-9)
        t = max(clock(), min(targets))
        while i < len(events) and events[i][0] <= t:
            t_ev, what = events[i]
            i += 1
            if isinstance(what, GraphDelta):
                session.apply_delta(what)
                continue
            qid = session.submit(what, now=t_ev)
            arrival[qid] = t_ev
            pending[qid] = t_ev
        clock.t = max(clock.t, t)
        session.pump()
        collect()
    collect(drain=True)
    return {"session": session, "clock": clock, "arrival": arrival,
            "done_t": done_t, "results": results, "graph_of": graph_of,
            "admitted": admitted}


def batch_cuts(batch_log) -> list:
    """What admission decided for each micro-batch of a server."""
    return [(b["n_queries"], b["n_clusters"], b["tenants"], b["n_shed"],
             b["n_deadline_miss"], b["n_deltas"]) for b in batch_log]


def stream_outcome(r) -> tuple:
    """What a result says, comparable across runs."""
    if not r.ok:
        return ("shed", r.shed_reason)
    out = r.query.output.value
    if out == "paths":
        return ("paths", r.paths.tobytes(), r.paths.shape)
    return (out, r.count if out == "count" else None, r.exists)


def stream_check_oracle(rep, n: int) -> tuple[int, int]:
    """``n`` OK path results against the brute-force oracle on the graph
    each was answered on (fewer where a stream has fewer): the first
    empty ones (by qid), at most ``n // 2`` where there are as many
    non-empty ones, then the first non-empty ones. Returns the numbers
    held, in all and non-empty."""
    from repro_torch.core import oracle
    paths = [qid for qid in sorted(rep["results"])
             if rep["results"][qid].ok
             and rep["results"][qid].query.output.value == "paths"]
    full = [q for q in paths if len(rep["results"][q].paths)]
    empty = [q for q in paths if not len(rep["results"][q].paths)]
    n_empty = min(len(empty), n - min(len(full), n // 2))
    picked = full[:n - n_empty] + empty[:n_empty]
    for qid in picked:
        r = rep["results"][qid]
        s, t, k = r.query.key
        check_paths(rep["graph_of"][qid], r.query.key, r.paths)
        expect = oracle.path_set(oracle.enumerate_paths_bruteforce(
            rep["graph_of"][qid], s, t, k))
        require(oracle.path_set(r.paths) == expect
                and len(r.paths) == len(expect),
                f"streamed query {r.query.key}: {len(r.paths)} paths, "
                f"oracle {len(expect)}")
    return len(picked), len(picked) - n_empty


def stream_level_stats(np, rep, events, quantum_s: float, window) -> dict:
    srv, results = rep["session"].server, rep["results"]
    n_arr = len(rep["arrival"])
    require(sorted(results) == sorted(rep["arrival"])
            and len(results) == n_arr,
            f"lost queries: {n_arr} arrivals, {len(results)} results")
    ok = [qid for qid, r in results.items() if r.ok]
    e2e = np.array([rep["done_t"][q] - rep["arrival"][q] for q in ok])
    q = [float(np.percentile(e2e, p)) if e2e.size else 0.0
         for p in (50, 99, 99.9)]
    reasons = {}
    for r in results.values():
        if not r.ok:
            reasons[r.shed_reason] = reasons.get(r.shed_reason, 0) + 1
    elapsed = max(rep["clock"](), events[-1][0])
    walls = [b["wall_s"] for b in srv.batch_log]
    asm = [b["t_assemble_s"] for b in srv.batch_log]
    deltas = srv.delta_log
    tenants = {}
    for b in srv.batch_log:
        for name, c in b["tenants"].items():
            tenants[name] = tenants.get(name, 0) + c
    return {
        "n_arrivals": n_arr, "n_ok": len(ok), "n_lost": 0,
        # answers with at least one path (the rest are exact empties)
        "n_nonempty": sum(1 for q in ok if results[q].exists),
        "n_shed": n_arr - len(ok), "shed_rate": (n_arr - len(ok)) / n_arr,
        "shed_reasons": reasons,
        "n_deadline_miss": srv.n_deadline_miss,
        "n_pressure_fast_path": int(sum(
            v for (name, _), v in window.items()
            if name == "serve_pressure_fast_path_total")),
        "goodput_qps_virtual": (len(ok) - srv.n_deadline_miss) / elapsed,
        "p50_s": q[0], "p99_s": q[1], "p999_s": q[2],
        "p50_x": q[0] / quantum_s, "p99_x": q[1] / quantum_s,
        "p999_x": q[2] / quantum_s,
        "n_batches": len(srv.batch_log), "dispatches":
            rep["clock"].dispatches,
        "batch_wall_p50_s": float(np.percentile(walls, 50)),
        "batch_wall_max_s": max(walls),
        "batch_wall_sum_s": sum(walls),
        "t_assemble_p50_s": float(np.percentile(asm, 50)),
        "t_assemble_sum_s": sum(asm),
        "clusters_per_batch": sum(b["n_clusters"] for b in srv.batch_log)
        / len(srv.batch_log),
        "n_materialized": sum(b["n_materialized"] for b in srv.batch_log),
        "n_cache_hits": sum(b["n_cache_hits"] for b in srv.batch_log),
        "tenants": tenants,
        "deltas_applied": len(deltas),
        "t_apply_sum_s": sum(d["t_apply_s"] for d in deltas),
        "cache_evicted": sum(d.get("cache_evicted", 0) for d in deltas),
        "cache_kept_last": next((d["cache_kept"] for d in reversed(deltas)
                                 if "cache_kept" in d), None),
    }


def phase_streaming(torch, g) -> dict:
    """Phase streaming (see the module docstring). Returns the traced
    level's stream and what the single-device server gave on it."""
    import numpy as np
    from repro_torch.core import (EngineConfig, PathQuery, PathSession,
                                  generators)
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import AdmissionPolicy, GroupFailure
    from repro_torch.obs import metrics as obsmetrics
    from repro_torch.obs import trace as obstrace

    t_phase = time.perf_counter()
    engine = PathSession(g, EngineConfig(min_cap=64,
                                         cache_bytes=64 << 20),
                         device="cuda").engine

    # the service model c0 + c1*Q from warm walls at 4 and 16 queries
    def warm_wall(size: int) -> float:
        qs = generators.random_queries(g, size, STREAM_K, seed=11)
        sess = PathSession(engine, planner="batch", n_groups=2,
                           warm_bias_eps=0.0, policy=AdmissionPolicy(
                               max_batch=size, min_batch=size,
                               max_delay_s=0.0))
        walls = []
        for _ in range(3):
            for q in qs:
                sess.submit(q)
            got = sess.results()
            require(len(got) == size and all(r.ok for r in got.values()),
                    "calibration lost queries")
            walls.append(sess.batch_log[-1]["wall_s"])
        calibration[size] = walls
        return max(min(walls), 1e-5)

    t0 = time.perf_counter()
    calibration = {}
    small = STREAM_MAX_BATCH // 4
    w_full, w_small = warm_wall(STREAM_MAX_BATCH), warm_wall(small)
    c1 = max((w_full - w_small) / (STREAM_MAX_BATCH - small), w_full / 256)
    c0 = max(w_small - small * c1, w_full / 64)
    t_calibrate = time.perf_counter() - t0
    cost = (c0, c1)
    quantum = c0 + STREAM_MAX_BATCH * c1
    capacity = STREAM_MAX_BATCH / quantum
    policy = AdmissionPolicy(
        max_batch=STREAM_MAX_BATCH, min_batch=4, max_delay_s=1.5 * quantum,
        max_queue=2 * STREAM_MAX_BATCH, shed_expired=True,
        tenant_weights={name: w for name, w, _ in STREAM_TENANTS})
    zipf = ZipfSampler(np, g.n, seed=7)
    edge_src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    delta_every = max(24, STREAM_ARRIVALS // 8)

    def stream_launches(what: str) -> dict:
        """The stream's launches since the counts were last set to 0;
        each kernel of the path must be among them."""
        got = {k: LAUNCHES[k] for k in STREAM_KERNELS}
        require(all(v > 0 for v in got.values()),
                f"{what}: a kernel of the stream never launched: {got}")
        return got

    levels, traced, launches = [], None, {}
    for li, (kind, mult) in enumerate(STREAM_LEVELS):
        t0 = time.perf_counter()
        events = stream_events(np, g, edge_src, zipf, 100 + li, kind,
                               mult * capacity, STREAM_ARRIVALS, quantum,
                               delta_every)
        g_start = engine.g
        msnap = obsmetrics.registry().snapshot()
        if mult == STREAM_TRACED:
            obstrace.enable(capacity=1 << 20).reset()
        reset_launches()
        rep = stream_replay(engine, events, policy, cost)
        launches[f"{kind} {mult}x"] = stream_launches(f"{kind} {mult}x")
        if mult == STREAM_TRACED:
            obstrace.disable()
            path = os.path.join(ROOT, "build", "streaming_trace.json")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            obstrace.tracer().export(path)
            doc = obstrace.load(path)
            obstrace.tracer().reset()
            traced = {"level": f"{kind} {mult}x", "file": "build/"
                      "streaming_trace.json",
                      "n_spans": sum(1 for e in doc["traceEvents"]
                                     if e.get("ph") == "X"),
                      "coverage_serve_batch": obstrace.coverage(
                          doc, root="serve.batch"),
                      "summary": obstrace.summarize(doc)}
            require(traced["n_spans"] > 0 and {"serve.batch",
                    "serve.assemble", "engine.run"}
                    <= obstrace.stage_names(doc),
                    "the traced level recorded no serving spans")
            replay_from = (g_start, events, rep)
        stats = stream_level_stats(
            np, rep, events, quantum,
            obsmetrics.registry().since(msnap))
        stats["oracle_checked"], stats["oracle_nonempty"] = \
            stream_check_oracle(rep, STREAM_ORACLE)
        require(stats["oracle_nonempty"] > 0,
                f"{kind} {mult}x: no non-empty path result to check")
        stats.update(kind=kind, offered_mult=mult,
                     offered_qps_virtual=mult * capacity,
                     host_s=time.perf_counter() - t0)
        levels.append(stats)
        del rep
    require(levels[-1]["n_shed"] > 0, "the overloaded level shed nothing")

    # determinism: the traced level again, untraced, from its start graph
    # (and an empty cache: set_graph drops it) on every try, under a
    # card-only profiler (the serving window's device busy share)
    t0 = time.perf_counter()
    g_start, events, first = replay_from
    box = {}
    dev_events, dev_wall = trace_device(
        torch, lambda: box.update(
            again=stream_replay(engine, events, policy, cost)),
        setup=lambda: engine.set_graph(g_start))
    launches["replay"] = stream_launches("the replay")
    again = box["again"]
    require(again["admitted"] == first["admitted"],
            "the replay admitted other batches")
    require(batch_cuts(first["session"].batch_log)
            == batch_cuts(again["session"].batch_log),
            "the replay's batches differ")
    require(sorted(again["results"]) == sorted(first["results"])
            and all(stream_outcome(again["results"][q])
                    == stream_outcome(first["results"][q])
                    for q in first["results"])
            and again["done_t"] == first["done_t"],
            "the replay's sheds or results differ")
    dev_s = device_ns(dev_events) / 1e9
    determinism = {"level": f"{STREAM_TRACED}x", "equal": True,
                   "batches": len(again["admitted"]),
                   "profiled_wall_s": dev_wall, "device_s": dev_s,
                   "device_events": len(dev_events),
                   "busy_share": dev_s / dev_wall,
                   "batch_wall_sum_s": sum(
                       b["wall_s"] for b in again["session"].batch_log),
                   "t_apply_sum_s": sum(
                       d["t_apply_s"] for d in again["session"]
                       .server.delta_log),
                   "host_s": time.perf_counter() - t0}
    level_1x = {"g_start": g_start, "events": events, "policy": policy,
                "cost": cost, "quantum": quantum,
                "outcomes": {q: stream_outcome(r)
                             for q, r in first["results"].items()},
                "done_t": first["done_t"],
                "batches": batch_cuts(first["session"].batch_log),
                "stats": next(lv for lv in levels
                              if lv["offered_mult"] == STREAM_TRACED)}
    del first, again, replay_from

    # failover: group 0 dies executing its second item
    t0 = time.perf_counter()
    n_fo, groups, gamma = STREAM_FAILOVER
    fo_queries = [PathQuery(int(s), int(t), int(k)) for s, t, k in
                  generators.random_queries(engine.g, n_fo, STREAM_K,
                                            seed=977)]
    events = [(i * quantum * 0.05, q) for i, q in enumerate(fo_queries)]
    seen = {"n": 0}

    def injector(grp, item):
        if grp == 0:
            seen["n"] += 1
            if seen["n"] == 2:
                raise GroupFailure(grp)

    cache_before = engine.cache
    reset_launches()
    fo = stream_replay(engine, events, AdmissionPolicy(
        max_batch=STREAM_MAX_BATCH, min_batch=1, max_delay_s=0.4 * quantum),
        cost, n_groups=groups, gamma=gamma, fail_injector=injector)
    srv = fo["session"].server
    require(sorted(fo["results"]) == sorted(fo["arrival"]) == list(range(n_fo))
            and all(r.ok for r in fo["results"].values()),
            "failover lost or shed queries")
    require(srv.n_failovers == 1 and srv.sched.requeued >= 1
            and srv.dead_groups == {0},
            f"failover: {srv.n_failovers} failovers, "
            f"{srv.sched.requeued} requeued, dead {srv.dead_groups}")
    require(engine.cache is cache_before and len(engine.cache) > 0,
            "the cache did not survive the failover")
    launches["failover"] = stream_launches("the failover segment")
    fo_oracle, fo_oracle_nonempty = stream_check_oracle(fo, STREAM_ORACLE)
    fo_nonempty = sum(1 for r in fo["results"].values() if r.exists)
    require(fo_oracle_nonempty > 0, "the failover segment found no path")
    srv.revive_group(0)
    seen["n"] = -10 ** 9
    extra = [fo["session"].submit(q) for q in fo_queries[:STREAM_MAX_BATCH]]
    got = fo["session"].results()
    require(sorted(got) == extra and all(r.ok for r in got.values()),
            "the revived group did not serve")
    failover = {"n_queries": n_fo, "n_groups": groups,
                "failovers": srv.n_failovers,
                "requeued": srv.sched.requeued, "steals": srv.sched.steals,
                "n_lost": 0, "exactly_once": True,
                "oracle_checked": fo_oracle,
                "oracle_nonempty": fo_oracle_nonempty,
                "n_nonempty": fo_nonempty,
                "cache_entries_after": len(engine.cache),
                "revived_ok": True, "host_s": time.perf_counter() - t0}
    out = {"phase": "streaming", "n": g.n, "m": g.m,
           "c0_s": c0, "c1_s": c1, "quantum_s": quantum,
           "capacity_qps_virtual": capacity,
           "calibration_walls_s": calibration,
           "t_calibrate_s": t_calibrate,
           "arrivals_per_level": STREAM_ARRIVALS,
           "reachable_share": STREAM_REACH,
           "policy": {"max_batch": policy.max_batch,
                      "min_batch": policy.min_batch,
                      "max_delay_quanta": 1.5,
                      "max_queue": policy.max_queue},
           "levels": levels, "launches": launches,
           "determinism": determinism, "failover": failover,
           "cache": engine.cache.info(),
           "trace": traced, "seconds": time.perf_counter() - t_phase}
    emit(out)
    return level_1x


def stream_overlap(events) -> dict:
    """Of a window's device events: their summed time, the time at least
    one was running (the union of their intervals), and the largest
    number of distinct streams with a kernel running at one instant."""
    marks = []
    for name, stream, t0, t1 in events:
        marks += [(t0, 1, stream, device_kind(name)),
                  (t1, -1, stream, device_kind(name))]
    marks.sort(key=lambda m: (m[0], m[1]))
    live, kernels, busy_ns, widest, last = 0, {}, 0, 0, None
    for t, step, stream, kind in marks:
        if live > 0:
            busy_ns += t - last
        live += step
        last = t
        if kind == "kernel":
            kernels[stream] = kernels.get(stream, 0) + step
            widest = max(widest, sum(1 for v in kernels.values() if v > 0))
    return {"device_ms": device_ns(events) / 1e6,
            "busy_ms": busy_ns / 1e6, "max_streams_in_flight": widest}


def allocator_counts(torch) -> dict:
    """The caching allocator's counts that a stall on it would move:
    bytes reserved, device allocations and frees, and the retries after
    a failed device allocation (each frees every cached block)."""
    st = torch.cuda.memory_stats()
    return {"reserved_bytes": st.get("reserved_bytes.all.current", 0),
            "device_allocs": st.get("num_device_alloc", 0),
            "device_frees": st.get("num_device_free", 0),
            "alloc_retries": st.get("num_alloc_retries", 0)}


def check_rows_equal(queries, want, got, what: str) -> None:
    """The same path rows in the same order, counts and flags."""
    import numpy as np
    for q, a, b in zip(queries, want, got):
        require(np.array_equal(a.paths, b.paths) and a.count == b.count
                and a.exists == b.exists, f"{what}: query {q} differs")


def check_per_device(rep, n_queries: int, what: str) -> list:
    """A fanned-out run's placement: one entry per replica, whose
    clusters and queries add up to the run's."""
    pd = rep.stats.get("per_device")
    require(pd is not None and len(pd) == len(SHARDED_MESH)
            and rep.stats["n_devices"] == len(SHARDED_MESH),
            f"{what}: per_device {pd}")
    require(sum(d["n_clusters"] for d in pd) == rep.stats["n_clusters"]
            and sum(d["n_queries"] for d in pd) == n_queries,
            f"{what}: per_device does not add up to the run: {pd}")
    return pd


def placement(pd) -> dict:
    loads = [d["cost"] for d in pd]
    mean = sum(loads) / len(loads)
    return {"per_device": pd,
            "lpt_makespan_over_mean": max(loads) / mean if mean else None}


def phase_sharded(torch, g, main_in, share_in, delta_in, level_1x) -> dict:
    """Phase sharded (see the module docstring)."""
    import numpy as np
    from repro_torch.core import EngineConfig, PathQuery, PathSession
    from repro_torch.core import build_index
    from repro_torch.core.clustering import cluster_queries
    from repro_torch.core.planner import RouterConfig
    from repro_torch.core.similarity import similarity_matrix
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.obs import metrics as obsmetrics

    t_phase = time.perf_counter()
    out = {"phase": "sharded", "mesh": SHARDED_MESH,
           "device_count": torch.cuda.device_count()}

    def launched(what: str, kernels=STREAM_KERNELS) -> dict:
        got = {k: LAUNCHES[k] for k in kernels}
        require(all(v > 0 for v in got.values()),
                f"{what}: a kernel of the path never launched: {got}")
        return got

    # the main batch (plan_caps=False) against phase main's cold run
    queries, main_report, main_warm = main_in
    s4 = PathSession(g, EngineConfig(plan_caps=False), mesh=SHARDED_MESH,
                     device="cuda")
    ex = s4.engine.executor
    require(ex.n_replicas == len(SHARDED_MESH) and ex.sharded
            and ex.index_dg is s4.engine.dg, "the mesh was not taken")
    reset_launches()
    t0 = time.perf_counter()
    rep = s4.run(queries, planner="batch")
    host = time.perf_counter() - t0
    check_rows_equal(queries, main_report, rep, "main batch, 4 replicas")
    require(rep.stats["n_clusters"] == main_report.stats["n_clusters"],
            "main batch: the clusters differ")
    pd = check_per_device(rep, len(queries), "main batch")
    out["main"] = {"host_wall_s": host, "t_wall_s": rep.stats["t_wall_s"],
                   "t_fanout_s": rep.stats["t_fanout_s"],
                   "t_place_s": rep.stats["t_place_s"],
                   "n_clusters": rep.stats["n_clusters"],
                   "stats": {k: rep.stats[k] for k in STAT_KEYS},
                   "phase_main_warm_t_wall_s": [w["t_wall_s"]
                                                for w in main_warm],
                   # plan_caps=False: no walk counts, no ell_spmm
                   "launches": launched("main batch, 4 replicas",
                                        FIRST_SLICE),
                   **placement(pd)}
    del s4, rep

    # the sharing batch: the identity mesh against phase planners, then
    # four replicas. It forms one cluster, which no mesh splits, so the
    # four-replica engine balances it into as many clusters as replicas;
    # its reference is the identity engine on that same partition.
    share, planner_reports = share_in
    s1 = PathSession(g, EngineConfig(n_devices=1), device="cuda")
    require(not s1.engine.executor.sharded, "n_devices=1 is sharded")
    ident = {}
    for planner in ("batch", "auto"):
        r1 = s1.run(share, planner=planner)
        ref = planner_reports[planner]
        check_rows_equal(share, ref, r1, f"sharing {planner}, n_devices=1")
        require("per_device" not in r1.stats
                and r1.stats["n_clusters"] == ref.stats["n_clusters"]
                and r1.stats.get("cluster_planners")
                == ref.stats.get("cluster_planners")
                and r1.routes == ref.routes,
                f"sharing {planner}: n_devices=1 is not the identity")
        ident[planner] = {"n_clusters": r1.stats["n_clusters"],
                          "cluster_routes": r1.stats.get("cluster_routes")}
    out["identity"] = ident
    s4 = PathSession(g, EngineConfig(balance_clusters=True),
                     mesh=SHARDED_MESH, device="cuda")
    index = build_index(s4.engine.dg, share)
    clusters = cluster_queries(similarity_matrix(index),
                               s4.engine.cfg.gamma,
                               min_clusters=len(SHARDED_MESH))
    # the first, cold four-replica run, under a card-only profiler and
    # between two readings of the caching allocator
    runs = {}
    mem0, box = allocator_counts(torch), {}
    events, wall = trace_device(torch, lambda: box.update(
        rep=s4.run(share, planner="batch")))
    rep = box["rep"]
    mem1 = allocator_counts(torch)
    runs["batch_launches"] = launched("sharing batch, 4 replicas")
    cold = [d["t_wall_s"] for d in rep.stats["per_device"]]
    heavy = max(range(len(cold)),
                key=lambda i: rep.stats["per_device"][i]["cost"])
    runs["cold"] = {"replica_t_wall_s": cold,
                    "t_fanout_s": rep.stats["t_fanout_s"],
                    "t_place_s": rep.stats["t_place_s"],
                    "wall_s": wall, **stream_overlap(events),
                    "allocator": {k: mem1[k] - mem0[k] for k in mem0},
                    "reserved_bytes": mem1["reserved_bytes"]}
    require(all(w <= SHARDED_COLD_MAX_S for i, w in enumerate(cold)
                if i != heavy),
            f"sharing batch, cold: a light replica took over "
            f"{SHARDED_COLD_MAX_S} s: {runs['cold']}")
    require(rep.stats["n_clusters"] == len(clusters),
            f"sharing batch: {rep.stats['n_clusters']} clusters, balanced "
            f"partition {len(clusters)}")
    ref_batch = s1.run(share, planner="batch", clusters=clusters)
    check_rows_equal(share, ref_batch, rep, "sharing batch, 4 replicas")
    for key in ("n_clusters", "n_psi_nodes", "n_materialized", "n_shared"):
        require(rep.stats[key] == ref_batch.stats[key],
                f"sharing batch: {key} {rep.stats[key]} != "
                f"{ref_batch.stats[key]}")
    runs["batch"] = placement(check_per_device(rep, len(share),
                                               "sharing batch"))
    rep = s4.run(share, planner="basic")
    check_rows_equal(share, s1.run(share, planner="basic"), rep,
                     "sharing basic, 4 replicas")
    ref = s1.run(share, planner="auto", clusters=clusters)
    reset_launches()
    rep = s4.run(share, planner="auto", clusters=clusters)
    check_rows_equal(share, ref, rep, "sharing auto, 4 replicas")
    require(rep.stats["n_clusters"] == ref.stats["n_clusters"]
            and rep.stats["cluster_planners"]
            == ref.stats["cluster_planners"],
            "sharing auto: clusters or cluster planners differ")
    # the router's RED rule on this run's clusters: a cluster routes RED
    # iff its summed estimate clears red_min_cost
    qs = [PathQuery.coerce(q) for q in share]
    dists = (index.dist_s.cpu().numpy(), index.dist_t.cpu().numpy())
    est = {e.qi: e for e in s4.engine.router.estimate(index, qs, dists)}
    kept = [[qi for qi in cl if est[qi].route.value != "green"]
            for cl in clusters]
    costs = [sum(est[qi].cost for qi in cl) for cl in kept if cl]
    red_min = s4.engine.router.cfg.red_min_cost
    require(rep.stats["cluster_routes"]
            == ["red" if c >= red_min else "yellow" for c in costs],
            f"sharing auto: routes {rep.stats['cluster_routes']} for costs "
            f"{costs} at red_min_cost {red_min}")
    runs["auto"] = {"cluster_costs": costs, "red_min_cost": red_min,
                    "cluster_routes": rep.stats["cluster_routes"],
                    "routed_red": rep.stats["routed_red"],
                    "identity_routes": ref.stats["cluster_routes"]}
    if not rep.stats["routed_red"]:
        # no cluster clears the default at these costs: the heaviest
        # cluster's own cost as the threshold, where it must route RED
        red_min = max(costs)
        s_red = PathSession(g, EngineConfig(
            balance_clusters=True, router=RouterConfig(red_min_cost=red_min)),
            mesh=SHARDED_MESH, device="cuda")
        rep = s_red.run(share, planner="auto", clusters=clusters)
        check_rows_equal(share, ref, rep, "sharing auto, RED threshold")
        require(rep.stats["routed_red"] > 0
                and "red" in rep.stats["cluster_routes"],
                f"no RED at red_min_cost {red_min}: {rep.stats}")
        runs["auto_red"] = {"red_min_cost": red_min,
                            "cluster_routes": rep.stats["cluster_routes"],
                            "routed_red": rep.stats["routed_red"],
                            "per_device": rep.stats.get("per_device")}
        del s_red
    runs["auto_launches"] = dict(LAUNCHES)

    # warm walls, and one warm run under a card-only profiler
    walls = {"4": [], "1": []}
    for _ in range(3):
        for key, fn in (("4", lambda: s4.run(share, planner="batch")),
                        ("1", lambda: s1.run(share, planner="batch",
                                             clusters=clusters))):
            walls[key].append(fn().stats["t_wall_s"])
    box = {}
    events, wall = trace_device(torch, lambda: box.update(
        rep=s4.run(share, planner="batch")))
    rep = box["rep"]
    check_rows_equal(share, ref_batch, rep, "profiled sharing batch")
    level_streams = {st for name, st, *_ in events
                     if "expand_level_kernel" in name}
    require(len(level_streams) >= 2,
            f"level_fused ran on {len(level_streams)} stream(s)")
    ov = stream_overlap(events)
    out["sharing"] = {
        "queries": len(share), "n_clusters": len(clusters), **runs,
        "warm_t_wall_s": {f"{k}_replicas": {"median": statistics.median(v),
                                            "runs": v}
                          for k, v in walls.items()},
        "profile": {"wall_s": wall, "t_fanout_s": rep.stats["t_fanout_s"],
                    "device_events": len(events),
                    "level_fused_streams": len(level_streams),
                    "streams": len({st for _, st, *_ in events}),
                    **ov, "busy_share": ov["busy_ms"] / (wall * 1e3),
                    "device_over_fanout":
                        ov["device_ms"] / (rep.stats["t_fanout_s"] * 1e3),
                    "replica_t_wall_s": [d["t_wall_s"] for d in
                                         rep.stats["per_device"]]}}
    del s1, s4, rep, box, events

    # deltas: a plain and a four-replica engine, phase delta's far and
    # near deltas on both
    dqs = [q for q in queries if q[2] == 4]
    far, near = delta_in
    plain = PathSession(g, EngineConfig(cache_bytes=64 << 20), device="cuda")
    four = PathSession(g, EngineConfig(cache_bytes=64 << 20),
                       mesh=SHARDED_MESH, device="cuda")
    check_rows_equal(dqs, plain.run(dqs), four.run(dqs), "delta cold")
    steps = []
    for step, delta in (("far", far), ("near", near)):
        rp, r4 = plain.apply_delta(delta), four.apply_delta(delta)
        epochs = r4.get("cache_epochs", [])
        require(r4["n_touched"] == rp["n_touched"]
                and len(epochs) == len(SHARDED_MESH)
                and set(epochs) == {rp["cache_epoch"]},
                f"delta {step}: {r4} against {rp}")
        # cache_evicted / cache_kept count the primary's cache, which
        # holds only replica 0's clusters: not compared
        for key in ("cache_mode", "device_update", "n_added", "n_removed"):
            require(r4.get(key) == rp.get(key), f"delta {step}: {key}")
        eng = four.engine
        for rep4 in eng.executor.replicas()[1:]:
            require(torch.equal(rep4.dg.ell_idx, eng.dg.ell_idx)
                    and torch.equal(rep4.dg.r_ell_idx, eng.dg.r_ell_idx),
                    f"delta {step}: a replica's tables differ")
        a, b = plain.run(dqs), four.run(dqs)
        check_rows_equal(dqs, a, b, f"delta {step} rerun")
        steps.append({"step": step, "plain": rp, "four": r4,
                      "rerun_t_wall_s": [a.stats["t_wall_s"],
                                         b.stats["t_wall_s"]],
                      "rerun_cache_hits": [a.stats["n_cache_hits"],
                                           b.stats["n_cache_hits"]]})
    out["delta"] = {"queries": len(dqs), "steps": steps}
    del plain, four

    # serving: the traced streaming level on a four-replica engine
    lv = level_1x
    engine = PathSession(lv["g_start"], EngineConfig(
        min_cap=64, cache_bytes=64 << 20), mesh=SHARDED_MESH,
        device="cuda").engine
    msnap = obsmetrics.registry().snapshot()
    reset_launches()
    t0 = time.perf_counter()
    rep = stream_replay(engine, lv["events"], lv["policy"], lv["cost"])
    srv = rep["session"].server
    serve_launches = launched("sharded serving")
    require(sorted(rep["results"]) == sorted(lv["outcomes"])
            and all(stream_outcome(rep["results"][q]) == lv["outcomes"][q]
                    for q in lv["outcomes"])
            and rep["done_t"] == lv["done_t"],
            "sharded serving: results or completion times differ")
    require(batch_cuts(srv.batch_log) == lv["batches"],
            "sharded serving: other batches")
    require(srv.sched.steals == 0 and rep["admitted"] == [],
            "sharded serving went through the stealing loop")
    inline = 0
    for b in srv.batch_log:
        if b["n_clusters"] > 1:
            require(b.get("n_devices") == len(SHARDED_MESH)
                    and len(b["per_device"]) == len(SHARDED_MESH)
                    and sum(d["n_clusters"] for d in b["per_device"])
                    == b["n_clusters"],
                    f"sharded serving: a batch without placement: {b}")
        else:
            inline += 1          # one cluster: the executor runs it inline
            require("per_device" not in b, f"one cluster fanned out: {b}")
    stats = stream_level_stats(np, rep, lv["events"], lv["quantum"],
                               obsmetrics.registry().since(msnap))
    one_p50 = lv["stats"]["batch_wall_p50_s"]
    require(stats["batch_wall_p50_s"] <= SHARDED_SERVE_MAX_X * one_p50,
            f"sharded serving: batch wall p50 {stats['batch_wall_p50_s']} "
            f"s, over {SHARDED_SERVE_MAX_X}x one replica's {one_p50} s")
    out["serving"] = {
        "batches": len(srv.batch_log), "one_cluster_batches": inline,
        "p50_x": stats["p50_x"], "p99_x": stats["p99_x"],
        "batch_wall_p50_s": stats["batch_wall_p50_s"],
        "single_device": {k: lv["stats"][k] for k in
                          ("p50_x", "p99_x", "batch_wall_p50_s")},
        "n_ok": stats["n_ok"], "n_nonempty": stats["n_nonempty"],
        "steals": srv.sched.steals, "launches": serve_launches,
        "exactly_once": True, "host_s": time.perf_counter() - t0}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


def overlap_rows(torch, n: int, N: int, L: int, gen):
    """(N, L) int32 rows of random vertex ids below n, each cut to a
    random length of 1..L with -1 pads after it."""
    ids = torch.randint(0, n, (N, L), generator=gen, device="cuda",
                        dtype=torch.int32)
    lens = torch.randint(1, L + 1, (N, 1), generator=gen, device="cuda")
    pos = torch.arange(L, device="cuda")[None, :]
    return torch.where(pos < lens, ids, -1).to(torch.int32).contiguous()


def phase_ops(torch, g, main_rec, join_rec) -> dict:
    """Phase 10 (see the module docstring): the four calls of the ops API,
    counted, then checked against the engine's own kernels and joins."""
    from repro_torch.core.join import keyed_join_count
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.msbfs_expand import ops as mops
    from repro_torch.kernels.path_join import ops as jops

    ell, fr, vis, dist, hop = main_rec["msbfs_step"].best
    gen = torch.Generator(device="cuda").manual_seed(1)
    a4k = overlap_rows(torch, g.n, 4096, 6, gen)
    b4k = overlap_rows(torch, g.n, 4096, 6, gen)
    sp, ky = join_rec["splice"].best, join_rec["keyed"].best
    p_col, c_col = sp["kw"]["p_col"], sp["kw"]["c_col"]
    a_col, b_col = ky["kw"]["a_col"], ky["kw"]["b_col"]
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    nxt = mops.msbfs_hop_packed(ell, fr)
    ov = jops.path_overlap(a4k, b4k)
    splice = jops.splice_join_valid(sp["a"], p_col, sp["b"], c_col)
    keyed = jops.keyed_join_valid(ky["a"], a_col, ky["b"], b_col)
    torch.cuda.synchronize()
    t_ops = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    require(launches["msbfs_expand"] == 1 and launches["path_overlap"] == 3,
            f"the ops API did not launch its kernels: {launches}")

    # the hop, deduplicated against the visited words, is the level that
    # the fused msbfs_step kernel computed on the same inputs
    level = mops.msbfs_step_cuda(ell, fr, vis.clone(), dist.clone(), hop)
    require(torch.equal(nxt[:-1] & ~vis, level[:-1]) and not nxt[-1].any(),
            "msbfs_hop_packed disagrees with msbfs_step")
    require(int(ov.min()) >= 0 and int(ov.max()) <= 36
            and ov.shape == (4096, 4096), "path_overlap out of range")
    n_splice = int(splice.sum())
    require(n_splice == sp["count"],
            f"splice_join_valid counts {n_splice}, the join {sp['count']}")
    sa, b_verts, b_count = ky["args"]
    n_keyed, ovf = keyed_join_count(sa, b_verts, b_count, a_col=a_col,
                                    b_col=b_col, pair_cap=ky["kw"]["out_cap"])
    require(not bool(ovf) and int(keyed.sum()) == int(n_keyed)
            == ky["count"], f"keyed_join_valid counts {int(keyed.sum())}, "
                            f"keyed_join_count {int(n_keyed)}, the join "
                            f"{ky['count']}")
    out = {"phase": "ops", "launches": {k: launches[k] for k in OPS_KERNELS},
           "t_ops_s": t_ops,
           "msbfs_hop_packed": {"V": ell.shape[0], "D": ell.shape[1],
                                "W": fr.shape[1],
                                "next_bits": popcount_total(torch, nxt)},
           "path_overlap": {"NA": 4096, "NB": 4096, "LA": 6, "LB": 6,
                            "nonzero": int(torch.count_nonzero(ov))},
           "splice_join_valid": {"NP": sp["a"].shape[0],
                                 "NC": sp["b"].shape[0], "p_col": p_col,
                                 "c_col": c_col, "valid": n_splice},
           "keyed_join_valid": {"NA": ky["a"].shape[0],
                                "NB": ky["b"].shape[0], "a_col": a_col,
                                "b_col": b_col, "valid": int(n_keyed)}}
    emit(out)
    return {"launches": out["launches"], "a4k": a4k, "b4k": b4k,
            "splice": (sp["a"][:, :p_col + 1], sp["b"][:, :c_col + 1]),
            "keyed": (ky["a"][:, :a_col + 1], ky["b"][:, :b_col + 1])}


def decode_teacher_forced(torch, model, prompt, steps: int, cache) -> tuple:
    """``decode_step`` over ``prompt[:, :steps]``; the logits at every
    position (B, steps, vocab), the cache, and each step's wall time."""
    logits, times = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache = model.decode_step(prompt[:, i:i + 1], cache)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        logits.append(out[:, 0])
    return torch.stack(logits, 1), cache, times


def teacher_logits(model, tokens):
    """``lm_forward`` + unembed at every position, float32."""
    return (model(tokens) @ model.unembed_weight()).float()


def profiled(torch, fn, calls: int) -> dict:
    """``fn()`` ``calls`` times under ``torch.profiler``, tracing the card
    only (with the host's ops traced too, a granite-8b decode step took
    2.2 s instead of 34 ms on an H100): the
    device time per call summed over the CUDA kernels, by family, and its
    share of the host clock over the same calls (synchronized at both
    ends)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls
    family = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        key = ("flash_attention" if "attn_" in name else
               "gemm" if any(w in name for w in ("gemm", "xmma", "nvjet",
                                                 "cutlass")) else
               "copy" if "memcpy" in name or "memset" in name else "other")
        family[key] = family.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    device = sum(family.values())
    return {"calls": calls, "device_ms": device / calls,
            "by_family_ms": {k: v / calls for k, v in sorted(family.items())},
            "profiled_wall_ms": wall * 1e3,
            "device_busy_share_profiled": device / calls / (wall * 1e3)}


def latency(times) -> dict:
    ts = sorted(times)
    return {"median_s": statistics.median(ts),
            "p90_s": ts[min(len(ts) - 1, int(0.9 * len(ts)))],
            "steps": len(ts)}


def phase_lm(torch) -> dict:
    """Phase 10 (see the module docstring): granite-8b served on the card,
    with checks (a)-(d)."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models.transformer import LM

    # full float32 products for check (a) (the bf16 path is unaffected)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get(LM_ARCH).CONFIG
    B = LM_BATCH
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
               device="cuda")
    torch.cuda.synchronize()
    out = {"phase": "lm", "arch": cfg.name, "dtype": str(model.dtype),
           "config": dataclasses.asdict(cfg),
           "reduced": {"seq_len": [32768, LM_PROMPT],
                       "global_batch": [32, LM_BATCH]},
           "params": model.param_count(), "param_bytes": model.param_bytes(),
           "t_init_s": time.perf_counter() - t0,
           "max_memory_allocated_init": torch.cuda.max_memory_allocated()}
    tokens, _ = TokenStream(cfg.vocab, B, LM_PROMPT, seed=0).batch_at(0)
    prompt = torch.from_numpy(tokens).to("cuda", torch.long)

    # -- the main path, counted: prefill x 3, decode 512 + 32, forward x 1
    calls = dict.fromkeys(("prefill", "decode_step", "lm_forward"), 0)
    reset_launches()
    t_prefill = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = model.prefill(prompt)
        torch.cuda.synchronize()
        t_prefill.append(time.perf_counter() - t0)
        calls["prefill"] += 1
        require(last.shape == (B, 1, cfg.vocab)
                and bool(torch.isfinite(last).all()),
                "prefill logits: wrong shape or not finite (c)")
    cache = model.init_cache(B, LM_TEACHER + LM_GREEDY)
    got, cache, t_teacher = decode_teacher_forced(torch, model, prompt,
                                                  LM_TEACHER, cache)
    calls["decode_step"] += LM_TEACHER
    tok = got[:, -1].argmax(-1, keepdim=True)
    greedy = []

    def greedy_step():
        nonlocal tok, cache
        step, cache = model.decode_step(tok, cache)
        calls["decode_step"] += 1
        require(bool(torch.isfinite(step).all()),
                "greedy decode logits not finite (c)")
        tok = step[:, 0].argmax(-1, keepdim=True)
        greedy.append(tok)

    t_greedy = []
    for _ in range(LM_GREEDY - LM_PROFILED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greedy_step()
        torch.cuda.synchronize()
        t_greedy.append(time.perf_counter() - t0)
    prof_decode = profiled(torch, greedy_step, LM_PROFILED)
    prof_prefill = profiled(torch, lambda: model.prefill(prompt), 1)
    calls["prefill"] += 1
    ref = teacher_logits(model, prompt[:, :LM_TEACHER])
    calls["lm_forward"] += 1
    torch.cuda.synchronize()
    launches = LAUNCHES["flash_attention"]
    expected = cfg.n_layers * sum(calls.values())
    require(launches == expected,
            f"flash_attention launched {launches} times, expected "
            f"{cfg.n_layers} layers x {calls} = {expected} (d)")
    routes = attn_counts(LAUNCHES, fops)
    want_routes = dict.fromkeys(fops.ROUTES, 0)
    want_routes["wgmma"] = cfg.n_layers * (calls["prefill"]
                                           + calls["lm_forward"])
    want_routes["splitk"] = cfg.n_layers * calls["decode_step"]
    require(routes == want_routes,
            f"flash_attention routes {routes}, expected {want_routes}: "
            f"prefill and forward on wgmma, decode_step on split-K (d)")
    require(bool(torch.isfinite(got).all() and torch.isfinite(ref).all()),
            "teacher-forced logits not finite (c)")
    rel = (got - ref).norm(dim=-1) / ref.norm(dim=-1)
    max_rel = float(rel.max())
    require(max_rel <= LM_BF16_REL_L2,
            f"check (b): decode vs forward relative L2 {max_rel} > "
            f"{LM_BF16_REL_L2}")
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    out.update({
        "calls": calls, "launches": {"flash_attention": launches,
                                     **routes},
        "launches_per_call": cfg.n_layers,
        "prefill": {"tokens": B * LM_PROMPT, "t_cold_s": t_prefill[0],
                    "t_warm_s": t_prefill[1:],
                    "tokens_per_s_warm": [B * LM_PROMPT / t
                                          for t in t_prefill[1:]]},
        "decode": {"max_len": LM_TEACHER + LM_GREEDY,
                   "teacher_forced": latency(t_teacher),
                   "greedy": latency(t_greedy),
                   "tokens_per_s_greedy": B * len(t_greedy) / sum(t_greedy),
                   "greedy_tokens": torch.cat(greedy, 1)[0, :8].tolist()},
        "profile": {"prefill": prof_prefill, "decode_step": prof_decode},
        "check_b": {"layers": cfg.n_layers, "dtype": "bfloat16",
                    "positions": LM_TEACHER,
                    "max_rel_l2": max_rel, "bound": LM_BF16_REL_L2,
                    "mean_rel_l2": float(rel.mean()),
                    "argmax_agreement": agree},
        "max_memory_allocated": torch.cuda.max_memory_allocated()})
    del model, cache, got, ref, rel, last
    torch.cuda.empty_cache()

    # -- check (a): full width, float32, depth cut
    cfg_a = dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS,
                                dtype="float32")
    model = LM(cfg_a, generator=torch.Generator(device="cuda")
               .manual_seed(1), device="cuda")
    reset_launches()
    got, cache, _ = decode_teacher_forced(
        torch, model, prompt, LM_TEACHER, model.init_cache(B, LM_TEACHER))
    ref = teacher_logits(model, prompt[:, :LM_TEACHER])
    torch.cuda.synchronize()
    require(LAUNCHES["flash_attention"] == LM_CHECK_LAYERS * (LM_TEACHER + 1)
            == LAUNCHES["attn_scalar"],
            "check (a): flash_attention not launched once per layer on the "
            "float32 route (d)")
    require(bool(torch.isfinite(got).all()), "check (a): logits not finite")
    excess = float(((got - ref).abs() - LM_F32_TOL * ref.abs()).max())
    ok = bool(torch.allclose(got, ref, atol=LM_F32_TOL, rtol=LM_F32_TOL))
    out["check_a"] = {"layers": LM_CHECK_LAYERS, "dtype": "float32",
                      "tf32": False, "positions": LM_TEACHER,
                      "max_abs_err": float((got - ref).abs().max()),
                      "max_excess_over_rtol": excess, "atol": LM_F32_TOL,
                      "rtol": LM_F32_TOL, "ok": ok}
    require(ok, f"check (a): decode vs forward beyond atol = rtol = "
                f"{LM_F32_TOL}: {out['check_a']}")
    del model, cache, got, ref
    torch.cuda.empty_cache()
    emit(out)
    return {"launches": launches, "per_call": cfg.n_layers, "calls": calls,
            "routes": routes}


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


def graph_ms(torch, fn, n: int = ATTN_GRAPH_LAUNCHES) -> float:
    """Device time per call: ``n`` calls of ``fn`` captured in one CUDA
    graph and replayed between one pair of CUDA events (median of 5
    replays), so the host's issue rate (a Python wrapper per launch) does
    not set it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # warm-up off the graph
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
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
    f1 = eops.f1_route(D, F, ell.data_ptr() % 16 == 0)
    return {"shape": {"V": V, "D": D, "F": F, "op": op}, "err": err,
            "kernel": "ell_gather_f1_kernel" if f1 else "ell_spmm_kernel",
            "ms": cuda_ms(torch, eops.ell_spmm_cuda, lambda: (ell, xs, op)),
            # (F = 1 only: 50 outputs of F = 128 would hold 26 GB)
            "device_ms": graph_ms(
                torch, lambda: eops.ell_spmm_cuda(ell, xs, op))
            if F == 1 else None,
            "plain_ms": cuda_ms(torch, eops.ell_spmm_ref,
                                lambda: (ell, xs, op)),
            "library_ms": library_ms, "nbytes": nbytes,
            "t_ops_ms": V * D * F / F32_OPS_PER_S * 1e3}


def bound(nbytes, t_ops_ms) -> dict:
    """The least time for the work: bytes over the memory rate or
    operations over their peak rate (``t_ops_ms``), the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops_ms),
            "bound_by": "bytes" if t_bytes >= t_ops_ms else "operations",
            "bytes": nbytes}


def attention_work(B, Sq, Skv, Hq, Hkv, hd, q_offset, valid):
    """The visible (query, key) pairs of one (batch, q-head), the
    operations (a multiply and an add per element of q.k and of p.v) and
    the bf16 bytes (q, k[:valid], v[:valid] read once, out written once)."""
    q_offset = Skv - Sq if q_offset is None else q_offset
    valid = Skv if valid is None else valid
    pairs = sum(max(0, min(valid, q_offset + i + 1)) for i in range(Sq))
    ops = 4 * hd * pairs * B * Hq
    nbytes = 2 * (2 * B * Sq * Hq * hd + 2 * B * valid * Hkv * hd)
    return pairs, ops, nbytes


def check_bf16_attention(torch, got, want, what: str) -> tuple:
    """bf16 attention against the plain version at ``ATTN_BF16_TOL`` and
    ``ATTN_BF16_ROW_REL_L2``; (max abs error, the largest relative L2
    error of an output row: one query, one q-head)."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    rel = float(((got - want).norm(dim=-1)
                 / want.norm(dim=-1).clamp_min(1e-30)).max())
    require(torch.allclose(got, want, atol=ATTN_BF16_TOL, rtol=ATTN_BF16_TOL)
            and rel <= ATTN_BF16_ROW_REL_L2,
            f"{what} disagrees with the plain version in bf16: max abs "
            f"err {err}, max row relative L2 {rel}")
    return err, rel


def attn_counts(LAUNCHES, fops) -> dict:
    """The launches of each ``flash_attention`` route, by route name."""
    return {r: LAUNCHES[f"attn_{r}"] for r in fops.ROUTES}


def attention_inputs(torch, gen, B, Sq, Skv, Hq, Hkv, hd, valid):
    """Seeded bf16 q, k, v; with a ``kv_valid_len`` (``valid``) k and v are
    layer 1 of two-layer (2, B, Skv, Hkv, hd) caches whose keys past it
    are NaN (no arm may read them)."""
    def draw(shape):
        return torch.randn(shape, generator=gen, device="cuda") \
            .to(torch.bfloat16)

    q = draw((B, Sq, Hq, hd))
    if valid is None:
        return q, draw((B, Skv, Hkv, hd)), draw((B, Skv, Hkv, hd))
    ck, cv = draw((2, B, Skv, Hkv, hd)), draw((2, B, Skv, Hkv, hd))
    ck[:, :, valid:] = float("nan")
    cv[:, :, valid:] = float("nan")
    return q, ck[1], cv[1]


def flash_attention_row(torch, lm) -> dict:
    """``flash_attention`` at the ``ATTN_SHAPES`` on seeded random inputs:
    held to its plain version in bf16 and float32, timed beside it,
    ``scaled_dot_product_attention`` and the bound; the row is the
    prefill shape's, with the main path's launches from phase lm."""
    import torch.nn.functional as F
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import ops as fops

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(7)
    shapes = {}
    for name, B, Sq, Skv, Hq, Hkv, hd, q_offset, valid in ATTN_SHAPES:
        vl = Skv if valid is None else valid
        q, k, v = attention_inputs(torch, gen, B, Sq, Skv, Hq, Hkv, hd,
                                   valid)
        kw = {"q_offset": q_offset, "kv_valid_len": valid}

        def kernel(*a):
            return fops.flash_attention_cuda(*a, True, **kw)

        def plain(*a):
            return fops.flash_attention_ref(*a, True, **kw)

        want = plain(q, k, v)
        route, chunk, splits = fops.attention_plan(q, k, v, True, **kw,
                                                   sms=sms)
        require(route == ATTN_ROUTE[name],
                f"flash_attention plans {route} at {name}, not "
                f"{ATTN_ROUTE[name]}")
        before = attn_counts(LAUNCHES, fops)
        got = kernel(q, k, v)
        after = attn_counts(LAUNCHES, fops)
        taken = [r for r in after if after[r] > before[r]]
        require(taken == [route],
                f"flash_attention at {name} took {taken}, not {route}")
        err, rel = check_bf16_attention(torch, got, want,
                                        f"flash_attention at {name}")
        extra = {}
        if route == "splitk":
            # the merge (attn_combine_kernel) against the plain split-K
            # version cut into the kernel's chunks
            sk_err, sk_rel = check_bf16_attention(
                torch, got, fops.flash_attention_splitk_ref(
                    q, k, v, True, chunk=chunk, **kw),
                f"attn_combine_kernel at {name} against "
                f"flash_attention_splitk_ref")
            extra = {"chunk": chunk, "splits": splits,
                      "max_abs_err_vs_splitk_ref": sk_err,
                      "max_row_rel_l2_vs_splitk_ref": sk_rel}
        del got
        f32 = (q.float(), k.float(), v.float())
        got32, want32 = kernel(*f32), plain(*f32)
        err32 = float((got32 - want32).abs().max())
        require(torch.allclose(got32, want32, atol=ATTN_F32_TOL[0],
                               rtol=ATTN_F32_TOL[1]),
                f"flash_attention disagrees with its plain version in "
                f"float32 at {name}: max abs err {err32}")
        del got32, want32
        f32_ms = cuda_ms(torch, kernel, lambda: f32)
        del f32
        # SDPA's causal mask is top-left aligned: causal only where the
        # queries and the valid keys coincide; a decode row sees every
        # valid key, so it is the same function without a mask
        qt, kt, vt = (q.transpose(1, 2), k[:, :vl].transpose(1, 2),
                      v[:, :vl].transpose(1, 2))

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=Sq == vl, enable_gqa=True)

        same = Sq == vl or (Sq == 1 and q_offset + 1 >= vl)
        if same:
            check_bf16_attention(torch, sdpa().transpose(1, 2), want,
                                 f"scaled_dot_product_attention at {name}")
        del want
        extra.update(device_ms=graph_ms(torch, lambda: kernel(q, k, v)),
                     library_device_ms=graph_ms(torch, sdpa),
                     device_ms_launches=ATTN_GRAPH_LAUNCHES)
        pairs, n_ops, nbytes = attention_work(B, Sq, Skv, Hq, Hkv, hd,
                                              q_offset, valid)
        shapes[name] = {
            "shape": {"B": B, "Sq": Sq, "Skv": Skv, "Hq": Hq, "Hkv": Hkv,
                      "hd": hd, "q_offset": Skv - Sq if q_offset is None
                      else q_offset, "kv_valid_len": vl,
                      "cache_layer_slice": valid is not None},
            "max_abs_err": err, "max_row_rel_l2": rel,
            "max_abs_err_f32": err32,
            "ms": cuda_ms(torch, kernel, lambda: (q, k, v)),
            "plain_ms": cuda_ms(torch, plain, lambda: (q, k, v)),
            "library_ms": cuda_ms(torch, sdpa), "f32_ms": f32_ms,
            "library_same_function": same, "pairs_per_head": pairs,
            "ops": n_ops, "route": f"attn_{route}", **extra,
            **bound(nbytes, n_ops / BF16_OPS_PER_S * 1e3)}
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    head = shapes.pop("prefill")
    src, replaces = KERNEL_ROWS["flash_attention"]
    return {"name": "flash_attention", "route": "cuda", "source": src,
            "replaces": replaces, "launches": lm["launches"],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "bytes": head["bytes"],
            "ops": head["ops"], "f32_ms": head["f32_ms"],
            "device_ms": head["device_ms"],
            "library_device_ms": head["library_device_ms"],
            "max_abs_err_f32": head["max_abs_err_f32"],
            "max_row_rel_l2": head["max_row_rel_l2"],
            "tolerance": {"bfloat16": {"atol": ATTN_BF16_TOL,
                                       "rtol": ATTN_BF16_TOL,
                                       "row_rel_l2": ATTN_BF16_ROW_REL_L2},
                          "float32": {"atol": ATTN_F32_TOL[0],
                                      "rtol": ATTN_F32_TOL[1]}},
            "library_call": "torch.nn.functional.scaled_dot_product_attention"
                            " (enable_gqa, is_causal where Sq == Skv; the "
                            "long row attends all keys, unmasked)",
            "launches_from": "phase lm (prefill, decode_step, lm_forward)",
            "launches_per_call": lm["per_call"], "calls": lm["calls"],
            "routes": lm["routes"], "kernel_route": head["route"],
            **shapes}


def overlap_work(torch, a_v, b_v) -> dict:
    """The work ``path_overlap``'s kernel does on these rows
    (``csrc/path_join.cu``): per tile of 32 A rows, the distinct
    non-negative ids (its dictionary, K rounded up to 32 columns) give
    2 * rows * NB * K tensor-core operations; a tile with more than 256
    ids, or every tile where a row is longer than 127, compares instead
    (2 * rows * NB * LA * LB ALU operations)."""
    NA, LA = a_v.shape
    NB, LB = b_v.shape
    tiles = -(-NA // 32)
    x = torch.full((tiles * 32, LA), -1, dtype=torch.int32, device=a_v.device)
    x[:NA] = a_v
    x = torch.where(x < 0, -1, x).view(tiles, 32 * LA).sort(dim=1).values
    distinct = ((x[:, 1:] != x[:, :-1]) & (x[:, 1:] >= 0)).sum(dim=1) \
        + (x[:, 0] >= 0)
    rows = torch.full((tiles,), 32, dtype=torch.int64, device=a_v.device)
    rows[-1] = NA - 32 * (tiles - 1)
    dict_ok = distinct <= 256
    if LA > 127 or LB > 127:
        dict_ok = torch.zeros_like(dict_ok)
    cols = (distinct + 31) // 32 * 32
    return {"dict_tiles": int(dict_ok.sum()),
            "compare_tiles": int((~dict_ok).sum()),
            "mma_ops": 2 * NB * int((rows * cols)[dict_ok].sum()),
            "compare_ops": 2 * NB * LA * LB * int(rows[~dict_ok].sum())}


def phase_kernels(torch, dev_info, peaks, main_rec, launches, share_rec,
                  share_launches, plan_rec, plan_launches, ops,
                  w1_rec, lm, main_index) -> list[dict]:
    from repro_torch.core import enumerate as enum
    from repro_torch.core import join
    from repro_torch.kernels.msbfs_expand import ops as mops
    from repro_torch.kernels.pairwise_popcount import ops as pops
    from repro_torch.kernels.path_join import ops as jops

    clock_hz = dev_info["max_sm_clock_mhz"] * 1e6
    int_rate = INT_PER_CLK_SM * dev_info["sms"] * clock_hz
    rows = []
    # each kernel's launches on the path that runs it
    launches = dict(launches, ell_spmm=plan_launches["ell_spmm"],
                    expand_level=launches["level_fused"],
                    join=launches["join_fused"], **ops["launches"])

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

    # -- msbfs_step: in place on visited/dist, so each run gets copies;
    # the main batch's heaviest level, and the delta sweep's (W = 1). Its
    # device_ms: 50 calls in one CUDA graph, each restoring visited from a
    # saved copy first (dist takes the same bytes again), less 50 copies
    # alone; so also every level of the recorded index build.
    def msbfs_step(rec):
        ell, fr, vis, dist, hop = rec["msbfs_step"].best
        V, D = ell.shape
        W = fr.shape[1]

        def fresh():
            return ell, fr, vis.clone(), dist.clone(), hop

        a, b = fresh(), fresh()
        out_k = mops.msbfs_step_cuda(*a)
        out_p = mops.msbfs_step_ref(*b)
        torch.cuda.synchronize()
        err = max_abs_err(torch, [(out_k, out_p), (a[2], b[2]),
                                  (a[3], b[3])])
        new_bits = popcount_total(torch, out_k)

        def graphed_ms(l_ell, l_fr, l_vis, l_dist, l_hop):
            v2, d2 = l_vis.clone(), l_dist.clone()

            def level():
                v2.copy_(l_vis)
                mops.msbfs_step_cuda(l_ell, l_fr, v2, d2, l_hop)
            copy_ms = graph_ms(torch, lambda: v2.copy_(l_vis))
            return graph_ms(torch, level) - copy_ms, copy_ms

        device_ms, copy_ms = graphed_ms(ell, fr, vis, dist, hop)
        levels = {"hops": [], "device_ms": []}
        for call in rec["msbfs_step"].calls:
            levels["device_ms"].append(graphed_ms(*call)[0])
            levels["hops"].append(call[4])
        levels["sum_device_ms"] = sum(levels["device_ms"])
        return ({"V": V, "D": D, "W": W, "hop": hop}, err,
                cuda_ms(torch, mops.msbfs_step_cuda, fresh),
                cuda_ms(torch, mops.msbfs_step_ref, fresh),
                V * D * 4 + (V + 1) * W * 4 * 2 + V * W * 4 * 2 + new_bits,
                V * W * D / int_rate * 1e3, new_bits,
                {"device_ms": device_ms,
                 "device_ms_launches": ATTN_GRAPH_LAUNCHES,
                 "restore_copy_device_ms": copy_ms,
                 "words_with_new_bits": int(torch.count_nonzero(out_k)),
                 "levels": levels})

    shape2, err2, ms2, plain2, nbytes2, t_ops2, bits2, x2 = \
        msbfs_step(w1_rec)
    require(err2 == 0, "msbfs_step disagrees with its plain version on the "
                       "delta sweep")
    shape, err, ms, plain_ms, nbytes, t_ops, new_bits, x = \
        msbfs_step(main_rec)
    row("msbfs_step", shape, err, ms, plain_ms, nbytes=nbytes,
        t_ops_ms=t_ops, new_bits=new_bits, **x,
        delta_sweep={"shape": shape2, "max_abs_err": err2, "ms": ms2,
                     "plain_ms": plain2, "new_bits": bits2, **x2,
                     **bound(nbytes2, t_ops2)})

    # -- the similarity stage of the main batch under the profiler
    emit({"phase": "similarity_profile",
          **profile_similarity(torch, main_index)})

    # -- gamma_pack: the heaviest call of the main batch (a direction's
    # (n+1, Su) distances); reads the distances once, writes the words
    dist, col, ks, n = main_rec["gamma_pack"].best
    Q, Su = col.shape[0], dist.shape[1]
    k_out = pops.gamma_pack_cuda(dist, col, ks, n)
    p_out = pops.gamma_pack_ref(dist, col, ks, n)
    torch.cuda.synchronize()
    err = max_abs_err(torch, [(k_out, p_out)])
    row("gamma_pack", {"n": n, "Su": Su, "Q": Q}, err,
        cuda_ms(torch, pops.gamma_pack_cuda, lambda: (dist, col, ks, n)),
        cuda_ms(torch, pops.gamma_pack_ref, lambda: (dist, col, ks, n)),
        nbytes=n * Su + Q * 5 + k_out.numel() * 4,
        t_ops_ms=n * Q / int_rate * 1e3,
        device_ms=graph_ms(torch, lambda: pops.gamma_pack_cuda(
            dist, col, ks, n)),
        device_ms_launches=ATTN_GRAPH_LAUNCHES,
        plain="gamma_bits + pack_bits (eager PyTorch): the main path's "
              "packing before this kernel")

    # -- pairwise_popcount: out is symmetric, so the function needs the
    # Q(Q+1)/2 pairs i <= j only. Two units can do that work: the CUDA
    # cores' popc (rate: the larger of the programming guide's and the
    # measured one) and the tensor cores' 1-bit AND+popc MMA (what the
    # kernel uses; measured, no rate is published for the H100). The bound
    # takes the faster. Library calls on the unpacked (Q, 32*W) Γ, each
    # exact (counts below 2**24; bf16 and int8 hold 0 and 1 exactly and
    # accumulate in float32 and int32), each held equal to the kernel;
    # library_ms is the fastest.
    (words,) = main_rec["pairwise_popcount"].best
    Q, W = words.shape
    k_out = pops.pairwise_popcount_cuda(words)
    p_out = pops.intersections(words)
    torch.cuda.synchronize()
    err = max_abs_err(torch, [(k_out, p_out)])
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    gam = mops.unpack_bits(words, W * 32)
    g32, g16, g8 = gam.float(), gam.bfloat16(), gam.to(torch.int8)
    del gam
    library = {
        "float32 gam @ gam.T (TF32 off)": (lambda g: g @ g.T, g32),
        "bf16 torch.mm(gam, gam.T, out_dtype=float32) (reduced-precision "
        "reduction off)": (lambda g: torch.mm(g, g.T,
                                              out_dtype=torch.float32), g16),
        "torch._int_mm(gam, gam.T) on int8": (
            lambda g: torch._int_mm(g, g.T), g8)}
    library_ms = {}
    for name, (fn, g) in library.items():
        require(torch.equal(fn(g).to(torch.int32), k_out),
                f"{name} disagrees with pairwise_popcount")
        library_ms[name] = cuda_ms(torch, fn, lambda g=g: (g,))
    fastest = min(library_ms, key=library_ms.get)
    del g32, g16, g8, library
    pairs = Q * (Q + 1) // 2
    popc_rate = max(POPC_PER_CLK_SM * dev_info["sms"] * clock_hz,
                    peaks["popc_per_s"])
    t_popc = pairs * W / popc_rate * 1e3
    t_b1 = pairs * W * 32 / peaks["b1_bit_pairs_per_s"] * 1e3
    row("pairwise_popcount", {"Q": Q, "W": W}, err,
        cuda_ms(torch, pops.pairwise_popcount_cuda, lambda: (words,)),
        cuda_ms(torch, pops.intersections, lambda: (words,)),
        nbytes=Q * W * 4 + Q * Q * 4, t_ops_ms=min(t_popc, t_b1),
        library_ms=library_ms[fastest], library_call=fastest,
        library_ms_each=library_ms,
        device_ms=graph_ms(torch, lambda: pops.pairwise_popcount_cuda(words)),
        device_ms_launches=ATTN_GRAPH_LAUNCHES,
        ops={"pairs": pairs, "popc": pairs * W, "bit_pairs": pairs * W * 32},
        t_ops_popc_ms=t_popc, t_ops_b1_mma_ms=t_b1,
        popc_per_s=popc_rate, b1_bit_pairs_per_s=peaks["b1_bit_pairs_per_s"])

    # -- path_member / rowwise_overlap on their own: the engine runs them
    # inside its fused level and joins, so their inputs are derived from
    # the heaviest fused calls of the main batch (and, checked and timed
    # as well, of the sharing batch, whose frontiers pass min_cap): a
    # level's prefixes and candidates, a join's gathered half rows
    def path_member(rec):
        args, kw = rec["path_member"].best["args"], rec["path_member"].best["kw"]
        verts = args[0][:, :kw["level"] + 1]
        cand = enum.expand_level_ref(*args, **kw).nbrs
        N, L = verts.shape
        D = cand.shape[1]
        err = max_abs_err(torch, [(jops.path_member_cuda(verts, cand),
                                   jops.path_member_ref(verts, cand))])
        return ({"N": N, "L": L, "D": D}, err,
                cuda_ms(torch, jops.path_member_cuda, lambda: (verts, cand)),
                cuda_ms(torch, jops.path_member_ref, lambda: (verts, cand)),
                N * L * 4 + 2 * N * D * 4, N * D * L / int_rate * 1e3)

    def rowwise_overlap(rec):
        a_v, b_v = join_halves(rec["rowwise_overlap"].best)
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
            inputs_from="the heaviest fused "
                        + ("expand level" if name == "path_member"
                           else "join") + " of the main batch",
            sharing={"launches": share_launches[name], "shape": shape2,
                     "max_abs_err": err2, "ms": ms2, "plain_ms": plain2,
                     **bound(nbytes2, t_ops2)})

    # -- the fused passes themselves, against the plain compositions on
    # the same inputs (every output, bit for bit), timed one call at a time
    # (ms) and as 50 calls in one CUDA graph (device_ms)
    def measure_fused(kernel, plain, args, kw, outputs, nbytes):
        got, want = outputs(kernel(*args, **kw)), outputs(plain(*args, **kw))
        torch.cuda.synchronize()
        return {"max_abs_err": max_abs_err(torch, list(zip(got, want))),
                "ms": cuda_ms(torch, lambda: kernel(*args, **kw)),
                "device_ms": graph_ms(torch, lambda: kernel(*args, **kw)),
                "device_ms_launches": ATTN_GRAPH_LAUNCHES,
                "plain_ms": cuda_ms(torch, lambda: plain(*args, **kw)),
                **bound(nbytes, 0.0)}

    def level_bytes(args, kw):
        """Valid frontier rows and their ELL rows and non-pad candidates'
        prune entries read; nbrs, splice_hit, the frontier and its status
        written."""
        verts, count, ell, prune_tbl, _ = args
        cap, L = verts.shape
        D = ell.shape[1]
        valid = min(int(count), cap)
        nbrs = enum.expand_level_ref(*args, **kw).nbrs[:valid]
        cand = int((nbrs != prune_tbl.shape[0] - 1).sum())
        return (valid * L * 4 + (valid + (valid < cap)) * D * 4 + cand * 2
                + cap * D * 5 + kw["out_cap"] * L * 4 + 16)

    def level_outputs(o):
        return (o.frontier.verts, o.frontier.count, o.frontier.overflow,
                o.nbrs, o.splice_hit)

    def fused_level(rec):
        args, kw = rec.best["args"], rec.best["kw"]
        r = measure_fused(enum.expand_level_cuda, enum.expand_level_ref,
                          args, kw, level_outputs, level_bytes(args, kw))
        r["shape"] = {"cap": args[0].shape[0], "L": args[0].shape[1],
                      "D": args[2].shape[1], "count": int(args[1]),
                      "level": kw["level"], "out_cap": kw["out_cap"]}
        return r

    def join_bytes(rec):
        """The valid pairs' half rows (and a keyed join's bucket starts and
        offsets) read, the assembled rows and the status written."""
        kw = rec["kw"]
        a_v, b_v = join_halves(rec)
        if rec["kind"] == "splice":
            pairs = min(int(rec["args"][1]) * int(rec["args"][3]),
                        kw["out_cap"])
            setup = 0
        else:
            offs = join._pair_setup(rec["args"][0], rec["args"][1],
                                    rec["args"][2], kw["b_col"])[1]
            cap = kw["out_cap" if rec["kind"] == "keyed" else "pair_cap"]
            pairs = min(int(offs[-1]), cap)
            setup = offs.shape[0] * 16
        out = kw["out_cap"] * kw["out_width"] * 4 \
            if rec["kind"] != "keyed_count" else 0
        return pairs * (a_v.shape[1] + b_v.shape[1]) * 4 + setup + out + 16

    joins = {"keyed": (join.keyed_join_cuda, join.keyed_join_ref,
                       lambda o: tuple(o)),
             "keyed_count": (join.keyed_join_count_cuda,
                             join.keyed_join_count_ref, lambda o: tuple(o)),
             "splice": (join.cross_join_cuda, join.cross_join_ref,
                        lambda o: tuple(o))}

    def fused_join(rec, kind):
        kernel, plain, outputs = joins[kind]
        r = measure_fused(kernel, plain, rec["args"], rec["kw"], outputs,
                          join_bytes(dict(rec, kind=kind)))
        if kind != "splice":
            # the memset and the kernel alone, after the pair setup
            kw = rec["kw"]
            a, b_verts, b_count = rec["args"]
            lo, offs = join._pair_setup(a, b_verts, b_count, kw["b_col"])
            r["kernel_device_ms"] = graph_ms(
                torch, lambda: jops.fused_join_cuda(
                    kind, a.verts, b_verts, a_len=kw["a_col"] + 1,
                    b_len=kw["b_col"] + 1, lo=lo, offs=offs,
                    out_cap=kw.get("out_cap", kw.get("pair_cap")),
                    width=kw.get("out_width", 0)))
        a_v, b_v = join_halves(dict(rec, kind=kind))
        r["shape"] = {"pairs": a_v.shape[0], "LA": a_v.shape[1],
                      "LB": b_v.shape[1], **{k: v for k, v in
                                               rec["kw"].items()}}
        return r

    def as_count(rec):
        """A keyed join's inputs as the counting join's."""
        kw = dict(rec["kw"])
        kw["pair_cap"] = kw.pop("out_cap")
        kw.pop("out_width")
        return {"args": rec["args"], "kw": kw}

    level_main = fused_level(main_rec["path_member"])
    level_share = fused_level(share_rec["path_member"])
    # the largest planned capacity of the default configuration's BATCH
    # run (phase planners): most of its rows lie past count
    level_plan = fused_level(plan_rec["level_cap"])
    require(level_share["max_abs_err"] == level_plan["max_abs_err"] == 0,
            "the fused expand level disagrees with its plain version on the "
            "sharing batch")
    row("expand_level", level_main["shape"], level_main["max_abs_err"],
        level_main["ms"], level_main["plain_ms"],
        nbytes=level_main["bytes"], t_ops_ms=0.0,
        device_ms=level_main["device_ms"],
        device_ms_launches=ATTN_GRAPH_LAUNCHES,
        launches_from="LAUNCHES['level_fused'] of the main batch (each also "
                      "a path_member launch)",
        plain="core/enumerate.py expand_level_ref (eager PyTorch)",
        sharing=dict(level_share, launches=share_launches["level_fused"]),
        planned=dict(level_plan, launches=plan_launches["level_fused"]))
    parts = {}
    for batch, jr in (("main", main_rec["rowwise_overlap"].parts),
                      ("sharing", share_rec["rowwise_overlap"].parts),
                      ("planned", plan_rec["join_cap"].parts)):
        if jr["keyed"].best is not None:
            parts[f"{batch}_keyed"] = fused_join(jr["keyed"].best, "keyed")
            parts[f"{batch}_keyed_count"] = fused_join(
                as_count(jr["keyed"].best), "keyed_count")
        if jr["splice"].best is not None:
            parts[f"{batch}_splice"] = fused_join(jr["splice"].best,
                                                  "splice")
    require("main_keyed" in parts and "sharing_splice" in parts,
            f"no keyed join on the main batch or no splice join on the "
            f"sharing batch: {sorted(parts)}")
    require(all(p["max_abs_err"] == 0 for p in parts.values()),
            "a fused join disagrees with its plain version: "
            + str({k: p["max_abs_err"] for k, p in parts.items()}))
    main_keyed = parts.pop("main_keyed")
    row("join", main_keyed["shape"], main_keyed["max_abs_err"],
        main_keyed["ms"], main_keyed["plain_ms"],
        nbytes=main_keyed["bytes"], t_ops_ms=0.0,
        device_ms=main_keyed["device_ms"],
        device_ms_launches=ATTN_GRAPH_LAUNCHES,
        launches_from="LAUNCHES['join_fused'] of the main batch (each also "
                      "a rowwise_overlap launch)",
        plain="core/join.py keyed_join_ref (eager PyTorch, after the same "
              "pair setup); ms and device_ms include the pair setup",
        share_launches=share_launches["join_fused"], **parts)

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
        synthetic.append({"shape": m["shape"], "kernel": m["kernel"],
                          "max_abs_err": m["err"],
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
        kernel=m["kernel"], f1_launches=plan_launches["ell_gather_f1"],
        device_ms=m["device_ms"], device_ms_launches=ATTN_GRAPH_LAUNCHES,
        launches_from="default-config BATCH run of the sharing batch "
                      "(phase planners)",
        nonzero_features=plan_rec["ell_spmm"].best_work,
        synthetic=synthetic)

    # -- msbfs_expand: the ops API's hop on the main batch's heaviest
    # msbfs_step frontier
    ell, fr = main_rec["msbfs_step"].best[:2]
    V, D = ell.shape
    W = fr.shape[1]
    err = max_abs_err(torch, [(mops.msbfs_expand_cuda(ell, fr),
                               mops.msbfs_expand_ref(ell, fr))])
    row("msbfs_expand", {"V": V, "D": D, "W": W}, err,
        cuda_ms(torch, mops.msbfs_expand_cuda, lambda: (ell, fr)),
        cuda_ms(torch, mops.msbfs_expand_ref, lambda: (ell, fr)),
        nbytes=V * D * 4 + (V + 1) * W * 4 * 2,
        t_ops_ms=V * W * D / int_rate * 1e3,
        device_ms=graph_ms(torch, lambda: mops.msbfs_expand_cuda(ell, fr)),
        device_ms_launches=ATTN_GRAPH_LAUNCHES,
        live_entries=int((ell != V).sum()),
        launches_from="phase ops (msbfs_hop_packed)")

    # -- path_overlap: 4096 x 4096 rows of 6, then the splice and keyed
    # joins' half rows, each against its plain version exactly
    def path_overlap(a_v, b_v):
        NA, LA = a_v.shape
        NB, LB = b_v.shape
        err = max_abs_err(torch, [(jops.path_overlap_cuda(a_v, b_v),
                                   jops.path_overlap_ref(a_v, b_v))])
        require(err == 0, f"path_overlap disagrees with its plain version "
                          f"at {(NA, NB, LA, LB)}")
        work = overlap_work(torch, a_v, b_v)
        t_alu = 2 * NA * NB * LA * LB / int_rate * 1e3
        t_ops = (work["mma_ops"] / INT8_OPS_PER_S
                 + work["compare_ops"] / int_rate) * 1e3
        return {"shape": {"NA": NA, "NB": NB, "LA": LA, "LB": LB},
                "max_abs_err": err,
                "ms": cuda_ms(torch, jops.path_overlap_cuda,
                              lambda: (a_v, b_v)),
                "device_ms": graph_ms(
                    torch, lambda: jops.path_overlap_cuda(a_v, b_v)),
                "plain_ms": cuda_ms(torch, jops.path_overlap_ref,
                                    lambda: (a_v, b_v)),
                "nbytes": (NA * LA + NB * LB + NA * NB) * 4,
                "t_ops_ms": t_ops, "alu_bound_ms": t_alu, **work,
                "nonzero": int(torch.count_nonzero(
                    jops.path_overlap_cuda(a_v, b_v)))}

    joins = {}
    for kind in ("splice", "keyed"):
        m = path_overlap(*ops[kind])
        joins[f"{kind}_join"] = dict(
            {k: v for k, v in m.items() if k not in ("nbytes", "t_ops_ms")},
            **bound(m["nbytes"], m["t_ops_ms"]))
    m = path_overlap(ops["a4k"], ops["b4k"])
    row("path_overlap", m["shape"], m["max_abs_err"], m["ms"], m["plain_ms"],
        nbytes=m["nbytes"], t_ops_ms=m["t_ops_ms"],
        device_ms=m["device_ms"], device_ms_launches=ATTN_GRAPH_LAUNCHES,
        alu_bound_ms=m["alu_bound_ms"],
        ops_counted="int8 tensor-core multiply-adds of the count product "
                    "(2 per A row x B row x dictionary column, columns "
                    "rounded up to 32 a tile) at INT8_OPS_PER_S, plus 2 "
                    "per (p, q) pair of overflowed tiles at the ALU rate; "
                    "alu_bound_ms: 2 per (p, q) pair of every output at "
                    "INT_PER_CLK_SM",
        **{k: m[k] for k in ("mma_ops", "compare_ops", "dict_tiles",
                             "compare_tiles", "nonzero")},
        launches_from="phase ops (path_overlap, splice_join_valid, "
                      "keyed_join_valid)", **joins)

    r = flash_attention_row(torch, lm)
    emit({"phase": "kernel", **r})
    rows.append(r)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20,
                    help="graph vertices (default 2**20)")
    ap.add_argument("--queries", type=int, default=256,
                    help="queries in the batch (default 256)")
    ap.add_argument("--sharing-queries", type=int, default=64,
                    help="queries in the sharing batch (default 64)")
    # phase obs runs its compile window and audit in a fresh process
    ap.add_argument("--obs-child", metavar="TRACE", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    if args.obs_child:
        emit(obs_child(args.obs_child))
        return 0

    t_start = time.perf_counter()
    dev_info = phase_device(torch)
    phase_build()
    g, queries = phase_workload(args.n, args.queries)
    session, main_rec, launches, main_report, main_index, main_warm = \
        phase_main(torch, g, queries)
    share_rec, join_rec, share_launches, share_queries, share_report = \
        phase_sharing(torch, g, session, args.sharing_queries)
    phase_obs(torch, g, session, queries, share_queries, main_warm)
    plan_rec, plan_launches, plan_reports = phase_planners(
        torch, g, session, queries, main_report, share_queries, share_report)
    phase_cache(g, share_queries, share_report)
    w1_rec, _, deltas = phase_delta(torch, g, (
        ("sharing", share_queries), ("main", queries),
        ("main, k = 4", [q for q in queries if q[2] == 4])))
    level_1x = phase_streaming(torch, g)
    phase_sharded(torch, g, (queries, main_report, main_warm),
                  (share_queries, plan_reports), deltas, level_1x)
    del level_1x, plan_reports
    ops = phase_ops(torch, g, main_rec, join_rec)
    del g, session, main_report, share_report       # the graph state
    gc.collect()
    torch.cuda.empty_cache()
    lm = phase_lm(torch)
    peaks = phase_peaks(torch, dev_info)
    rows = phase_kernels(torch, dev_info, peaks, main_rec, launches,
                         share_rec, share_launches, plan_rec, plan_launches,
                         ops, w1_rec, lm, main_index)
    emit({"phase": "done", "t_total_s": time.perf_counter() - t_start})
    print(dev_info["nvidia_smi"], flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": dev_info["kind"],
                                 "count": dev_info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
