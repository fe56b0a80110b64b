#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                    # the full workload, one card
    python3 chip_smoke.py --n 65536 --queries 32 --sharing-queries 16
                                             # a quicker, smaller run

Phase 3a drives the paper's engine at billion scale (``path-engine`` at
``batch_1b``: six supersteps of its step bundle, each one ``msbfs_step``
over 1.07 G edges and one fused expand level, in a fresh process);
phases 4 and 5 drive the first slice's path (``plan_caps=False``, BATCH
and BASIC); phase 6 the observability layer (stage spans annotated under
``torch.profiler``, compile telemetry, the launch audit); phases 7 and 8
the engine's default configuration (``EngineConfig()``: walk-count
capacity planning on ``ell_spmm``) under every planner, and the
cross-batch cache; phase 9 incremental graph deltas under both
``delta_backend`` values; phase 10 streaming serving
(``PathSession.submit`` / ``pump`` / ``results`` over the
``StreamingServer``, driven by exp11's open-loop arrival streams); phase
11 sharded execution (four engine replicas on the card, each on its own
CUDA stream); phase 11a the segment index route, edge-sharded over
slots on the card; phase 12 the kernel ops API (``msbfs_hop_packed``,
``path_overlap`` and the join-validity matrices); phase 13 the
transformer's serving path
(granite-8b prefill and KV-cache decode on the ``flash_attention``
kernel, then into a float8 KV cache on its float8 split-K variant);
phase 13c the sharded model code over slots of the card (tensor, FSDP
and sequence splits, prefill and decode with and without
``flash_decode``); phase 14 the MoE FFN on that path (olmoe-1b-7b),
phase 14b its expert-parallel split; phase 14a
moonshot-v1-16b-a3b at full width and depth with a float8 cache; phase
15 LM training (loss, gradients through the ``flash_attention_bwd``
kernel, AdamW, checkpoints and the fault-tolerant driver, under the
``"nothing"`` and ``"dots"`` remat policies); phases 16 and 17 the
GNN zoo and the two-tower recsys model at their published configs
(their paths reach no Pallas kernel: gathers, segmented sums and cuBLAS
matmuls in float32); phases 13b and 17a the substrate's ``shard_map``
programs over slots of the card (``flash_decode`` on the split-K
kernel, ``gnn.ring_aggregate``, ``ef_compressed_psum_axis``).

Phases, each printing one JSON line (``"phase": ...``, with
``t_elapsed_s``, the seconds since the script started):

1. device   -- the card's name and power limit (``nvidia-smi``), torch/CUDA.
2. build    -- compile the CUDA kernels (and the peak-rate probes) from
               ``src/repro_torch/csrc``, one ``nvcc`` per source.
3. workload -- the 2**20-vertex community graph (about 8.4 M edges) and
               256 random (s, t, k) queries, k in 4..6, from fixed seeds.
3a. engine  -- started before phase 3, in a fresh process
               (``--engine-child``: an empty allocator, the card's memory
               to itself) while this one builds the host graph, and
               waited for after it. ``path-engine`` ``CONFIG`` at
               ``batch_1b``, nothing cut: the dry run's estimate of the
               cell (``launch/dryrun.py`` on ``meta``: 61.35 GiB) against
               ``torch.cuda.mem_get_info`` first (too little free memory
               fails the run; the cell is never shrunk). Data from a
               seeded ``torch.Generator`` on the card, in row chunks: a
               (2**26, 64) in-neighbour ELL, each row a Poisson(16) degree
               clipped to 64 and that many uniform in-neighbours (about
               1.07 G edges); 512 distinct sources (dist 127, 0 at each
               source, and their frontier bits); a (2**22 + 1, 64) pruned
               ELL drawn the same way, ``prune_table`` of a seeded slack
               in 0..6 (no splice); 65,536 level-1 paths along pruned
               edges. ``EngineSuperstep.prime`` makes the sentinel
               frontier buffer and the visited words; then six
               supersteps (hop 1..6) of the bundle's step, frontier, dist
               and visited carried, the paths the same each time: per
               superstep the ``msbfs_step`` ms (CUDA events around its
               wrapper) and the expand's, the wall, the new pairs and the
               hop's bound; the peak of ``torch.cuda.max_memory_allocated``
               beside the dry run's estimate. Checks: (a) after each hop,
               on 65,536 seeded vertices and all 512 queries, a BFS
               certificate: dist == hop has an in-neighbour at hop - 1,
               no in-neighbour lies below dist - 1, an unreached entry
               has none at hop - 1 or less, and the frontier's bits are
               dist == hop; and on the same rows the hop's kernel against
               ``msbfs_step_ref`` (their in-neighbours, the whole frontier
               it read, their visited words and dist from before the
               hop): new words, visited words and dist equal exactly, the
               sentinel row 0; (b) the last expand equals
               ``expand_level_ref`` on the same inputs on the card
               (count, no overflow, rows equal as sorted
               rows); (c) a second run from the same seed gives the same
               digests (two int64 sums of the words) of the ELL tables,
               every hop's frontier and the final dist, and the same
               expand rows and counts; and one ``msbfs_step`` and one
               ``level_fused`` launch per superstep (``LAUNCHES``).
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
11a. segment -- the segment index route (``EngineConfig(index_route=
               "segment")``: index, walk counts and delta sweep as
               segmented reductions over the destination-sorted edge
               lists) on ``mesh=["cuda:0"] * 4``, on ``["cuda:0"] * 3``
               (the lists cut into one slice a slot, each reduced on its
               slot's stream) and on one slot, each at ``edge_chunk``
               2**22 and 2**20, on the main and the sharing batch, held
               to the default engine (``EngineConfig()``, the ELL route):
               ``dist_s`` and ``dist_t`` equal bit for bit on every
               configuration. The sharing batch runs on all six: the
               planned capacities equal (every ``_plan_caps`` call of
               the run planned again by the ELL engine), every query's
               path set equal to phase 7's; no ``msbfs_step`` or
               ``ell_spmm`` launch, the fused level and join and the
               similarity kernels launched. The main batch runs so, its
               path sets equal to phase 4's, on the configurations of
               ``SEGMENT_MAIN_RUNS`` (four slots at 2**22, three at
               2**20; the script's time limit); on the other four each
               of the first run's 512 planning calls is planned again on
               that configuration's lists and must give the ELL route's
               capacities (with equal distances and capacities, the
               enumeration is the same). It prints ``t_build_index``
               (CUDA events around ``_build_index``, and the run's stage)
               for each route and configuration and one hop's device
               time (median of ``SEGMENT_HOP_REPS``). Then four-slot
               engines of both routes with 256 MB caches and
               ``delta_backend="msbfs"`` side by side on the sharing
               batch: a near delta (an edge of a returned path) and a
               cap-crossing one (phase 9's): the distance sweeps equal,
               ``cache_kept`` / ``cache_evicted`` equal, the index view
               recut, the next batch's path sets equal.
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
               on the float32 route). Then the same model decodes again
               into a float8 cache of 544 (``RunOptions(kv_cache_dtype=
               "f8")``; 512 teacher-forced + 32 greedy steps): per-step
               latency and tokens/s beside the bf16 cache's, the cache's
               bytes (half), and the logits' divergence from the bf16
               cache's over the 512 teacher-forced positions (median
               relative L2, argmax agreement: a finding, no bound).
               Checks: every step launches ``attn_splitk_f8`` once per
               layer and nothing else; on every greedy step each layer's
               attention output equals the plain float8 version on the
               same q and cache at atol = rtol = 1e-2 elementwise and a
               relative L2 error of at most 1e-2 in every row (one query,
               one q-head); every logit finite.
13b. mesh_decode -- inside phase 13, on its weights (``LM.with_mesh``):
               granite-8b's ``RunOptions(flash_decode=True)`` over slots
               of the card (``make_host_mesh``, ``cuda:0`` repeated, each
               slot on its own stream): ``long_500k`` whole (B 1, 524,288
               keys, a float8 cache of 38.7 GB, stored wide: the sequence
               over all eight slots of a (1, 8) layout) and
               ``decode_32k``'s 32,768 keys at B 4 (batch 128 -> 4; a
               bf16 cache of 19.3 GB over (2, 4): batch over ``data``,
               the sequence over ``model``). Free memory for the cache
               plus 8 GiB is required first (the case is never shrunk).
               The cache, filled with seeded random keys and values
               (quantised as ``decode_step`` quantises) below position
               p0 = the last slot's first position - 2, is cut by
               ``shard_cache`` into views of one tensor; 4 teacher-forced
               steps from p0 (the last slot empty, then written), each
               timed (wall, host clock, synced; the bound: the valid
               keys' bytes and the weights' bytes over 3.35 TB/s), then
               the one-slot ``flash_decode`` and the default decode
               (``gqa_attention``) over the same cache state; the last
               step of each again under a card-only profiler (attention
               kernels' device time summed over the slots' streams, all
               device time). Checks: every
               sharded step launches ``attn_splitk_f8`` (``attn_splitk``)
               once a slot and layer and no other route; each slot's
               partial (float32 out and lse) equals the plain version
               (``flash_attention_ref``) on its piece, and each layer's
               merged attention the plain version over the whole cache
               on the same q, at row 8's bf16 tolerance (atol = rtol =
               1e-2, a row's relative L2 at most 1e-2; an empty slot
               zeros and -inf on both sides); the logits within 0.1
               relative L2 a row of the one-slot and the default
               decode's (two bf16 decodes that round p differently,
               carried through 36 layers: 4.2-5.6% measured); every
               logit finite. The sharded model cuts its weights over the
               slots too (``serve_param_sharding="2d"``).
13c. mesh_serve -- inside phase 13, on its bf16 weights (``LM.with_mesh``,
               ``cuda:0`` repeated): granite-8b's sharded serving, the
               parameters cut by ``lm_param_logical`` (heads, FFN
               columns, vocab over ``model``; rows over ``data`` under
               ``"2d"``, gathered a layer at a time). (A) (2, 4) under
               ``"2d"`` with ``seq_parallel``: prefill of phase 13's
               4 x 2048 prompt, then 8 teacher-forced steps at B 4 from
               position 512 of a cache of 544 (keys and values below it
               seeded random, a copy for each side) with ``flash_decode``
               and 8 without (each slot gathers its KV heads of the cut
               cache); (B) (1, 8) under ``"tp_only"``: one prefill and 8
               gathered steps; (C) a float32 copy of the first 2 layers
               at full width (TF32 off) on (2, 4): a 512-token prefill
               and both decodes. Reported per case: walls (host clock,
               synced) beside the one-device model's, launches a slot
               and layer by route, one prefill and one step under a
               card-only profiler (attention kernels' device time summed
               over the slots' streams). Checks: every slot launches
               ``flash_attention`` once a layer and call, ``attn_wgmma``
               in prefill and ``attn_splitk`` in decode (C: ``attn_scalar``)
               and no other route; on one prefill and one decode step
               each slot's attention at every layer (under
               ``flash_decode`` each partial and each layer's merge)
               equals ``flash_attention_ref`` on the same q, K and V at
               row 8's bf16 tolerance; A's and B's logits within 0.1
               relative L2 a row of the one-device prefill's and
               decode's, C's within 1e-4; every logit finite.
14. moe     -- olmoe-1b-7b ``CONFIG`` (arXiv:2409.02060: 16 layers,
               d_model 2048, 64 experts top-8 of d_ff 1024, vocab 50304:
               6.9 G parameters) at full width in bf16, cut to 4 of its
               16 layers (since phase ``moonshot`` runs the same MoE
               serving path at full depth, to keep the script within its
               time limit: 1.89 G parameters), random
               from seed 0, served as phase ``lm`` serves granite-8b:
               prefill 4 x 2048 twice (the first, cold, reports each MoE
               layer's share of dropped assignments at the default 16
               dispatch groups), 512 teacher-forced and 32 greedy decode
               steps into a 544-slot cache. Checks: each greedy step's
               MoE layers equal ``moe_ffn_dense_ref`` on their input
               (a decode group holds one token, so nothing is dropped) at
               a row relative L2 error of at most 3e-2, on the tokens
               whose top-8 experts are the same under the layer's bf16
               router logits and the oracle's float32 ones (the others,
               near ties, are counted: at most 20%); the teacher-forced
               decode logits against ``lm_forward`` + unembed over the
               same 512 tokens (one token a dispatch group, as at
               decode): in bf16 at 4 layers a median relative L2 of at
               most 5e-2, at most 15% of positions above it and at least
               90% of positions with the same argmax token (the max
               reported: a near tie flips an expert where the two paths'
               hidden states differ in the last bit), and in float32 at
               full width and 4 layers at
               atol = rtol = 2e-3 (phase ``lm``'s check (a)); every logit
               finite; ``flash_attention`` launched once per layer per
               call, on wgmma for prefill and forward and split-K for
               decode (the float32 check on its float32 route).
14b. moe_mesh -- inside phase 14, on its bf16 weights: the 4 layers over a
               (2, 4) layout of the card, expert-parallel (16 of the 64
               experts a slot, the dispatch in 2 groups, the expert
               outputs gathered over ``model`` before the combine), one
               prefill of phase 14's prompt. Checks: every layer's
               routing (the slots of a data row alike, their groups
               together) equal to the one-device ``moe_route`` at 2
               groups on the same tokens exactly; the logits within 5e-2
               relative L2 a row of the one-device prefill at 2 groups;
               one ``attn_wgmma`` a slot and layer; every logit finite.
14a. moonshot -- moonshot-v1-16b-a3b ``CONFIG`` (48 layers, d_model 2048,
               16 q- and 16 kv-heads, hd 128, 64 experts top-6 of d_ff
               1408, vocab 163,840: 28.1 G parameters, 56.2 GB in bf16)
               at full width and depth, drawn on the card from seed 0
               one layer at a time (no float32 copy of the model), after
               the earlier phases' state is freed; the phase first
               requires the parameters, its float8 cache and 6 GiB of
               headroom free (``torch.cuda.mem_get_info``) and fails with
               a message otherwise (it is never cut or skipped). Prefill
               4 x 2048 cold and warm; 128 teacher-forced and 32 greedy
               decode steps into a float8 cache of 160. Checks: phase
               ``moe``'s MoE check on every greedy step (its routing-flip
               count and bound), phase ``lm``'s per-layer float8
               attention check, every logit finite, one
               ``flash_attention`` launch a layer a call: wgmma for
               prefill, ``attn_splitk_f8`` for each decode step; the
               peak of ``torch.cuda.max_memory_allocated``.
15. train   -- LM training on the card. granite-8b ``CONFIG`` at full
               width cut to 4 of its 36 layers, ``train_4k`` cut to 2 x
               4096 tokens (about 130 GB of float32 masters, gradients
               and AdamW moments for the whole model; 20 GB for the cut),
               ``remat=True``, float32 masters cast to bf16 at use:
               three AdamW steps of the train step itself (step wall,
               tokens/s, peak memory). The same steps run again under
               ``remat_policy="dots"`` (the matmul outputs kept): losses
               and grad norms within 1e-6 relative of the ``"nothing"``
               run's, the same launches, step walls and peak memory
               beside it. Then a ``TrainDriver`` run that checkpoints
               after two steps and crashes at the third
               (``FailureInjector``), and a resume from that checkpoint
               whose step equals the uninterrupted run's (loss and grad
               norm, exactly) and whose parameters and AdamW state after
               it equal the uninterrupted run's bit for bit. Then
               olmoe-1b-7b at full width, 2 of its 16 layers, for two
               steps (the MoE backward). Checks: (a) at the step's
               attention shape (Hq 32, Hkv 8, hd 128, causal, S 4096,
               bf16), at that shape with hd 96 (bf16) and at a float32
               shape (1 x 1024), the forward's
               lse-writing instance (the one training runs) gives the
               serving instance's output bit for bit, the plain version's
               output at the kernels row's tolerance and its lse at 1e-3
               (bf16) / 1e-4 (float32); the attention backward kernel's
               dQ, dK and dV against ``flash_attention_bwd_ref`` fed the
               plain lse (bf16: within 2e-2 of each gradient's largest
               magnitude and 2e-2 relative L2 in every row; float32:
               1e-4), and a second launch on the same inputs equal to
               the first bit for bit (bf16 at hd 128 on its wgmma route,
               at hd 96 on its mma.sync one, float32 on the CUDA-core
               one);
               (b) every loss and grad norm finite, and the loss of a
               repeated batch falls over two more steps on it from the
               resumed state (the schedule continued); (c) per layer and
               step, two
               ``flash_attention`` launches on wgmma (forward and remat
               recompute) and one ``flash_attention_bwd`` on its wgmma
               route (``bwd_wgmma``), for granite-8b and for olmoe-1b-7b;
               (d) one granite-8b layer
               at full width in float32 (TF32 off, remat, 1 x 4096
               tokens): the loss, the gradient norm and every parameter's
               gradient through the kernels (forward twice on the float32
               route, backward once) against autograd through
               ``flash_attention_ref``, the rest of the model the same,
               at 1e-4 relative (each gradient: of its largest magnitude).
16. gnn     -- the GNN zoo at each arch's published ``CONFIG``, float32
               (TF32 off), weights drawn on the card from a seeded
               ``torch.Generator`` with the JAX init law. Three AdamW steps
               on one batch through each arch's own bundle
               (``build_bundle(arch, shape).step_fn``): graphcast (16
               layers, d 512) and meshgraphnet (15 layers, d 128) on
               ``full_graph_sm`` (the launcher's graph
               ``generators.powerlaw(2708, 4.0, seed=0)``, padded to 3,072
               nodes / 10,752 edges), schnet (3 interactions, d 64, rbf
               300) on ``molecule`` (128 x 30 atoms x 64 edges),
               graphsage-reddit (2 layers, d 128, mean) on
               ``minibatch_lg`` (1,024 roots, fanout (15, 10), d_feat 602,
               over ``powerlaw(232965, 4.0)``: the Reddit graph's 114.6 M
               edges cut to 0.93 M). Then graphsage-reddit's forward under
               ``no_grad`` on ``ogb_products`` (2,449,029 nodes, d_feat
               100; the powerlaw law drawn on the card at the published
               61,859,140 edge draws, self loops and repeats dropped, in
               61,859,328 edge slots), and at that size the cost of the
               fixed order of summation: the edge sort, and layer 1's
               segmented sum beside one atomic ``index_add_`` of the same
               rows (each train case also times its step's sorts,
               ``order_ms``). Checks: (a) each arch at full width
               cut to 2 layers: the card's forward, loss and gradient norm
               equal the port's CPU run from the same weights and batch at
               rtol = atol = 1e-4; (b) every loss and gradient norm
               finite, and the loss of the repeated batch falls over the
               three steps; (c) the ``ogb_products`` output rows of 64
               seeded nodes equal a CPU forward on their 2-hop in-ball at
               1e-4; (d) meshgraphnet under ``TrainDriver`` checkpoints
               after two steps and crashes at the third, and the resumed
               step equals the uninterrupted one exactly (loss and
               gradient norm). MGN, GraphCast and SchNet at
               ``ogb_products`` need 95-127 GB of edge tensors and wait for
               the mesh options.
17. recsys  -- two-tower-retrieval ``CONFIG`` (embed 256, towers
               1024-512-256, 5,242,880 x 256 user and 2,097,152 x 256 item
               tables: 7.52 GB float32), random from seed 0 on the card.
               ``serve_p99`` (B 512) and ``serve_bulk`` (B 262,144)
               through the serve bundle and ``retrieval_cand`` (1 query
               against 1,000,000 candidates padded to 1,000,448 with -1
               ids, top 100) through the retrieval bundle, cold once and
               warm twice; three AdamW steps of ``train_batch`` cut to B
               32,768 (at 65,536 the (B, B) logits, their log-softmax and
               its gradient are about 52 GB beside the 30.1 GB of tables,
               gradients and moments). Checks: (a) the card's scores
               against the CPU towers (only the table rows used copied
               over) at 1e-4 on the serve batch and on 65,536 seeded
               candidates; (b) the top-100 ids equal a stable descending
               sort of the card's own scores, no padded id among them; (c)
               every loss finite, and the loss of the repeated batch falls.
17a. mesh   -- the substrate's other programs over slots of the card.
               ``gnn.ring_aggregate`` at ``ogb_products`` (2,449,029
               nodes, 61,859,140 edge draws of phase 16's law drawn on
               the card, d_feat 100) over 8 and 3 ``cuda:0`` slots: the
               edges bucketed by (destination owner, source owner), each
               round's CUDA-event time and the bytes rotated (N F 4 a
               round); integer-valued float32 features equal to the
               one-slot ``models/segment.py`` sum bit for bit on every
               row, seeded normal ones within 1e-4 of each output's sum
               of absolute messages. ``ef_compressed_psum_axis`` over an
               8-slot ``pod`` axis: 20 steps of seeded gradient leaves of
               granite-8b's ``w_gate`` shape (4,096 x 14,336), each
               step's reduced tensor and errors equal to the sequence
               form's bit for bit, and sent + final errors = the
               gradients at rtol 1e-4, atol 1e-3.
18. peaks   -- measured peak rates of 32-bit ``popc`` on the CUDA cores
               and of the tensor cores' 1-bit AND+popc MMA (no published
               H100 rate exists for either), used in the popcount bound.
19. kernels -- first a card-only ``torch.profiler`` window over one
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
               build (``levels``: per hop and summed), and at the
               engine's word width (W = 16: the third level from 512
               sources on a 2**20-vertex graph of phase ``engine``'s
               law, ``engine_width``); its row also carries phase
               ``engine``'s launches and per-superstep ms at V = 2**26
               (``engine_batch_1b``), as ``expand_level``'s does.
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
               every output for comparison. ``flash_attention_bwd`` (no
               TPU counterpart) at the training step's shape, beside its
               plain version, the backward of
               ``scaled_dot_product_attention`` and a bound of 10 hd
               operations per visible pair at the bf16 peak. Row 8',
               ``flash_attention_f8``: the split-K kernel over a float8
               cache (``attn_splitk_f8``) at granite-8b's decode, 4 x 1
               over 544 keys and over 32,768 (``decode_32k``'s cache,
               batch 128 -> 4), and at moonshot's (G 1: Hq = Hkv = 16)
               over 160 keys, each shape's plan (chunk, splits, ring
               stages, warps) printed on a line of its own, held to its
               plain version at the bf16
               tolerance and bit for bit to the bf16 split-K route on the
               cache's dequantised bf16 copy; at 544 keys a float32 q
               over the same cache too (``attn_scalar`` on the float32
               copies, p rounded to bf16 against each row's max: its
               relative L2 error from the plain version at most 0.3 of
               the error of leaving p unrounded, and within 1e-2
               elementwise); ``device_ms`` beside the bf16 route's
               (row 8's decode at 32,768 keys), the byte bound with k
               and v at one byte, and
               SDPA on the bf16 copy as the library time (SDPA reads no
               float8); its launches are phase ``lm``'s float8 decode's
               and phase ``mesh_decode``'s ``long_500k`` steps' (row 8's
               add its ``decode_32k`` steps').

Then a ``{"kernels": [...]}`` line (thirteen rows), and last
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
import types

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
# phase segment: the segment index route on one slot and edge-sharded
# over slots on the one card, at the default chunk and a smaller one
SEGMENT_MESHES = ((4, ["cuda:0"] * 4), (3, ["cuda:0"] * 3), (1, None))
SEGMENT_CHUNKS = (1 << 22, 1 << 20)
# (slots, edge_chunk) on which the main batch runs through the engine (its
# path sets checked; host detection takes 8-20 s a run beside an H100
# 80GB HBM3); the others plan its first run's capacity calls again
SEGMENT_MAIN_RUNS = ((4, 1 << 22), (3, 1 << 20))
SEGMENT_HOP_REPS = 3          # timed hops a configuration (median)
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
# row 8': the split-K kernel over a float8 KV cache (route splitk_f8) at
# granite-8b's decode shape over 544 keys and over decode_32k's cache
# length (batch cut from 128 to 4), and at moonshot-v1-16b-a3b's (G 1)
# over its phase's 160 keys: (name, B, Sq, Skv, Hq, Hkv, hd, q_offset,
# kv_valid_len), k and v layer 1 of a two-layer float8 cache
ATTN_F8_SHAPES = (("decode", 4, 1, 544, 32, 8, 128, 543, 544),
                  ("decode_32k", 4, 1, 32768, 32, 8, 128, 32767, 32768),
                  ("decode_moonshot", 4, 1, 160, 16, 16, 128, 159, 160))
# and at "decode" a float32 q over the same cache (the float32 copies on
# attn_scalar, p rounded to bf16 against each row's max as the plain
# version does): the whole output's relative L2 error from the plain
# version at most this share of the error of leaving p unrounded (a
# score's last bit, summed in another order, can move p across a bf16
# rounding boundary, so no elementwise float32 tolerance holds)
ATTN_F8_F32_SHARE = 0.3
# phase moonshot: moonshot-v1-16b-a3b at full width and depth in bf16,
# prefill_32k cut to LM_BATCH x LM_PROMPT, a float8 cache of 160 slots:
# 128 teacher-forced and 32 greedy decode steps; its need on the card is
# the parameters and the cache plus MOONSHOT_HEADROOM (the prefill's
# activations and the dense MoE oracle's float32 experts, under 3 GiB)
MOONSHOT_ARCH = "moonshot-v1-16b-a3b"
MOONSHOT_TEACHER, MOONSHOT_GREEDY = 128, 32
MOONSHOT_HEADROOM = 6 << 30
# phase train: the "dots" remat policy's losses and grad norms against
# the "nothing" policy's, relative
TRAIN_DOTS_REL = 1e-6
# phase mesh_decode: granite-8b's flash_decode over slots of the card, on
# phase lm's weights: (name, batch, cache length, layout (data, model),
# KV cache type): long_500k whole (B 1, 524,288 keys; 38.7 GB, so float8)
# over eight slots, and decode_32k's 32,768 keys at B 4 (cut from 128:
# 19.3 GB of bf16 cache) over (2, 4). Each case runs MESH_DECODE_STEPS
# teacher-forced steps from MESH_DECODE_BEFORE positions below the last
# slot's first (positions before it filled with seeded random keys and
# values; 8 steps from 4 below until the slots cut the weights too,
# then 4 from 2 below for the script's time limit: the steps still cross
# into the last slot). Each slot's partial (out, lse) and each layer's merged
# attention are held to the plain version (flash_attention_ref) on the
# same q and keys at row 8's bf16 tolerance (ATTN_BF16_TOL elementwise,
# ATTN_BF16_ROW_REL_L2 a row). Each step's logits are held to the
# one-slot flash_decode's and to the default decode's (gqa_attention,
# flash_decode off) over the same cache state at MESH_DECODE_REL_L2 a
# row: the decodes round p to bf16 against different running maxima, so
# their layers' outputs differ by about 0.4% of a row, and 36 random
# layers carry that to 4.2-5.6% of the logits' L2 (PERF.md, PR 29; row
# 8's 1e-2 holds a layer, not the logits). Free memory for the cache and
# MESH_HEADROOM (the plain version's float32 copies of a layer's keys and
# values: 3.8 GB at 458,756 float8 keys) is required first (the case is
# never shrunk)
MESH_DECODE_CASES = (("long_500k", 1, 524288, (1, 8), "f8"),
                     ("decode_32k", 4, 32768, (2, 4), "bf16"))
MESH_DECODE_STEPS, MESH_DECODE_BEFORE = 4, 2
MESH_DECODE_REL_L2 = 0.1
MESH_HEADROOM = 8 << 30
# phase mesh: gnn.ring_aggregate at ogb_products (phase gnn's graph law,
# drawn on the card) over 8 and 3 slots of the card, integer-valued
# features against the one-slot segmented sum exactly, normal ones within
# MESH_RING_REL of each output's sum of absolute messages (float32 sums
# in another order); ef_compressed_psum_axis over an 8-slot "pod" axis,
# MESH_EF_STEPS steps of granite-8b's w_gate leaf, each equal to the
# sequence form bit for bit, and the error feedback's invariant (sent +
# final errors = the gradients) at the JAX test's rtol 1e-4, atol 1e-3
MESH_RING_SLOTS = (8, 3)
MESH_RING_REL = 1e-4
MESH_EF_SLOTS, MESH_EF_STEPS = 8, 20
MESH_EF_SHAPE = (4096, 14336)


# phase mesh_serve (13c): granite-8b's sharded serving over slots of the
# card, on phase lm's bf16 weights (LM.with_mesh): (name, layout (data,
# model), serve_param_sharding, flash_decode sides). Case A prefills phase
# lm's prompt (4 x 2048, seq_parallel on), then runs MESH_SERVE_STEPS
# teacher-forced steps from position MESH_SERVE_P0 of a cache of
# MESH_SERVE_CACHE at batch 4 (positions below it seeded random keys and
# values, copied for each side) with flash_decode and as many without;
# case B (tp_only) one prefill and the gathered decode. Their logits are
# held to the one-device prefill's and decode's over the same inputs at
# MESH_SERVE_REL_L2 a row (phase mesh_decode's MESH_DECODE_REL_L2: 36
# random bf16 layers carry a layer's rounding to about 5% of the logits).
# Case C: a float32 copy of the first MESH_SERVE_F32_LAYERS layers (TF32
# off) on case A's layout, a MESH_SERVE_F32_PROMPT prefill and the steps,
# within MESH_SERVE_F32_REL_L2 of the one-device float32 model. On one
# prefill and one decode step of each side each slot's attention (layer
# 0's, the first call a slot) is held to flash_attention_ref on its q, K
# and V at row 8's bf16 tolerance.
MESH_SERVE_CASES = (("A", (2, 4), "2d", (True, False)),
                    ("B", (1, 8), "tp_only", (False,)))
MESH_SERVE_CACHE, MESH_SERVE_P0, MESH_SERVE_STEPS = 544, 512, 8
MESH_SERVE_REL_L2 = 0.1
MESH_SERVE_F32_LAYERS, MESH_SERVE_F32_PROMPT = 2, 512
MESH_SERVE_F32_REL_L2 = 1e-4
# phase moe_mesh (14b): olmoe-1b-7b's MOE_LAYERS layers over a (2, 4)
# layout (16 of the 64 experts a slot, the dispatch in 2 groups), one
# prefill on phase moe's prompt: every layer's routing equal to the
# one-device moe_route at 2 groups on the same tokens exactly, the logits
# within LM_BF16_REL_L2 a row of the one-device prefill at 2 groups
MOE_MESH_LAYOUT = (2, 4)


STAT_KEYS = ("t_build_index", "t_cluster", "t_detect", "t_enumerate",
             "t_wall_s")


class SmokeFailure(RuntimeError):
    pass


# the script's start, for each phase line's ``t_elapsed_s``
T_START = time.perf_counter()


def emit(obj: dict) -> None:
    if "phase" in obj:
        obj = {**obj, "t_elapsed_s": time.perf_counter() - T_START}
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


# ----------------------------------------------------------------------
# phase engine: the paper's engine at billion scale, in a fresh process
# ----------------------------------------------------------------------

ENGINE_ARCH, ENGINE_SHAPE = "path-engine", "batch_1b"
ENGINE_SEED = 0
ENGINE_ROWS = 1 << 20          # ELL rows drawn a pass
ENGINE_PATHS = 65536           # level-1 paths every superstep expands
ENGINE_SAMPLE = 65536          # vertices of the BFS certificate
ENGINE_CERT_ROWS = 2048        # certificate vertices a gather
# headroom over the dry run's peak for the build's, the certificate's and
# the digests' temporaries
ENGINE_HEADROOM = 2 << 30
ENGINE_DIGEST_WORDS = 1 << 25  # int64 words a digest pass
ENGINE_TIMEOUT_S = 400


def engine_ell(torch, n: int, rows: int, cap: int, avg_deg: float, gen):
    """A (rows, cap) int32 in-neighbour table over ``n`` vertices (pad
    ``n``): each of the first ``n`` rows a Poisson(avg_deg) degree clipped
    to ``cap`` and that many uniform in-neighbours, drawn on the card
    ENGINE_ROWS rows at a time; rows past ``n`` all pads. Returns the table
    and its edge count (a 0-d tensor on the card)."""
    ell = torch.full((rows, cap), n, dtype=torch.int32, device="cuda")
    cols = torch.arange(cap, device="cuda", dtype=torch.int32)
    edges = torch.zeros((), dtype=torch.int64, device="cuda")
    for r0 in range(0, n, ENGINE_ROWS):
        r = min(ENGINE_ROWS, n - r0)
        deg = torch.poisson(torch.full((r,), float(avg_deg), device="cuda"),
                            generator=gen).clamp_(max=cap).to(torch.int32)
        nb = torch.randint(0, n, (r, cap), generator=gen, device="cuda",
                           dtype=torch.int32)
        ell[r0:r0 + r] = torch.where(cols < deg[:, None], nb, n)
        edges += deg.sum()
    return ell, edges


def engine_sources(torch, d: dict, gen):
    """Q distinct seeded sources: dist (V, Q) int8, 127 with 0 at each
    query's source, and the (V, W) int32 frontier of their bits."""
    from repro_torch.kernels.msbfs_expand.ops import wrap_int32
    V, Q, W = d["V"], d["Q"], d["W"]
    sources = torch.randperm(V, generator=gen, device="cuda")[:Q]
    q = torch.arange(Q, device="cuda")
    dist = torch.full((V, Q), 127, dtype=torch.int8, device="cuda")
    dist[sources, q] = 0
    frontier = torch.zeros((V, W), dtype=torch.int32, device="cuda")
    # one (row, word) pair a query: the sources are distinct
    frontier[sources, q // 32] = wrap_int32(
        torch.ones_like(q) << (q % 32).to(torch.int64))
    return dist, frontier


def engine_paths(torch, d: dict, pruned, n_paths: int, gen):
    """``n_paths`` level-1 paths (u, v) along edges of the pruned table
    (v a non-pad entry of u's row, v != u) in the (out_cap, width) int32
    buffer, -1 elsewhere; and their count (0-d int64)."""
    Vp, cap = d["Vp"], d["cap"]
    u = torch.randint(0, Vp, (8 * n_paths,), generator=gen, device="cuda")
    j = torch.randint(0, cap, (8 * n_paths,), generator=gen, device="cuda")
    v = pruned[u, j].long()
    keep = torch.nonzero((v != Vp) & (v != u)).squeeze(1)[:n_paths]
    require(keep.numel() == n_paths, f"only {keep.numel()} level-1 paths "
                                     f"drawn of {n_paths}")
    paths = torch.full((d["out_cap"], d["width"]), -1, dtype=torch.int32,
                       device="cuda")
    paths[:n_paths, 0] = u[keep].to(torch.int32)
    paths[:n_paths, 1] = v[keep].to(torch.int32)
    return paths, torch.tensor(n_paths, dtype=torch.int64, device="cuda")


def digest(torch, x) -> list:
    """Two wrapping int64 sums of ``x``'s bytes read as int64 words, plain
    and position-weighted, ENGINE_DIGEST_WORDS words a pass: equal digests
    of two runs stand for equal bits."""
    flat = x.contiguous().view(-1).view(torch.uint8)
    require(flat.numel() % 8 == 0, f"digest of {flat.numel()} bytes")
    words = flat.view(torch.int64)
    s1 = torch.zeros((), dtype=torch.int64, device=x.device)
    s2 = torch.zeros((), dtype=torch.int64, device=x.device)
    for c0 in range(0, words.numel(), ENGINE_DIGEST_WORDS):
        c = words[c0:c0 + ENGINE_DIGEST_WORDS]
        pos = torch.arange(c0, c0 + c.numel(), device=x.device)
        s1 += c.sum()
        s2 += (c * (pos * 2654435761 % 2147483647 + 1)).sum()
    return [int(s1), int(s2)]


def set_bits(torch, words) -> int:
    """Set bits of int32 words, ENGINE_ROWS rows a pass."""
    return sum(int(popcount_words(torch, words[r0:r0 + ENGINE_ROWS]))
               for r0 in range(0, words.shape[0], ENGINE_ROWS))


def sorted_rows(torch, x):
    """The rows of ``x`` in lexicographic order (stable sorts, last column
    first)."""
    for c in reversed(range(x.shape[1])):
        x = x[torch.sort(x[:, c], stable=True).indices]
    return x


def bfs_certificate(torch, ell, dist, frontier, sample, hop: int) -> dict:
    """Check (a) after ``hop`` on the ``sample`` vertices, all queries:
    dist == hop has an in-neighbour at hop - 1; no in-neighbour lies below
    dist - 1; dist == 127 has no in-neighbour at hop - 1 or less; the
    frontier's bits are dist == hop. Returns the violations of each rule
    (0 everywhere on a correct BFS) and the sampled pairs reached."""
    from repro_torch.kernels.msbfs_expand.ops import unpack_bits
    V, Q = dist.shape
    bad = {"no_parent": 0, "parent_too_near": 0, "unreached_has_parent": 0,
           "frontier_bits": 0}
    reached = 0
    for c0 in range(0, sample.numel(), ENGINE_CERT_ROWS):
        vs = sample[c0:c0 + ENGINE_CERT_ROWS]
        nb = ell[vs].long()                                   # (c, cap)
        nd = dist[nb.clamp(max=V - 1)].to(torch.int32)        # (c, cap, Q)
        nd = torch.where((nb != V)[..., None], nd, 127)
        low = nd.amin(dim=1)                                  # (c, Q)
        dv = dist[vs].to(torch.int32)
        got = dv < 127
        bad["no_parent"] += int(((dv == hop) & (low != hop - 1)).sum())
        bad["parent_too_near"] += int((got & (low < dv - 1)).sum())
        bad["unreached_has_parent"] += int((~got & (low <= hop - 1)).sum())
        bad["frontier_bits"] += int(
            (unpack_bits(frontier[vs], Q) != (dv == hop)).sum())
        reached += int(got.sum())
    return {"violations": bad, "sample_pairs_reached": reached}


def hop_against_plain(torch, ell, sample, hop: int, fr_in, vis_in, dist_in,
                      fr_out, vis, dist) -> dict:
    """The hop's kernel against ``msbfs_step_ref`` on the ``sample`` rows:
    the plain version takes those rows' in-neighbours, the whole frontier
    the kernel read (``fr_in``, (V+1, W)) and the rows' visited words and
    distances from before the hop (``vis_in``, ``dist_in``); its new
    words, visited words and distances must equal the kernel's on those
    rows exactly, and the kernel's sentinel row must stay 0."""
    from repro_torch.kernels.msbfs_expand.ops import msbfs_step_ref
    V = ell.shape[0]
    ref = msbfs_step_ref(ell[sample], fr_in, vis_in, dist_in, hop)
    return {"rows": sample.numel(),
            "frontier_equal": torch.equal(ref[:-1], fr_out[sample]),
            "visited_equal": torch.equal(vis_in, vis[sample]),
            "dist_equal": torch.equal(dist_in, dist[sample]),
            "sentinel_zero": not bool(fr_out[V].any()),
            "new_pairs": int(popcount_words(torch, ref[:-1]))}


def popcount_words(torch, words):
    """Set bits of int32 words (a 0-d tensor)."""
    from repro_torch.kernels.pairwise_popcount.ops import popcount32
    return popcount32(words.to(torch.int64) & 0xFFFFFFFF).sum()


def engine_run(torch, seed: int, first: bool, int_rate: float) -> dict:
    """Build the batch_1b cell on the card from ``seed`` and run its six
    supersteps through the engine bundle's step. The first run times each
    superstep (the hop and the expand by CUDA events around
    ``msbfs_step``), checks the BFS certificate and the hop against its
    plain version on the sampled rows after each hop, and holds the last
    expand to ``expand_level_ref``; every run returns digests of
    what it made."""
    from repro_torch.core import enumerate as enum
    from repro_torch.kernels.registry import LAUNCHES, reset_launches
    from repro_torch.launch import steps
    bundle = steps.build_bundle(ENGINE_ARCH, ENGINE_SHAPE)
    cfg, step = bundle.cfg, bundle.step_fn
    d = steps.engine_dims(cfg, bundle.spec)
    V, W, cap, Vp = d["V"], d["W"], d["cap"], d["Vp"]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ell, edges = engine_ell(torch, V, V, cap, cfg.avg_degree, gen)
    dist, frontier = engine_sources(torch, d, gen)
    pruned, _ = engine_ell(torch, Vp, Vp + 1, cap, cfg.avg_degree, gen)
    slack = torch.randint(0, d["k"] + 1, (Vp + 1,), generator=gen,
                          device="cuda", dtype=torch.int8)
    slack[Vp] = -1
    tbl = enum.prune_table(slack, torch.full_like(slack, -1))
    paths, n_paths = engine_paths(torch, d, pruned, ENGINE_PATHS, gen)
    del slack
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    frontier, dist = step.prime(frontier, dist)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    out = {"edges": int(edges), "t_data_s": t_data, "t_build_s": t_build,
           "t_prime_s": t_build - t_data, "digests": {
               "ell": digest(torch, ell), "pruned": digest(torch, pruned)}}
    sample = torch.randperm(
        V, generator=torch.Generator(device="cuda").manual_seed(seed + 1),
        device="cuda")[:ENGINE_SAMPLE]
    marks, held = [], []
    hop_kernel = steps.msbfs_step

    def marked(ell_i, fr, vis, buf, hop):
        if first:       # the sampled rows' state before the hop
            held[:] = [fr, vis[sample].clone(), buf[sample].clone()]
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        got = hop_kernel(ell_i, fr, vis, buf, hop)
        ev1.record()
        marks.append((ev0, ev1))
        if first:
            held.extend([got, vis, buf])
        return got

    steps.msbfs_step = marked
    supersteps, counts, cert = [], [], []
    reset_launches()
    try:
        for hop in range(1, d["k"] + 1):
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            frontier, dist, verts, count = step(
                ell, frontier, dist, hop, pruned, tbl, paths, n_paths)
            e1.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            counts.append(int(count))
            out["digests"][f"frontier_{hop}"] = digest(torch, frontier)
            if first:
                new_bits = set_bits(torch, frontier)
                nbytes = V * cap * 4 + (V + 1) * W * 8 + V * W * 8 + new_bits
                supersteps.append({
                    "hop": hop, "wall_s": wall,
                    "msbfs_step_ms": marks[-1][0].elapsed_time(marks[-1][1]),
                    "expand_ms": marks[-1][1].elapsed_time(e1),
                    "new_pairs": new_bits,
                    "msbfs_step_bound": bound(
                        nbytes, V * W * cap / int_rate * 1e3),
                    "expand_count": counts[-1]})
                cert.append({"hop": hop, **bfs_certificate(
                    torch, ell, dist, frontier, sample, hop),
                    "plain": hop_against_plain(torch, ell, sample, hop,
                                               *held)})
                held.clear()
    finally:
        steps.msbfs_step = hop_kernel
    out["launches"] = {k: v for k, v in LAUNCHES.items() if v}
    out["expand_counts"] = counts
    out["digests"]["dist"] = digest(torch, dist)
    out["verts"] = verts.cpu()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if not first:
        return out
    out["supersteps"] = supersteps
    out["certificate"] = cert
    # check (b): the last expand against its plain version on the card,
    # once the graph's tables are freed
    del ell, dist, frontier, step, bundle
    torch.cuda.empty_cache()
    ref = enum.expand_level_ref(paths, n_paths, pruned, tbl, -2, level=1,
                                budget=d["width"] - 1, out_cap=d["out_cap"])
    n_ref = int(ref.frontier.count)
    n = counts[-1]
    got_rows = verts[:n].to("cuda")
    cand = int((ref.nbrs[:ENGINE_PATHS] != Vp).sum())
    out["expand_ref"] = {
        "count": n_ref, "overflow": bool(ref.frontier.overflow),
        "rows_equal_sorted": n == n_ref and torch.equal(
            sorted_rows(torch, got_rows),
            sorted_rows(torch, ref.frontier.verts[:n_ref])),
        "same_order": n == n_ref and torch.equal(
            got_rows, ref.frontier.verts[:n_ref]),
        "bound": bound(ENGINE_PATHS * d["width"] * 4
                       + (ENGINE_PATHS + 1) * cap * 4 + cand * 2
                       + d["out_cap"] * cap * 5
                       + d["out_cap"] * d["width"] * 4 + 16, 0.0)}
    return out


def engine_child() -> dict:
    """What phase engine runs in a fresh process (``--engine-child``): the
    dry run's estimate of the batch_1b cell, the card's free memory
    against it, two runs from ENGINE_SEED (checks (a)-(c))."""
    import torch
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    est = dryrun.dryrun_cell(ENGINE_ARCH, ENGINE_SHAPE)
    t_dry = time.perf_counter() - t0
    need = est["memory"]["peak_device_bytes"] + ENGINE_HEADROOM
    free, total = torch.cuda.mem_get_info()
    require(free >= need, f"phase engine needs {need} bytes of the card, "
                          f"{free} of {total} are free")
    props = torch.cuda.get_device_properties(0)
    int_rate = INT_PER_CLK_SM * props.multi_processor_count \
        * float(smi("clocks.max.sm", units=False)) * 1e6
    first = engine_run(torch, ENGINE_SEED, True, int_rate)
    torch.cuda.empty_cache()
    second = engine_run(torch, ENGINE_SEED, False, int_rate)
    return {"nvidia_smi": smi("name,power.limit"),
            "dry_run": {"peak_device_bytes": est["memory"]
                        ["peak_device_bytes"], "memory": est["memory"],
                        "kernels": est["census"]["kernels"],
                        "t_trace_s": est["t_trace_s"], "t_s": t_dry},
            "free_bytes": free, "total_bytes": total, "first": {
                k: v for k, v in first.items() if k != "verts"},
            "second": {k: second[k] for k in ("edges", "t_build_s",
                                              "expand_counts", "launches",
                                              "peak_bytes")},
            "same_digests": first["digests"] == second["digests"],
            "same_verts": torch.equal(first["verts"], second["verts"]),
            "same_counts": first["expand_counts"] == second["expand_counts"]}


def engine_start():
    """Phase engine's fresh process, started while this one builds the
    host graph: it starts from an empty allocator and holds the card's
    memory to itself."""
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--engine-child"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT)


def phase_engine(torch, child) -> dict:
    """Phase engine: wait for the fresh process, check what it ran, emit
    the phase line."""
    t0 = time.perf_counter()
    try:
        out, err = child.communicate(timeout=ENGINE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        child.kill()
        out, err = child.communicate()
    lines = out.strip().splitlines()
    require(child.returncode == 0 and lines,
            f"phase engine's fresh process failed ({child.returncode}): "
            f"{err[-3000:]}")
    got = json.loads(lines[-1])
    first = got["first"]
    steps = first["supersteps"]
    k = len(steps)
    per = {"msbfs_step": 1, "path_member": 1, "level_fused": 1}
    line = {"phase": "engine", "arch": ENGINE_ARCH, "shape": ENGINE_SHAPE,
            "t_wait_s": time.perf_counter() - t0, **got,
            "msbfs_step_ms": [s["msbfs_step_ms"] for s in steps],
            "expand_ms": [s["expand_ms"] for s in steps],
            "superstep_wall_s": [s["wall_s"] for s in steps],
            "peak_gib": first["peak_bytes"] / 2**30,
            "dry_run_peak_gib": got["dry_run"]["peak_device_bytes"] / 2**30}
    emit(line)
    bad = [c for c in first["certificate"] if any(c["violations"].values())]
    require(not bad, f"phase engine: the BFS certificate fails: {bad}")
    bad = [c["plain"] for c in first["certificate"]
           if not all(c["plain"][n] for n in (
               "frontier_equal", "visited_equal", "dist_equal",
               "sentinel_zero"))]
    require(not bad and k == len(first["certificate"]),
            f"phase engine: msbfs_step disagrees with msbfs_step_ref on the "
            f"sampled rows: {bad}")
    require(all(first["launches"].get(n) == k * c for n, c in per.items())
            and set(first["launches"]) == set(per) and k == 6,
            f"phase engine: launches {first['launches']} in {k} supersteps "
            f"(one msbfs_step and one fused level each)")
    ref = first["expand_ref"]
    require(ref["rows_equal_sorted"] and not ref["overflow"]
            and all(0 < n < 1 << 20 for n in first["expand_counts"]),
            f"phase engine: the expand disagrees with expand_level_ref "
            f"or overflows: {ref}, counts {first['expand_counts']}")
    require(got["same_digests"] and got["same_verts"]
            and got["same_counts"],
            "phase engine: a second run from the same seed differs")
    return line


# the kernels phase's msbfs_step case at the engine's word width: a
# 2**20-vertex graph of the engine's law, the third level from 512 sources
ENGINE_WIDTH_V = 1 << 20
ENGINE_WIDTH_HOP = 3


def engine_width_call(torch) -> tuple:
    """``msbfs_step``'s arguments at W = 16 (512 queries): the ELL, the
    (V+1, W) frontier, visited and dist after ENGINE_WIDTH_HOP - 1 levels
    from seeded sources, and the next hop."""
    from repro_torch import configs
    from repro_torch.kernels.msbfs_expand import ops as mops
    from repro_torch.launch import steps
    cfg = configs.get(ENGINE_ARCH).CONFIG
    V, Q = ENGINE_WIDTH_V, cfg.n_queries
    d = {"V": V, "Q": Q, "W": -(-Q // 32)}
    gen = torch.Generator(device="cuda").manual_seed(ENGINE_SEED)
    ell, _ = engine_ell(torch, V, V, cfg.ell_cap, cfg.avg_degree, gen)
    dist, fr = engine_sources(torch, d, gen)
    frontier = torch.zeros((V + 1, d["W"]), dtype=torch.int32, device="cuda")
    frontier[:V] = fr
    visited = steps.visited_words(dist)
    for hop in range(1, ENGINE_WIDTH_HOP):
        frontier = mops.msbfs_step_cuda(ell, frontier, visited, dist, hop)
    return ell, frontier, visited, dist, ENGINE_WIDTH_HOP


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


def trace_device(torch, fn, setup=None,
                 expect=()) -> tuple[list, float]:
    """``fn()`` under ``torch.profiler`` tracing the card only: each device
    event as (name, stream, start ns, end ns), and the host wall
    (synchronized at both ends), in seconds. A window with no device
    event, or without an event whose name holds each string of
    ``expect`` (in a process that ran long windows before, the profiler
    can drop some of a short window's events), is run again, at most
    ``TRACE_TRIES`` times in all;
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
        if events and all(any(want in ev[0] for ev in events)
                          for want in expect):
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
    events, wall = trace_device(
        torch, calls, expect=("gamma_pack_kernel", "pairwise_popcount_kernel"))
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


class CapsRecorder:
    """Keeps every engine's ``_plan_caps`` call (from any replica thread)
    while active: its arguments (reverse, source, budget, slack) and the
    capacities it planned."""

    def __init__(self):
        import threading
        from repro_torch.core.engine import BatchPathEngine
        self.cls, self.fn = BatchPathEngine, BatchPathEngine._plan_caps
        self.calls, self.lock = [], threading.Lock()

    def __enter__(self):
        rec = self

        def plan_caps(engine, reverse, source, budget, slack):
            caps = rec.fn(engine, reverse, source, budget, slack)
            with rec.lock:
                rec.calls.append((bool(reverse), int(source), int(budget),
                                  slack.to(engine.device), list(caps)))
            return caps
        self.cls._plan_caps = plan_caps
        return self

    def __exit__(self, *exc):
        self.cls._plan_caps = self.fn


def event_ms(torch, fn):
    """``(fn(), ms)``: one call between two CUDA events on the current
    stream, after a synchronize."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def segment_hop_ms(torch, dg, sources, edge_chunk: int) -> float:
    """Device time of one segment-route hop over ``dg``'s (maybe
    sharded) forward lists from a frontier of ``sources`` (the hop's work
    does not depend on the frontier's bits): median of
    ``SEGMENT_HOP_REPS`` after a warm-up, CUDA events on the caller's
    stream, which waits for every slot."""
    from repro_torch.core.msbfs import edge_span, msbfs_hop
    S = len(sources)
    dev = dg.ell_idx.device
    frontier = torch.zeros((dg.n + 1, S), dtype=torch.int8, device=dev)
    frontier[torch.as_tensor(sources, device=dev).long(),
             torch.arange(S, device=dev)] = 1
    m_valid = edge_span(dg.m, edge_chunk, dg.m_cap)
    return cuda_ms(torch, lambda: msbfs_hop(frontier, *dg.edge_list(False),
                                            dg.n, edge_chunk, m_valid),
                   reps=SEGMENT_HOP_REPS)


def segment_replan(eng, calls, what: str) -> dict:
    """Plans each recorded ``_plan_caps`` call again on ``eng`` (outside a
    fan-out: over its edge-sharded view) and requires the recorded
    capacities, which the ELL route planned alike; no ELL kernel may
    launch."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    reset_launches()
    t0 = time.perf_counter()
    for reverse, source, budget, slack, caps in calls:
        require(eng._plan_caps(reverse, source, budget, slack) == caps,
                f"{what}, main: planned capacities differ from the ELL "
                f"route's")
    require(LAUNCHES["msbfs_step"] == LAUNCHES["ell_spmm"] == 0,
            f"{what}, main: ELL kernels launched {dict(LAUNCHES)}")
    return {"n_plan_caps": len(calls),
            "replan_host_s": time.perf_counter() - t0}


def phase_segment(torch, g, batches) -> dict:
    """Phase segment (see the module docstring). ``batches``: (name,
    queries, a default-engine report of them) of the main and the sharing
    batch."""
    import numpy as np
    from repro_torch.core import (BatchPathEngine, EngineConfig, GraphDelta,
                                  PathSession)
    from repro_torch.core.graph import EdgeSlices
    from repro_torch.kernels import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    # the default engine (ELL route): the distances and the planned
    # capacities every segment configuration must give (its path sets
    # are the reports passed in)
    ell = BatchPathEngine(g, EngineConfig(), device="cuda")
    ref, ell_out = {}, {}
    for name, qs, _ in batches:
        event_ms(torch, lambda: ell._build_index(qs))       # warm-up
        index, ms = event_ms(torch, lambda: ell._build_index(qs))
        ref[name] = (index.dist_s, index.dist_t)
        ell_out[name] = {"t_build_index_ms": ms}
    emit({"phase": "segment_ell", "t_setup_s": time.perf_counter() - t0,
          **ell_out})
    sources = np.unique([q[0] for q in batches[0][1]])

    runs, planned = [], {}
    for slots, mesh in SEGMENT_MESHES:
        for chunk in SEGMENT_CHUNKS:
            t_cfg = time.perf_counter()
            sess = PathSession(g, EngineConfig(index_route="segment",
                                               edge_chunk=chunk, mesh=mesh),
                               device="cuda")
            eng = sess.engine
            view = eng.executor.index_dg
            require(isinstance(view.esrc, EdgeSlices) == (mesh is not None)
                    and eng.executor.n_replicas == slots,
                    f"segment {slots} slots: the index view is not cut "
                    f"over the slots")
            out = {"slots": slots, "edge_chunk": chunk,
                   "m_cap": eng.dg.m_cap}
            what = f"segment, {slots} slots, chunk {chunk}"
            for name, qs, want_report in batches:
                index, ms = event_ms(torch, lambda: eng._build_index(qs))
                want = ref[name]
                require(torch.equal(index.dist_s, want[0])
                        and torch.equal(index.dist_t, want[1]),
                        f"{what}, {name}: distances differ from the ELL "
                        f"route's")
                del index
                if name == "main" and (slots, chunk) \
                        not in SEGMENT_MAIN_RUNS:
                    out[name] = {"t_build_index_ms": ms,
                                 **segment_replan(eng, planned[name],
                                                  what)}
                    continue
                reset_launches()
                t1 = time.perf_counter()
                with CapsRecorder() as crec:
                    rep = sess.run(qs)
                host = time.perf_counter() - t1
                launches = dict(LAUNCHES)
                planned.setdefault(name, crec.calls)
                # no fallback: the segment route sweeps with PyTorch ops
                # on the card, enumeration keeps its kernels
                require(launches["msbfs_step"] == launches["ell_spmm"] == 0,
                        f"{what}, {name}: ELL kernels launched {launches}")
                require(launches["level_fused"] > 0, f"{what}, {name}: no "
                        f"fused level launched {launches}")
                require_fused(launches, f"{what}, {name}")
                require_similarity(launches, f"{what}, {name}")
                # the ELL route plans each of these calls alike
                for reverse, source, budget, slack, caps in crec.calls:
                    require(ell._plan_caps(reverse, source, budget, slack)
                            == caps, f"{what}, {name}: planned capacities "
                                     f"differ from the ELL route's")
                check_same(qs, want_report, rep,
                           f"{what}, {name}: the default engine and the "
                           f"segment route")
                out[name] = {"t_build_index_ms": ms,
                             "stats": {k: rep.stats.get(k)
                                       for k in STAT_KEYS},
                             "host_wall_s": host,
                             "n_plan_caps": len(crec.calls),
                             "launches": {k: launches[k] for k in (
                                 "level_fused", "join_fused", "gamma_pack",
                                 "pairwise_popcount")}}
            out["hop_ms"] = segment_hop_ms(torch, eng._kernel_dg(), sources,
                                           chunk)
            out["t_config_s"] = time.perf_counter() - t_cfg
            emit({"phase": "segment_run", **out})
            runs.append(out)
            del sess, eng, view
    del ref, ell
    gc.collect()

    # deltas on four slots under delta_backend="msbfs": the segment
    # route's sweep against the ELL route's, side by side
    name, qs, _ = batches[1]
    cfg = dict(cache_bytes=256 << 20, delta_backend="msbfs",
               mesh=SEGMENT_MESHES[0][1])
    sessions = {"ell": PathSession(g, EngineConfig(**cfg), device="cuda"),
                "segment": PathSession(g, EngineConfig(
                    index_route="segment", **cfg), device="cuda")}
    last = {b: s.run(qs) for b, s in sessions.items()}
    check_same(qs, last["ell"], last["segment"], f"segment delta, {name}")
    rng = np.random.default_rng(5)
    steps = []
    for step in ("near", "cap"):
        g_old = sessions["ell"].engine.g
        if step == "near":
            qi = max(range(len(qs)), key=lambda i: last["ell"][i].count)
            row = [int(x) for x in last["ell"][qi].paths[0] if x >= 0]
            delta = GraphDelta.from_pairs(remove=[(row[0], row[1])])
        else:
            delta = cap_delta(g_old, sessions["ell"].engine.dg, rng)
        reports, swept, sweeps, reruns = {}, {}, {}, {}
        for b, sess in sessions.items():
            with DistsRecorder(sess.engine) as drec:
                reset_launches()
                reports[b] = sess.apply_delta(delta)
                sweeps[b] = LAUNCHES["msbfs_step"]
            swept[b] = drec.calls
            reruns[b] = sess.run(qs)
        rs, re_ = reports["segment"], reports["ell"]
        keys = ("n_touched", "cache_mode", "cache_kept", "cache_evicted",
                "device_update")
        require({k: rs[k] for k in keys} == {k: re_[k] for k in keys},
                f"segment delta {step}: reports differ: {rs} vs {re_}")
        require(len(swept["segment"]) == len(swept["ell"]) > 0,
                f"segment delta {step}: {len(swept['segment'])} and "
                f"{len(swept['ell'])} distance sweeps")
        for (_, ka, da), (_, kb, db) in zip(swept["segment"],
                                              swept["ell"]):
            require(ka == kb and all(np.array_equal(da[x], db[x])
                                     for x in ("from", "to")),
                    f"segment delta {step}: the sweep's distances differ "
                    f"from the ELL route's")
        require(sweeps["segment"] == 0 and sweeps["ell"] > 0,
                f"segment delta {step}: msbfs_step launches {sweeps}")
        eng = sessions["segment"].engine
        view = eng.executor.index_dg
        require(view.m == eng.dg.m and view.m_cap >= eng.dg.m_cap,
                f"segment delta {step}: the index view was not recut")
        if step == "near":
            require(rs["cache_evicted"] > 0, f"near: evicted nothing {rs}")
        else:
            require(rs["device_update"] == "rebuild",
                    f"cap: no rebuild {rs}")
        check_same(qs, reruns["ell"], reruns["segment"],
                   f"segment delta {step}: the next batch")
        steps.append({"step": step, "k_max": swept["segment"][0][1],
                      "report": {k: rs[k] for k in keys},
                      "t_apply_s": {b: reports[b]["t_apply_s"]
                                    for b in sessions}})
        last = reruns
    del sessions
    gc.collect()
    torch.cuda.empty_cache()
    out = {"phase": "segment", "ell": ell_out, "runs": runs,
           "deltas": steps, "t_phase_s": time.perf_counter() - t0}
    emit(out)
    return out


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


class AttnRecorder:
    """Wraps ``transformer.gqa_attention``: with ``check`` on, each call's
    output is held to the plain version (``flash_attention_ref``: a float8
    cache dequantised to bf16, p rounded to bf16) on the same q and cache
    by ``check_bf16_attention`` (``ATTN_BF16_TOL`` elementwise,
    ``ATTN_BF16_ROW_REL_L2`` a row); the largest error and relative L2
    error of a row (one query, one q-head) are kept."""

    def __init__(self, torch):
        from repro_torch.kernels.flash_attention import ops
        from repro_torch.models import transformer
        self.torch, self.ops, self.tm = torch, ops, transformer
        self.fn = transformer.gqa_attention
        self.check = False
        self.checked = 0
        self.max_abs_err = self.max_row_rel_l2 = 0.0

    def __call__(self, q, k, v, causal=True, **kw):
        out = self.fn(q, k, v, causal, **kw)
        if self.check:
            self.compare(q, k, v, causal, kw, out)
        return out

    def compare(self, q, k, v, causal, kw, out):
        want = self.ops.flash_attention_ref(q, k, v, causal, **kw)
        err, rel = check_bf16_attention(
            self.torch, out, want,
            f"decode attention over a {k.dtype} cache")
        self.checked += 1
        self.max_abs_err = max(self.max_abs_err, err)
        self.max_row_rel_l2 = max(self.max_row_rel_l2, rel)

    def __enter__(self):
        self.tm.gqa_attention = self
        return self

    def __exit__(self, *exc):
        self.tm.gqa_attention = self.fn


def decode_f8(torch, model, prompt, teacher: int, greedy: int,
              checkers=()) -> dict:
    """``decode_step`` into ``model.init_cache`` (float8: the model's
    ``kv_cache_dtype`` is ``"f8"``): ``teacher`` teacher-forced steps on
    ``prompt``, then ``greedy`` greedy ones, each ``checker``'s ``check``
    on for the greedy steps. Every step's logits must be finite and its
    ``attn_splitk_f8`` launches equal the layers. Returns the
    teacher-forced logits (B, teacher, vocab), the cache, each step's
    wall and launches, and the greedy tokens."""
    from repro_torch.kernels import LAUNCHES
    B = prompt.shape[0]
    L = model.cfg.n_layers
    cache = model.init_cache(B, teacher + greedy)
    require(cache["k"].dtype == cache["v"].dtype == torch.float8_e4m3fn,
            f"the f8 cache is {cache['k'].dtype}")
    logits, t_teacher, t_greedy, per_step, tokens = [], [], [], [], []
    tok = None
    for i in range(teacher + greedy):
        is_greedy = i >= teacher
        for c in checkers:
            c.check = is_greedy
        inp = tok if is_greedy else prompt[:, i:i + 1]
        n0 = LAUNCHES["attn_splitk_f8"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache = model.decode_step(inp, cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_step.append(LAUNCHES["attn_splitk_f8"] - n0)
        require(per_step[-1] == L,
                f"decode step {i} into the f8 cache launched "
                f"attn_splitk_f8 {per_step[-1]} times, not once per layer "
                f"({L})")
        require(bool(torch.isfinite(out).all()),
                f"f8 decode step {i}: logits not finite")
        tok = out[:, 0].argmax(-1, keepdim=True)
        if is_greedy:
            t_greedy.append(wall)
            tokens.append(tok)
        else:
            t_teacher.append(wall)
            logits.append(out[:, 0])
    for c in checkers:
        c.check = False
    return {"logits": torch.stack(logits, 1), "cache": cache,
            "t_teacher": t_teacher, "t_greedy": t_greedy,
            "launches_per_step": per_step,
            "greedy_tokens": torch.cat(tokens, 1)}


def cache_bytes(cache) -> int:
    return sum(cache[n].numel() * cache[n].element_size() for n in "kv")


def phase_lm(torch) -> dict:
    """Phase 10 (see the module docstring): granite-8b served on the card,
    with checks (a)-(d), then into a float8 cache."""
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
                   "tokens_per_s_teacher": B * len(t_teacher)
                   / sum(t_teacher),
                   "greedy_tokens": torch.cat(greedy, 1)[0, :8].tolist()},
        "profile": {"prefill": prof_prefill, "decode_step": prof_decode},
        "check_b": {"layers": cfg.n_layers, "dtype": "bfloat16",
                    "positions": LM_TEACHER,
                    "max_rel_l2": max_rel, "bound": LM_BF16_REL_L2,
                    "mean_rel_l2": float(rel.mean()),
                    "argmax_agreement": agree},
        "max_memory_allocated": torch.cuda.max_memory_allocated()})
    del ref, rel, last
    f8 = lm_f8_decode(torch, model, prompt, got, cache)
    out["f8"] = f8
    del cache, got
    torch.cuda.empty_cache()
    mesh = mesh_decode(torch, model)
    serve = mesh_serve(torch, model, prompt)
    del model
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
            "routes": routes, "f8_launches": f8["launches"],
            "f8_steps": f8["steps"], "mesh_launches": mesh,
            "serve_launches": serve}


def step_profile(torch, fn) -> tuple:
    """``fn()`` once under a card-only ``torch.profiler``: its result, the
    wall (synchronized at both ends), the attention kernels' device time
    (``attn_*``: the split-K kernel and its merge) and all device time,
    summed over the slots' streams."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    attn = other = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        if "attn_" in e.name.lower():
            attn += ms
        else:
            other += ms
    return res, {"wall_ms": wall * 1e3, "attn_device_ms": attn,
                 "device_ms": attn + other}


class FlashDecodeRecorder:
    """Wraps ``transformer.flash_decode_attention`` and the slots'
    ``attention_partial``: keeps each call's q, position and output (one a
    layer, in order; the slots' pieces put together) and each slot's q,
    keys, values, valid length and partial (out, lse), for the checks
    against the plain version."""

    def __init__(self):
        from repro_torch.models import transformer
        self.tm, self.fns, self.calls, self.parts = transformer, None, [], []

    def decode(self, qs, ck, cv, pos, rules, wide):
        outs = self.fns[0](qs, ck, cv, pos, rules, wide)
        # the slots' q and output put together (B, 1, Hq, hd): the batch
        # cut over its axis, every q head on every slot
        lg = (self.tm.cache_logical(wide)["k"][1], None, None, None)
        self.calls.append((rules.assemble(qs, *lg), pos,
                           rules.assemble(outs, *lg)))
        return outs

    def partial(self, q, k, v, valid):
        out, lse = self.fns[1](q, k, v, valid)
        self.parts.append((q, k, v, valid, out, lse))
        return out, lse

    def __enter__(self):
        self.fns = (self.tm.flash_decode_attention, self.tm.attention_partial)
        self.calls, self.parts = [], []
        self.tm.flash_decode_attention = self.decode
        self.tm.attention_partial = self.partial
        return self

    def __exit__(self, *exc):
        self.tm.flash_decode_attention, self.tm.attention_partial = self.fns


def mesh_attention_check(torch, fops, rec, full, what: str) -> dict:
    """A sharded decode step's attention against the plain version
    (``flash_attention_ref``, not counted) at row 8's bf16 tolerance: each
    slot's partial (float32 out and lse) on its piece of the cache, a slot
    with no valid key zeros and -inf on both sides; each layer's merged
    output over the whole layer cache (``full``) on the same q. Returns
    the largest errors."""
    worst = dict.fromkeys(("partial_max_abs_err", "partial_max_row_rel_l2",
                           "lse_max_abs_err", "max_abs_err",
                           "max_row_rel_l2"), 0.0)
    empty = 0
    for q, k, v, valid, out, lse in rec.parts:
        want, want_lse = fops.flash_attention_ref(
            q, k, v, False, q_offset=0, kv_valid_len=valid, return_lse=True,
            out_dtype=torch.float32)
        if valid == 0:
            empty += 1
            require(all(torch.equal(x, torch.zeros_like(x))
                        for x in (out, want))
                    and all(bool((x == float("-inf")).all())
                            for x in (lse, want_lse)),
                    f"{what}: a slot with no valid key does not give zeros "
                    f"and an lse of -inf")
            continue
        e, r = check_bf16_attention(
            torch, out, want, f"{what}: a slot's partial over {valid} keys "
            f"against the plain version")
        le = float((lse - want_lse).abs().max())
        require(torch.allclose(lse, want_lse, atol=ATTN_BF16_TOL,
                               rtol=ATTN_BF16_TOL),
                f"{what}: a slot's lse over {valid} keys off the plain "
                f"version's by {le}")
        worst["partial_max_abs_err"] = max(worst["partial_max_abs_err"], e)
        worst["partial_max_row_rel_l2"] = max(
            worst["partial_max_row_rel_l2"], r)
        worst["lse_max_abs_err"] = max(worst["lse_max_abs_err"], le)
    for layer, (q, at, out) in enumerate(rec.calls):
        want = fops.flash_attention_ref(q, full["k"][layer], full["v"][layer],
                                        True, q_offset=at,
                                        kv_valid_len=at + 1)
        e, r = check_bf16_attention(
            torch, out, want, f"{what} layer {layer}: the sharded attention "
            f"against the plain version over the whole cache")
        worst["max_abs_err"] = max(worst["max_abs_err"], e)
        worst["max_row_rel_l2"] = max(worst["max_row_rel_l2"], r)
    torch.cuda.synchronize()
    worst.update({"partials": len(rec.parts), "empty_partials": empty})
    return worst


def row_rel_l2(got, want) -> float:
    """The largest relative L2 difference of a logits row."""
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


def mesh_decode(torch, model) -> dict:
    """Phase 13b: granite-8b's ``flash_decode`` over slots of the card
    (``MESH_DECODE_CASES``) on phase lm's weights (``LM.with_mesh``, which
    cuts them over the slots too, ``serve_param_sharding="2d"``): the
    cache cut by ``shard_cache`` (views of one tensor), each sharded step
    profiled and its launches counted (``attn_splitk_f8`` or
    ``attn_splitk`` once a slot and layer, no other route), its slots'
    partials and each layer's attention then held to the plain version
    (:func:`mesh_attention_check`), then the one-slot ``flash_decode`` and
    the default decode over the same cache state, the sharded logits held
    to both at ``MESH_DECODE_REL_L2``. Emits the phase line; returns the
    launches by route."""
    from repro_torch.config import RunOptions
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import quantize_f8, shard_cache

    cfg = model.cfg
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    out = {"phase": "mesh_decode", "arch": cfg.name,
           "weights_bytes": model.param_bytes(), "cases": {},
           "tolerance": {"atol": ATTN_BF16_TOL, "rtol": ATTN_BF16_TOL,
                         "row_rel_l2": ATTN_BF16_ROW_REL_L2,
                         "logits_row_rel_l2": MESH_DECODE_REL_L2}}
    launches = dict.fromkeys(("splitk", "splitk_f8"), 0)
    for name, B, S, shape, kv in MESH_DECODE_CASES:
        t_case = time.perf_counter()
        opts = RunOptions(flash_decode=True, kv_cache_dtype=kv)
        layout = make_host_mesh(*shape)
        sharded = model.with_mesh(layout, opts)
        one = model.with_mesh(None, opts)
        default = model.with_mesh(None, RunOptions(kv_cache_dtype=kv))
        kv_bytes = 1 if kv == "f8" else 2
        cache_bytes = 2 * L * B * S * Hkv * hd * kv_bytes
        free = torch.cuda.mem_get_info()[0]
        require(free >= cache_bytes + MESH_HEADROOM,
                f"mesh_decode {name}: {free} bytes free, the cache needs "
                f"{cache_bytes} + {MESH_HEADROOM} (the case is not shrunk)")
        blocks = sharded.rules.size("seq_kv_wide" if B == 1 else "seq_kv")
        start = (blocks - 1) * (S // blocks) - MESH_DECODE_BEFORE
        full = one.init_cache(B, S)
        gen = torch.Generator(device="cuda").manual_seed(29)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for layer in range(L):
            for key in ("k", "v"):
                x = torch.randn((B, start, Hkv, hd), generator=gen,
                                device="cuda", dtype=torch.bfloat16)
                full[key][layer, :, :start] = (quantize_f8(x) if kv == "f8"
                                               else x)
                del x
        full["pos"] = start
        torch.cuda.synchronize()
        t_fill = time.perf_counter() - t0
        cache = shard_cache(full, sharded.rules)
        toks = torch.randint(0, cfg.vocab, (B, MESH_DECODE_STEPS),
                             generator=gen, device="cuda")
        route = "splitk_f8" if kv == "f8" else "splitk"
        want_routes = dict.fromkeys(fops.ROUTES, 0)
        want_routes[route] = layout.size * L
        steps = []
        for t in range(MESH_DECODE_STEPS):
            pos = start + t
            tok = toks[:, t:t + 1]
            reset_launches()
            last = cache
            with FlashDecodeRecorder() as rec:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got, cache = sharded.decode_step(tok, cache)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            routes = attn_counts(LAUNCHES, fops)
            require(routes == want_routes
                    and LAUNCHES["flash_attention"] == layout.size * L
                    and len(rec.calls) == L
                    and len(rec.parts) == layout.size * L,
                    f"mesh_decode {name}: routes {routes}, expected "
                    f"{want_routes}: one {route} a slot and layer")
            launches[route] += routes[route]
            attn = mesh_attention_check(torch, fops, rec, full,
                                        f"mesh_decode {name} step {t}")
            del rec
            # the one-slot flash_decode, then the default decode, each over
            # the cache state before this step (each rewrites position pos)
            one_last = full
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want, full = one.decode_step(tok, one_last)
            torch.cuda.synchronize()
            one_wall = time.perf_counter() - t0
            # the logits only: the dict it returns holds the whole cache
            base = default.decode_step(tok, one_last)[0]
            require(all(bool(torch.isfinite(x).all())
                        for x in (got, want, base)),
                    f"mesh_decode {name}: logits not finite")
            rel = {"one_slot": row_rel_l2(got, want),
                   "default": row_rel_l2(got, base),
                   "one_slot_vs_default": row_rel_l2(want, base)}
            require(max(rel["one_slot"], rel["default"])
                    <= MESH_DECODE_REL_L2,
                    f"mesh_decode {name} step {t}: the sharded logits "
                    f"against the one-slot and the default decode's, row "
                    f"relative L2 {rel} (bound {MESH_DECODE_REL_L2})")
            keys = L * B * (pos + 1) * Hkv * hd * 2 * kv_bytes
            steps.append({
                "pos": pos, "wall_ms": wall * 1e3,
                "one_slot_wall_ms": one_wall * 1e3, "attention": attn,
                "logits_max_row_rel_l2": rel,
                "logits_max_abs_diff": float((got - want).abs().max()),
                "argmax_equal": {
                    "one_slot": bool((got.argmax(-1) == want.argmax(-1))
                                     .all()),
                    "default": bool((got.argmax(-1) == base.argmax(-1))
                                    .all())},
                "attn_bound_ms": keys / HBM_BYTES_PER_S * 1e3,
                "bound_ms": (keys + model.param_bytes()) / HBM_BYTES_PER_S
                * 1e3})
            del base
        # the last step again, each decode under a card-only profiler (the
        # same position rewritten with the same values): device times
        # (the results dropped at once: they hold the cache)
        prof = step_profile(torch,
                            lambda: sharded.decode_step(tok, last))[1]
        one_prof = step_profile(torch,
                                lambda: one.decode_step(tok, one_last))[1]
        out["cases"][name] = {
            "batch": B, "keys": S, "layout": list(shape),
            "slots": layout.size, "kv_cache": kv, "cache_bytes": cache_bytes,
            "start_pos": start, "t_fill_s": t_fill, "route": route,
            "launches_per_step": layout.size * L, "steps": steps,
            "profiled_last_step": {"sharded": prof, "one_slot": one_prof,
                                   "pos": pos},
            "t_case_s": time.perf_counter() - t_case}
        del full, cache, last, one_last, got, want, sharded, one, default
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = launches
    emit(out)
    return launches


def attention_checked(rec, want: int, what: str) -> dict:
    """An ``AttnRecorder``'s comparisons since the last call, ``want`` of
    them required; its counters reset."""
    require(rec.checked == want,
            f"{what}: {rec.checked} attention calls held to the plain "
            f"version, expected {want}")
    out = {"calls": rec.checked, "max_abs_err": rec.max_abs_err,
           "max_row_rel_l2": rec.max_row_rel_l2}
    rec.checked = 0
    rec.max_abs_err = rec.max_row_rel_l2 = 0.0
    return out


def timed(torch, fn):
    """``fn()`` and its wall in seconds, synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def filled_cache(torch, model, B: int, gen) -> dict:
    """A one-device cache of ``MESH_SERVE_CACHE`` at batch ``B``, every
    layer's keys and values below ``MESH_SERVE_P0`` seeded random, ``pos``
    there."""
    cfg = model.cfg
    full = model.init_cache(B, MESH_SERVE_CACHE)
    for key in ("k", "v"):
        full[key][:, :, :MESH_SERVE_P0] = torch.randn(
            (cfg.n_layers, B, MESH_SERVE_P0, cfg.n_kv_heads, cfg.hd),
            generator=gen, device="cuda", dtype=torch.float32).to(
                full[key].dtype)
    full["pos"] = MESH_SERVE_P0
    return full


def copy_cache(cache: dict) -> dict:
    return {"k": cache["k"].clone(), "v": cache["v"].clone(),
            "pos": cache["pos"]}


def serve_steps(torch, model, toks, cache, rec=None) -> tuple:
    """``MESH_SERVE_STEPS`` teacher-forced steps of ``toks`` (B, steps):
    the logits (B, steps, vocab), each step's wall, and each step's
    ``flash_attention`` launches by route; ``rec`` (an ``AttnRecorder``)
    checking the first step only."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops as fops
    logits, walls, routes = [], [], []
    for t in range(toks.shape[1]):
        if rec is not None:
            rec.check = t == 0
        reset_launches()
        (out, cache), wall = timed(
            torch, lambda: model.decode_step(toks[:, t:t + 1], cache))
        routes.append(attn_counts(LAUNCHES, fops))
        walls.append(wall)
        logits.append(out[:, 0])
    if rec is not None:
        rec.check = False
    return torch.stack(logits, 1), walls, routes, cache


def routes_per_slot_layer(routes: dict, slots: int, layers: int) -> dict:
    """A call's launches by route, per slot and layer."""
    return {r: n / (slots * layers) for r, n in routes.items() if n}


def mesh_serve(torch, model, prompt) -> dict:
    """Phase 13c: granite-8b's sharded serving (``MESH_SERVE_CASES``) over
    slots of the card on phase lm's weights, and case C in float32. Emits
    the phase line; returns the ``flash_attention`` launches by route."""
    import dataclasses
    from repro_torch.config import RunOptions
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import LM, shard_cache

    t_phase = time.perf_counter()
    cfg = model.cfg
    L, B = cfg.n_layers, prompt.shape[0]
    out = {"phase": "mesh_serve", "arch": cfg.name,
           "weights_bytes": model.param_bytes(), "batch": B,
           "prompt": prompt.shape[1], "cache": MESH_SERVE_CACHE,
           "start_pos": MESH_SERVE_P0, "steps": MESH_SERVE_STEPS,
           "tolerance": {"logits_row_rel_l2": MESH_SERVE_REL_L2,
                         "f32_logits_row_rel_l2": MESH_SERVE_F32_REL_L2,
                         "attention": {"atol": ATTN_BF16_TOL,
                                       "rtol": ATTN_BF16_TOL,
                                       "row_rel_l2": ATTN_BF16_ROW_REL_L2}},
           "cases": {}}
    launches = dict.fromkeys(fops.ROUTES, 0)
    gen = torch.Generator(device="cuda").manual_seed(30)
    toks = torch.randint(0, cfg.vocab, (B, MESH_SERVE_STEPS), generator=gen,
                         device="cuda")
    base = filled_cache(torch, model.with_mesh(None), B, gen)

    def one_device(m, prompt_, cache):
        """The one-device model's prefill (its wall the second call's)
        and steps: the references."""
        m.prefill(prompt_)
        ref, t_pre = timed(torch, lambda: m.prefill(prompt_))
        got, walls, _, _ = serve_steps(torch, m, toks, copy_cache(cache))
        return {"prefill": ref, "decode": got, "prefill_s": t_pre,
                "step_walls": walls}

    def sharded_case(name, m, ref, cache, sides, prompt_, dtype_routes):
        slots = m.mesh.size
        layers = m.cfg.n_layers
        case = {"layout": list(m.mesh.shape), "slots": slots,
                "serve_param_sharding": m.opts.serve_param_sharding,
                "seq_parallel": m.opts.seq_parallel, "layers": layers}
        with AttnRecorder(torch) as rec:
            reset_launches()
            rec.check = True
            logits, checked = timed(torch, lambda: m.prefill(prompt_))
            rec.check = False
            _, wall = timed(torch, lambda: m.prefill(prompt_))
            routes = attn_counts(LAUNCHES, fops)
            want = dict.fromkeys(fops.ROUTES, 0)
            want[dtype_routes[0]] = 2 * slots * layers
            require(routes == want and LAUNCHES["flash_attention"]
                    == 2 * slots * layers,
                    f"mesh_serve {name} prefill: routes {routes} over two "
                    f"calls, expected {want}: one {dtype_routes[0]} a slot "
                    f"and layer")
            for r, n in routes.items():
                launches[r] += n
            attn = attention_checked(rec, slots * layers,
                                     f"mesh_serve {name} prefill")
            require(bool(torch.isfinite(logits).all()),
                    f"mesh_serve {name}: prefill logits not finite")
            rel = row_rel_l2(logits, ref["prefill"])
            case["prefill"] = {
                "wall_s": wall, "first_wall_with_checks_s": checked,
                "one_device_wall_s": ref["prefill_s"],
                "logits_max_row_rel_l2": rel,
                "launches_per_slot_layer": routes_per_slot_layer(
                    routes, slots, 2 * layers),
                "slot_attention_vs_plain": attn}
            for side in sides:
                sm = m.with_mesh(m.mesh, dataclasses.replace(
                    m.opts, flash_decode=side))
                full = copy_cache(cache)
                pieces = shard_cache(full, sm.rules)
                rec_flash = FlashDecodeRecorder() if side else None
                if side:
                    with rec_flash:
                        got, walls, step_routes, pieces = serve_steps(
                            torch, sm, toks[:, :1], pieces)
                    # the merged attention over the state after the step
                    step_attn = mesh_attention_check(
                        torch, fops, rec_flash, full,
                        f"mesh_serve {name} flash_decode step 0")
                    del rec_flash
                    more, walls2, routes2, pieces = serve_steps(
                        torch, sm, toks[:, 1:], pieces)
                    got = torch.cat([got, more], 1)
                    walls += walls2
                    step_routes += routes2
                else:
                    got, walls, step_routes, pieces = serve_steps(
                        torch, sm, toks, pieces, rec)
                    step_attn = attention_checked(
                        rec, slots * layers, f"mesh_serve {name} gathered "
                        f"decode step 0")
                want = dict.fromkeys(fops.ROUTES, 0)
                want[dtype_routes[1]] = slots * layers
                for t, r in enumerate(step_routes):
                    require(r == want,
                            f"mesh_serve {name} decode step {t} "
                            f"(flash_decode={side}): routes {r}, expected "
                            f"{want}")
                    for k, n in r.items():
                        launches[k] += n
                require(bool(torch.isfinite(got).all()),
                        f"mesh_serve {name}: decode logits not finite")
                rel_d = row_rel_l2(got, ref["decode"])
                # one step again under a card-only profiler: the attention
                # kernels' device time over the slots' streams
                last = copy_cache(cache)
                prof = step_profile(torch, lambda: sm.decode_step(
                    toks[:, :1], shard_cache(last, sm.rules)))[1]
                case["decode_flash" if side else "decode_gathered"] = {
                    "step_wall": latency(walls),
                    "one_device_step_wall": latency(ref["step_walls"]),
                    "logits_max_row_rel_l2": rel_d,
                    "launches_per_slot_layer": routes_per_slot_layer(
                        step_routes[0], slots, layers),
                    "slot_attention_vs_plain": step_attn,
                    "profiled_step": prof}
                del full, pieces, last, got
            case["prefill"]["profiled"] = step_profile(
                torch, lambda: m.prefill(prompt_))[1]
        return case

    ref = one_device(model.with_mesh(None), prompt, base)
    for name, shape, mode, sides in MESH_SERVE_CASES:
        t0 = time.perf_counter()
        m = model.with_mesh(make_host_mesh(*shape),
                            RunOptions(serve_param_sharding=mode))
        case = sharded_case(name, m, ref, base, sides, prompt,
                            ("wgmma", "splitk"))
        worst = max([case["prefill"]["logits_max_row_rel_l2"]]
                    + [case[k]["logits_max_row_rel_l2"] for k in case
                       if k.startswith("decode_")])
        require(worst <= MESH_SERVE_REL_L2,
                f"mesh_serve {name}: logits against the one-device model's, "
                f"row relative L2 {worst} (bound {MESH_SERVE_REL_L2})")
        case["t_case_s"] = time.perf_counter() - t0
        out["cases"][name] = case
        del m
        gc.collect()
    del base, ref
    torch.cuda.empty_cache()

    # case C: float32 at full width, MESH_SERVE_F32_LAYERS layers
    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_c = dataclasses.replace(cfg, n_layers=MESH_SERVE_F32_LAYERS,
                                dtype="float32")
    top = {n: getattr(model, n).float() for n in ("embed", "final_norm")}
    if not cfg.tie_embeddings:
        top["unembed"] = model.unembed.float()
    names = model.layers[0].tensors()
    top["layers"] = {n: torch.stack([model.layers[i].tensors()[n].float()
                                     for i in range(MESH_SERVE_F32_LAYERS)])
                     for n in names}
    one = LM(cfg_c, top, device="cuda")
    del top
    prompt_c = prompt[:, :MESH_SERVE_F32_PROMPT]
    base = filled_cache(torch, one, B, gen)
    ref = one_device(one, prompt_c, base)
    m = one.with_mesh(make_host_mesh(*MESH_SERVE_CASES[0][1]))
    case = sharded_case("C", m, ref, base, (True, False), prompt_c,
                        ("scalar", "scalar"))
    worst = max([case["prefill"]["logits_max_row_rel_l2"]]
                + [case[k]["logits_max_row_rel_l2"] for k in case
                   if k.startswith("decode_")])
    require(worst <= MESH_SERVE_F32_REL_L2,
            f"mesh_serve C (float32): logits against the one-device "
            f"model's, row relative L2 {worst} (bound "
            f"{MESH_SERVE_F32_REL_L2})")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    case.update({"dtype": "float32", "tf32": False,
                 "prompt": MESH_SERVE_F32_PROMPT,
                 "t_case_s": time.perf_counter() - t0})
    out["cases"]["C"] = case
    del m, one, base, ref
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["t_phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return launches


def ring_buckets(torch, src, dst, n_loc: int, P: int) -> tuple:
    """The edges (src, dst) bucketed by (destination owner, source owner)
    for ``ring_aggregate`` over P slots of ``n_loc`` rows: (P, P, Eb)
    int32 local sources and destinations and the mask, Eb the largest
    bucket; each bucket's edges in their order."""
    key = (dst // n_loc) * P + src // n_loc
    key, order = torch.sort(key, stable=True)
    counts = torch.bincount(key, minlength=P * P)
    eb = int(counts.max())
    first = torch.cumsum(counts, 0) - counts
    at = key * eb + torch.arange(key.numel(), device=key.device) - first[key]
    es = torch.zeros(P * P * eb, dtype=torch.int32, device=key.device)
    ed = torch.zeros_like(es)
    em = torch.zeros(P * P * eb, dtype=torch.bool, device=key.device)
    es[at] = (src.index_select(0, order) % n_loc).int()
    ed[at] = (dst.index_select(0, order) % n_loc).int()
    em[at] = True
    shape = (P, P, eb)
    return es.view(shape), ed.view(shape), em.view(shape), counts


def mesh_ring(torch) -> dict:
    """``gnn.ring_aggregate`` at ogb_products over ``MESH_RING_SLOTS``
    slots of the card against the one-slot segmented sum
    (``models/segment.py``); each round timed by CUDA events."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_cells_mesh
    from repro_torch.models.gnn import RingPlan
    from repro_torch.models.segment import Segments
    bundle = steps.build_bundle(*GNN_LARGE)
    n, draws = bundle.dims["n_nodes"], bundle.dims["n_edges"]
    F = bundle.dims["d_feat"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    src, dst = device_powerlaw(torch, n, draws, gen)
    feats = {"int": torch.randint(-8, 9, (n, F), generator=gen,
                                  device="cuda").float(),
             "normal": torch.randn((n, F), generator=gen, device="cuda")}
    seg = Segments(dst, n)
    srt = src.index_select(0, seg.perm)

    def one_slot(h):
        return seg.reduce(h.index_select(0, srt), "sum")

    torch.cuda.synchronize()
    out = {"arch": GNN_LARGE[0], "shape": GNN_LARGE[1], "nodes": n,
           "edge_draws": draws, "edges": int(src.numel()), "d_feat": F,
           "t_data_s": time.perf_counter() - t0,
           "one_slot_ms": cuda_ms(torch, lambda: one_slot(feats["normal"]),
                                  reps=3),
           "tolerance_normal": {"rel_to_abs_sum": MESH_RING_REL},
           "slots": {}}
    ref = {k: one_slot(h) for k, h in feats.items()}
    abs_sum = one_slot(feats["normal"].abs())
    for P in MESH_RING_SLOTS:
        n_loc = -(-n // P)
        t0 = time.perf_counter()
        es, ed, em, counts = ring_buckets(torch, src, dst, n_loc, P)
        plan = RingPlan(es, ed, em, make_cells_mesh(devices=["cuda:0"] * P),
                        "cells", n_loc)
        del es, ed, em
        torch.cuda.synchronize()
        rec = {"n_loc": n_loc, "bucket_max": int(counts.max()),
               "bucket_mean": float(counts.float().mean()),
               "bucket_rows": counts.view(P, P).sum(1).tolist(),
               "t_plan_s": time.perf_counter() - t0,
               "rotated_bytes_per_round": P * n_loc * F * 4}
        for feat, h in feats.items():
            hp = torch.zeros((P * n_loc, F), device="cuda")
            hp[:n] = h
            marks = [torch.cuda.Event(enable_timing=True)]
            torch.cuda.synchronize()
            marks[0].record()
            for acc in plan.rounds(list(hp.split(n_loc))):
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            torch.cuda.synchronize()
            got = torch.cat(acc)[:n]
            err = (got - ref[feat]).abs()
            if feat == "int":
                ok = torch.equal(got, ref[feat])
            else:
                ok = bool((err <= MESH_RING_REL * abs_sum).all())
            require(ok, f"mesh: ring_aggregate over {P} slots, {feat} "
                        f"features, against the one-slot sum: max abs err "
                        f"{float(err.max())}")
            rec[feat] = {"round_ms": [a.elapsed_time(b) for a, b in
                                      zip(marks, marks[1:])],
                         "max_abs_err": float(err.max()), "exact": bool(
                             torch.equal(got, ref[feat]))}
            rec[feat]["ring_ms"] = sum(rec[feat]["round_ms"])
            del hp, acc, got, err
        out["slots"][str(P)] = rec
        del plan
        torch.cuda.empty_cache()
    return out


def mesh_ef(torch) -> dict:
    """``ef_compressed_psum_axis`` over an ``MESH_EF_SLOTS``-slot ``pod``
    axis of the card: ``MESH_EF_STEPS`` steps of seeded ``MESH_EF_SHAPE``
    gradient leaves (scaled by 10 ** (step % 3), as tests/test_ft.py),
    each step's reduced tensor and errors equal to the sequence form's
    bit for bit, then the error-feedback invariant."""
    from repro_torch.launch.mesh import Layout
    from repro_torch.optim.compress import (ef_compressed_psum,
                                            ef_compressed_psum_axis)
    P = MESH_EF_SLOTS
    pod = Layout("pods", ("pod",), (P,), ("cuda:0",) * P)
    gen = torch.Generator(device="cuda").manual_seed(2)
    errs = [torch.zeros(MESH_EF_SHAPE, device="cuda") for _ in range(P)]
    seq = [torch.zeros(MESH_EF_SHAPE, device="cuda") for _ in range(P)]
    sent = torch.zeros(MESH_EF_SHAPE, dtype=torch.float64, device="cuda")
    total = torch.zeros_like(sent)
    times = []
    for t in range(MESH_EF_STEPS):
        grads = [torch.randn(MESH_EF_SHAPE, generator=gen, device="cuda")
                 * 10 ** (t % 3) for _ in range(P)]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        red, errs = ef_compressed_psum_axis(grads, errs, pod, "pod")
        b.record()
        want, seq = ef_compressed_psum(grads, seq)
        b.synchronize()
        times.append(a.elapsed_time(b))
        require(all(torch.equal(x, want) for x in red)
                and all(torch.equal(x, y) for x, y in zip(errs, seq)),
                f"mesh: ef_compressed_psum_axis step {t} differs from the "
                f"sequence form")
        sent += red[0].double()
        for g in grads:
            total += g.double()
        del grads, red, want
    final = sent + sum(e.double() for e in errs)
    err = float((final - total).abs().max())
    ok = bool(torch.allclose(final, total, rtol=1e-4, atol=1e-3))
    require(ok, f"mesh: error feedback's invariant off by {err}")
    return {"slots": P, "leaf": list(MESH_EF_SHAPE), "steps": MESH_EF_STEPS,
            "step_ms": times, "bit_equal_to_sequence_form": True,
            "invariant_max_abs_err": err, "invariant_ok": ok,
            "leaf_bytes": 4 * MESH_EF_SHAPE[0] * MESH_EF_SHAPE[1]}


def phase_mesh(torch) -> dict:
    """Phase 17a: the substrate's other programs over slots of the card,
    ``gnn.ring_aggregate`` and ``ef_compressed_psum_axis``."""
    t0 = time.perf_counter()
    out = {"phase": "mesh", "ring": mesh_ring(torch)}
    gc.collect()
    torch.cuda.empty_cache()
    out["ef_compressed_psum"] = mesh_ef(torch)
    gc.collect()
    torch.cuda.empty_cache()
    out["t_phase_s"] = time.perf_counter() - t0
    emit(out)
    return out


def lm_f8_decode(torch, model, prompt, got_bf16, cache_bf16) -> dict:
    """Phase lm's float8 cache: ``RunOptions(kv_cache_dtype="f8")`` on the
    same model, ``LM_TEACHER`` teacher-forced and ``LM_GREEDY`` greedy
    steps into a float8 cache of the same slots, each step's
    ``attn_splitk_f8`` launches counted and every greedy step's attention
    held to its plain version (``AttnRecorder``); per-step latency,
    tokens/s and the cache's bytes beside the bf16 run's, and the logits'
    divergence from the bf16 cache's (a finding: no bound)."""
    import dataclasses
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops as fops

    B, L = prompt.shape[0], model.cfg.n_layers
    model.opts = dataclasses.replace(model.opts, kv_cache_dtype="f8")
    rec = AttnRecorder(torch)
    reset_launches()
    with rec:
        run = decode_f8(torch, model, prompt, LM_TEACHER, LM_GREEDY, (rec,))
    model.opts = dataclasses.replace(model.opts, kv_cache_dtype="bf16")
    steps = LM_TEACHER + LM_GREEDY
    routes = attn_counts(LAUNCHES, fops)
    want = dict.fromkeys(fops.ROUTES, 0)
    want["splitk_f8"] = L * steps
    require(routes == want and LAUNCHES["flash_attention"] == L * steps,
            f"lm f8: flash_attention routes {routes}, expected {want}")
    require(rec.checked == L * LM_GREEDY,
            f"lm f8: {rec.checked} attention calls held to the plain "
            f"version, expected {L * LM_GREEDY}")
    got = run["logits"]
    rel = (got - got_bf16).norm(dim=-1) / got_bf16.norm(dim=-1)
    agree = float((got.argmax(-1) == got_bf16.argmax(-1)).float().mean())
    t_teacher = run["t_teacher"]
    res = {"kv_cache_dtype": "f8", "max_len": steps,
           "cache_bytes": cache_bytes(run["cache"]),
           "cache_bytes_bf16": cache_bytes(cache_bf16),
           "teacher_forced": latency(t_teacher),
           "greedy_with_checks": latency(run["t_greedy"]),
           "tokens_per_s_teacher": B * len(t_teacher) / sum(t_teacher),
           "launches": LAUNCHES["flash_attention"], "steps": steps,
           "routes": routes, "launches_per_step": sorted(set(
               run["launches_per_step"])),
           "attention_check": {"calls": rec.checked,
                               "max_abs_err": rec.max_abs_err,
                               "max_row_rel_l2": rec.max_row_rel_l2,
                               "atol": ATTN_BF16_TOL,
                               "rtol": ATTN_BF16_TOL,
                               "row_rel_l2_bound": ATTN_BF16_ROW_REL_L2},
           "vs_bf16_cache": {"positions": LM_TEACHER,
                             "median_rel_l2": float(rel.median()),
                             "max_rel_l2": float(rel.max()),
                             "argmax_agreement": agree},
           "greedy_tokens": run["greedy_tokens"][0, :8].tolist()}
    del run, got, rel
    torch.cuda.empty_cache()
    return res


# phase moe: olmoe-1b-7b (arXiv:2409.02060) at full width in bf16, cut
# to MOE_LAYERS of its 16 layers, served as phase lm serves granite-8b
# (prefill_32k cut to 4 x 2048; 512 teacher-forced + 32 greedy decode
# steps into a 544-slot cache). The depth is cut to keep the script within
# its time limit since phase moonshot, which runs the same MoE serving
# path at full depth (48 layers)
MOE_ARCH = "olmoe-1b-7b"
MOE_LAYERS = 4
# each greedy step's MoE layers against moe_ffn_dense_ref: the relative L2
# error of a token's output row, bf16 expert products and combine against
# float32 (about 2**-8 of a value each)
MOE_DENSE_REL_L2 = 3e-2
# tokens whose top-k experts differ between the layer's bf16 router
# logits and the oracle's float32 ones are not compared, only counted
# (near ties among 64 probabilities flip under bf16 rounding); at most
# this share of them
MOE_ROUTING_FLIP_MAX = 0.2
# decode against the teacher-forced forward: in float32 at full width and
# MOE_CHECK_LAYERS layers at phase lm's LM_F32_TOL (router ties cannot
# flip there); in bf16 at MOE_LAYERS a near tie flips an expert wherever
# the two paths' hidden states differ in the last bit, so the relative L2
# error's median is bounded by LM_BF16_REL_L2, the share of positions
# above it by MOE_BF16_ABOVE_MAX, the share of positions whose argmax
# token agrees from below by MOE_BF16_ARGMAX_MIN, and its max reported.
# The bounds hold the readings at MOE_LAYERS (on the H100: median 0.0080,
# 9.96% above, 95.17% agreeing, max 0.125) with a margin of 1.5x on the
# share above and 5 points on the agreement; at all 16 layers the H100
# read 7.3% above, 95.1% agreeing, max 0.092
MOE_CHECK_LAYERS = 4
MOE_BF16_ABOVE_MAX = 0.15
MOE_BF16_ARGMAX_MIN = 0.9


class MoeRecorder:
    """Wraps ``transformer.moe_ffn``: with ``check`` on, each call's output
    is held to ``moe_ffn_dense_ref`` on its input (tokens routed alike
    under both); with ``drops`` on, each call's dropped share is kept."""

    def __init__(self, torch):
        from repro_torch.models import moe, transformer
        self.torch, self.moe, self.tm = torch, moe, transformer
        self.fn = transformer.moe_ffn
        self.check = self.drops = False
        self.calls = self.compared = self.flipped = 0
        self.max_rel = 0.0
        self.dropped = []

    def __call__(self, h, lp, cfg, groups=16):
        out, aux = self.fn(h, lp, cfg, groups=groups)
        self.calls += 1
        if self.drops:
            self.dropped.append(self.moe.dropped_share(h, lp, cfg, groups))
        if self.check:
            self.compare(h, lp, cfg, out)
        return out, aux

    def compare(self, h, lp, cfg, out):
        torch, moe = self.torch, self.moe
        D, k = cfg.d_model, cfg.moe.top_k
        x = h.reshape(-1, D)
        want = moe.moe_ffn_dense_ref(h, lp, cfg).reshape(-1, D).float()
        got = out.reshape(-1, D).float()
        _, ids_w = moe.top_k(torch.softmax(
            (x @ lp["router"].to(x.dtype)).float(), -1), k)
        _, ids_f = moe.top_k(torch.softmax(x.float() @ lp["router"].float(),
                                           -1), k)
        same = (ids_w.sort(-1).values == ids_f.sort(-1).values).all(-1)
        rel = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
        self.compared += int(same.sum())
        self.flipped += int((~same).sum())
        if bool(same.any()):
            self.max_rel = max(self.max_rel, float(rel[same].max()))

    def __enter__(self):
        self.tm.moe_ffn = self
        return self

    def __exit__(self, *exc):
        self.tm.moe_ffn = self.fn


class RouteRecorder:
    """Wraps ``transformer.moe_route`` (the sharded MoE's routing, one call
    a slot and layer): keeps each call's tokens, router, groups and expert
    ids."""

    def __init__(self):
        from repro_torch.models import transformer
        self.tm, self.fn, self.calls = transformer, None, []

    def __call__(self, h, router, cfg, groups):
        r = self.fn(h, router, cfg, groups)
        self.calls.append((h, router, groups, r.eids))
        return r

    def __enter__(self):
        self.fn = self.tm.moe_route
        self.tm.moe_route = self
        return self

    def __exit__(self, *exc):
        self.tm.moe_route = self.fn


def moe_mesh(torch, model, prompt) -> dict:
    """Phase 14b: the MoE model over a ``MOE_MESH_LAYOUT`` layout of the
    card (expert-parallel: ``E / model`` experts a slot, the dispatch in
    as many groups as the data axis has slots), one prefill on phase moe's
    prompt. Each layer's routing (the slots of a data row alike, their
    groups together) equal to the one-device ``moe_route`` at those groups
    on the same tokens exactly; the logits within ``LM_BF16_REL_L2`` a row
    of the one-device prefill at the same groups; every slot's attention
    on ``attn_wgmma`` once a layer. Emits the phase line."""
    from repro_torch.config import RunOptions
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    cfg = model.cfg
    layout = make_host_mesh(*MOE_MESH_LAYOUT)
    sharded = model.with_mesh(layout, RunOptions())
    groups = sharded.opts.moe_groups
    one = model.with_mesh(None, RunOptions(moe_groups=groups))
    want, t_one = timed(torch, lambda: one.prefill(prompt))
    with RouteRecorder() as rec:
        reset_launches()
        got, cold = timed(torch, lambda: sharded.prefill(prompt))
        routes = attn_counts(LAUNCHES, fops)
    _, wall = timed(torch, lambda: sharded.prefill(prompt))
    L, slots = cfg.n_layers, layout.size
    want_routes = dict.fromkeys(fops.ROUTES, 0)
    want_routes["wgmma"] = slots * L
    require(routes == want_routes,
            f"moe_mesh: flash_attention routes {routes}, expected "
            f"{want_routes}: one wgmma a slot and layer")
    require(len(rec.calls) == slots * L,
            f"moe_mesh: moe_route ran {len(rec.calls)} times, expected "
            f"{slots * L}")
    require(bool(torch.isfinite(got).all()), "moe_mesh: logits not finite")
    flips = []
    for layer in range(L):
        recs = rec.calls[layer * slots:(layer + 1) * slots]
        rows = []
        for g in layout.groups("model"):
            for s in g[1:]:
                require(torch.equal(recs[s][3], recs[g[0]][3]),
                        f"moe_mesh layer {layer}: the slots of a data row "
                        f"route alike")
            rows.append(recs[g[0]])
        h = torch.cat([r[0].reshape(-1, cfg.d_model) for r in rows])
        eids = torch.cat([r[3] for r in rows])
        ref = rec.fn(h, rows[0][1], cfg, groups).eids
        flips.append(int((eids != ref).any(-1).sum()))
        require(torch.equal(eids, ref),
                f"moe_mesh layer {layer}: routing differs from the "
                f"one-device moe_route at {groups} groups on "
                f"{flips[-1]} tokens")
    rel = row_rel_l2(got, want)
    require(rel <= LM_BF16_REL_L2,
            f"moe_mesh: logits against the one-device prefill, row "
            f"relative L2 {rel} (bound {LM_BF16_REL_L2})")
    out = {"phase": "moe_mesh", "arch": cfg.name, "layers": L,
           "layout": list(MOE_MESH_LAYOUT), "slots": slots,
           "experts_per_slot": cfg.moe.n_experts // layout.shape[1],
           "moe_groups": groups, "tokens": prompt.numel(),
           "prefill_wall_s": wall, "cold_prefill_wall_s": cold,
           "one_device_prefill_wall_s": t_one,
           "launches_per_slot_layer": routes_per_slot_layer(routes, slots,
                                                            L),
           "routing_equal_layers": L, "routing_token_flips": flips,
           "logits_max_row_rel_l2": rel, "bound": LM_BF16_REL_L2,
           "profiled": step_profile(torch,
                                    lambda: sharded.prefill(prompt))[1],
           "t_phase_s": time.perf_counter() - t_phase}
    del rec, got, want, sharded, one
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return out


def phase_moe(torch) -> dict:
    """Phase 14: olmoe-1b-7b served on the card at full width, cut to
    ``MOE_LAYERS`` layers."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import moe
    from repro_torch.models.transformer import LM

    full = get(MOE_ARCH).CONFIG
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    B = LM_BATCH
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
               device="cuda")
    torch.cuda.synchronize()
    out = {"phase": "moe", "arch": cfg.name, "dtype": str(model.dtype),
           "config": dataclasses.asdict(cfg),
           "reduced": {"seq_len": [32768, LM_PROMPT],
                       "global_batch": [32, LM_BATCH],
                       "n_layers": [full.n_layers, MOE_LAYERS]},
           "params": model.param_count(), "param_bytes": model.param_bytes(),
           "moe_groups": model.opts.moe_groups,
           "t_init_s": time.perf_counter() - t0}
    tokens, _ = TokenStream(cfg.vocab, B, LM_PROMPT, seed=0).batch_at(0)
    prompt = torch.from_numpy(tokens).to("cuda", torch.long)
    rec = MoeRecorder(torch)
    calls = dict.fromkeys(("prefill", "decode_step", "lm_forward"), 0)
    with rec:
        reset_launches()
        t_prefill = []
        for i in range(2):               # cold, then warm
            rec.drops = i == 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last = model.prefill(prompt)
            torch.cuda.synchronize()
            t_prefill.append(time.perf_counter() - t0)
            calls["prefill"] += 1
            require(last.shape == (B, 1, cfg.vocab)
                    and bool(torch.isfinite(last).all()),
                    "moe prefill logits: wrong shape or not finite")
        rec.drops = False
        G, Tg, C = moe.capacity(B * LM_PROMPT, cfg, model.opts.moe_groups)
        cache = model.init_cache(B, LM_TEACHER + LM_GREEDY)
        got, cache, t_teacher = decode_teacher_forced(torch, model, prompt,
                                                      LM_TEACHER, cache)
        calls["decode_step"] += LM_TEACHER
        tok = got[:, -1].argmax(-1, keepdim=True)
        rec.check = True
        t_greedy = []
        for _ in range(LM_GREEDY):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step, cache = model.decode_step(tok, cache)
            torch.cuda.synchronize()
            t_greedy.append(time.perf_counter() - t0)  # with the oracle
            calls["decode_step"] += 1
            require(bool(torch.isfinite(step).all()),
                    "moe greedy decode logits not finite")
            tok = step[:, 0].argmax(-1, keepdim=True)
        rec.check = False
        # the teacher-forced forward with one token a group, as a decode
        # step's groups are: nothing dropped on either side
        model.opts = dataclasses.replace(model.opts,
                                         moe_groups=B * LM_TEACHER)
        ref = teacher_logits(model, prompt[:, :LM_TEACHER])
        calls["lm_forward"] += 1
        torch.cuda.synchronize()
    launches = LAUNCHES["flash_attention"]
    expected = cfg.n_layers * sum(calls.values())
    require(launches == expected,
            f"moe: flash_attention launched {launches} times, expected "
            f"{cfg.n_layers} layers x {calls} = {expected}")
    routes = attn_counts(LAUNCHES, fops)
    want_routes = dict.fromkeys(fops.ROUTES, 0)
    want_routes["wgmma"] = cfg.n_layers * (calls["prefill"]
                                           + calls["lm_forward"])
    want_routes["splitk"] = cfg.n_layers * calls["decode_step"]
    require(routes == want_routes,
            f"moe: flash_attention routes {routes}, expected {want_routes}")
    require(rec.calls == expected,
            f"moe: moe_ffn ran {rec.calls} times, expected {expected}")
    decode_layers = LM_GREEDY * cfg.n_layers
    require(rec.compared + rec.flipped == decode_layers * B,
            "moe: not every greedy step's MoE layers were held to the oracle")
    flip_share = rec.flipped / (decode_layers * B)
    require(rec.max_rel <= MOE_DENSE_REL_L2 and flip_share
            <= MOE_ROUTING_FLIP_MAX,
            f"moe: decode MoE layers against moe_ffn_dense_ref: max row "
            f"relative L2 {rec.max_rel} (bound {MOE_DENSE_REL_L2}), routing "
            f"flips {flip_share} (bound {MOE_ROUTING_FLIP_MAX})")
    require(bool(torch.isfinite(got).all() and torch.isfinite(ref).all()),
            "moe teacher-forced logits not finite")
    rel = (got - ref).norm(dim=-1) / ref.norm(dim=-1)
    max_rel, med_rel = float(rel.max()), float(rel.median())
    above = float((rel > LM_BF16_REL_L2).float().mean())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    require(med_rel <= LM_BF16_REL_L2 and above <= MOE_BF16_ABOVE_MAX
            and agree >= MOE_BF16_ARGMAX_MIN,
            f"moe: decode vs forward (bf16, {cfg.n_layers} layers): median "
            f"relative "
            f"L2 {med_rel} (bound {LM_BF16_REL_L2}), {above} of positions "
            f"above it (bound {MOE_BF16_ABOVE_MAX}), argmax agreement "
            f"{agree} (floor {MOE_BF16_ARGMAX_MIN})")
    out.update({
        "calls": calls, "launches": {"flash_attention": launches, **routes},
        "launches_per_call": cfg.n_layers,
        "prefill": {"tokens": B * LM_PROMPT, "t_cold_s": t_prefill[0],
                    "t_warm_s": t_prefill[1:],
                    "tokens_per_s_warm": [B * LM_PROMPT / t
                                          for t in t_prefill[1:]],
                    "groups": G, "tokens_per_group": Tg, "capacity": C,
                    "dropped_share_by_layer": rec.dropped,
                    "dropped_share": sum(rec.dropped) / len(rec.dropped)},
        "decode": {"max_len": LM_TEACHER + LM_GREEDY,
                   "teacher_forced": latency(t_teacher),
                   "greedy_with_oracle": latency(t_greedy),
                   "tokens_per_s_teacher": B * len(t_teacher)
                   / sum(t_teacher)},
        "check_dense_oracle": {"layers_checked": decode_layers,
                               "tokens_compared": rec.compared,
                               "routing_flips": rec.flipped,
                               "flip_share": flip_share,
                               "flip_bound": MOE_ROUTING_FLIP_MAX,
                               "max_row_rel_l2": rec.max_rel,
                               "bound": MOE_DENSE_REL_L2},
        "check_decode_vs_forward_bf16": {
            "layers": cfg.n_layers, "positions": LM_TEACHER,
            "forward_moe_groups": B * LM_TEACHER,
            "median_rel_l2": med_rel, "bound_on_median": LM_BF16_REL_L2,
            "max_rel_l2": max_rel, "mean_rel_l2": float(rel.mean()),
            "share_above_bound": above,
            "bound_on_share_above": MOE_BF16_ABOVE_MAX,
            "argmax_agreement": agree,
            "floor_on_argmax_agreement": MOE_BF16_ARGMAX_MIN},
        "max_memory_allocated": torch.cuda.max_memory_allocated()})
    del cache, got, ref, rel, last
    gc.collect()
    torch.cuda.empty_cache()
    moe_mesh(torch, model, prompt)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # -- full width, float32, MOE_CHECK_LAYERS layers: decode equals the
    # teacher-forced forward at phase lm's float32 tolerance
    cfg_a = dataclasses.replace(cfg, n_layers=MOE_CHECK_LAYERS,
                                dtype="float32")
    model = LM(cfg_a, generator=torch.Generator(device="cuda")
               .manual_seed(1), device="cuda")
    reset_launches()
    got, cache, _ = decode_teacher_forced(
        torch, model, prompt, LM_TEACHER, model.init_cache(B, LM_TEACHER))
    model.opts = dataclasses.replace(model.opts, moe_groups=B * LM_TEACHER)
    ref = teacher_logits(model, prompt[:, :LM_TEACHER])
    torch.cuda.synchronize()
    require(LAUNCHES["flash_attention"] == MOE_CHECK_LAYERS
            * (LM_TEACHER + 1) == LAUNCHES["attn_scalar"],
            "moe float32 check: flash_attention not launched once per "
            "layer on the float32 route")
    require(bool(torch.isfinite(got).all()),
            "moe float32 check: logits not finite")
    ok = bool(torch.allclose(got, ref, atol=LM_F32_TOL, rtol=LM_F32_TOL))
    out["check_decode_vs_forward_f32"] = {
        "layers": MOE_CHECK_LAYERS, "dtype": "float32", "tf32": False,
        "positions": LM_TEACHER, "max_abs_err": float((got - ref).abs()
                                                      .max()),
        "atol": LM_F32_TOL, "rtol": LM_F32_TOL, "ok": ok}
    require(ok, f"moe: decode vs forward beyond atol = rtol = {LM_F32_TOL} "
                f"in float32: {out['check_decode_vs_forward_f32']}")
    del model, cache, got, ref
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return out


def phase_moonshot(torch) -> dict:
    """Phase 14a: moonshot-v1-16b-a3b at full width and depth in bf16,
    served with a float8 KV cache (``RunOptions(kv_cache_dtype="f8")``)."""
    import dataclasses
    from repro_torch.config import RunOptions
    from repro_torch.configs import get
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models.transformer import LM

    cfg = get(MOONSHOT_ARCH).CONFIG
    B, L = LM_BATCH, cfg.n_layers
    steps = MOONSHOT_TEACHER + MOONSHOT_GREEDY
    kv = 2 * L * B * steps * cfg.n_kv_heads * cfg.hd          # one byte
    need = 2 * cfg.param_count() + kv + MOONSHOT_HEADROOM
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    require(free >= need,
            f"moonshot: {free} bytes free on the card of {total}, the "
            f"phase needs {need} ({cfg.param_count()} bf16 parameters, a "
            f"{kv}-byte f8 cache and {MOONSHOT_HEADROOM} of headroom); it "
            f"is never cut")
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()   # earlier phases'
    t0 = time.perf_counter()
    model = LM(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
               opts=RunOptions(kv_cache_dtype="f8"), device="cuda")
    torch.cuda.synchronize()
    out = {"phase": "moonshot", "arch": cfg.name, "dtype": str(model.dtype),
           "config": dataclasses.asdict(cfg), "kv_cache_dtype": "f8",
           "reduced": {"seq_len": [32768, LM_PROMPT],
                       "global_batch": [32, LM_BATCH]},
           "params": model.param_count(), "param_bytes": model.param_bytes(),
           "free_bytes_before": free, "need_bytes": need,
           "allocated_before": allocated_before,
           "moe_groups": model.opts.moe_groups,
           "t_init_s": time.perf_counter() - t0}
    tokens, _ = TokenStream(cfg.vocab, B, LM_PROMPT, seed=0).batch_at(0)
    prompt = torch.from_numpy(tokens).to("cuda", torch.long)
    moe_rec, attn_rec = MoeRecorder(torch), AttnRecorder(torch)
    with moe_rec, attn_rec:
        reset_launches()
        t_prefill = []
        for i in range(2):               # cold, then warm
            moe_rec.drops = i == 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last = model.prefill(prompt)
            torch.cuda.synchronize()
            t_prefill.append(time.perf_counter() - t0)
            require(last.shape == (B, 1, cfg.vocab)
                    and bool(torch.isfinite(last).all()),
                    "moonshot prefill logits: wrong shape or not finite")
        moe_rec.drops = False
        prefill_routes = attn_counts(LAUNCHES, fops)
        run = decode_f8(torch, model, prompt, MOONSHOT_TEACHER,
                        MOONSHOT_GREEDY, (moe_rec, attn_rec))
        torch.cuda.synchronize()
    routes = attn_counts(LAUNCHES, fops)
    want = dict.fromkeys(fops.ROUTES, 0)
    want["wgmma"] = 2 * L
    want["splitk_f8"] = L * steps
    require(routes == want and LAUNCHES["flash_attention"] == L * (2 + steps)
            and prefill_routes["wgmma"] == 2 * L,
            f"moonshot: flash_attention routes {routes} (after the "
            f"prefills {prefill_routes}), expected {want}: one launch a "
            f"layer a call, prefill on wgmma, decode on splitk_f8")
    require(moe_rec.calls == L * (2 + steps),
            f"moonshot: moe_ffn ran {moe_rec.calls} times, expected "
            f"{L * (2 + steps)}")
    checked = MOONSHOT_GREEDY * L
    require(moe_rec.compared + moe_rec.flipped == checked * B,
            "moonshot: not every greedy step's MoE layers were held to the "
            "oracle")
    flip_share = moe_rec.flipped / (checked * B)
    require(moe_rec.max_rel <= MOE_DENSE_REL_L2
            and flip_share <= MOE_ROUTING_FLIP_MAX,
            f"moonshot: decode MoE layers against moe_ffn_dense_ref: max "
            f"row relative L2 {moe_rec.max_rel} (bound {MOE_DENSE_REL_L2}), "
            f"routing flips {flip_share} (bound {MOE_ROUTING_FLIP_MAX})")
    require(attn_rec.checked == checked,
            f"moonshot: {attn_rec.checked} attention calls held to the "
            f"plain version, expected {checked}")
    t_teacher = run["t_teacher"]
    out.update({
        "calls": {"prefill": 2, "decode_step": steps},
        "launches": {"flash_attention": LAUNCHES["flash_attention"],
                     **routes},
        "launches_per_step": sorted(set(run["launches_per_step"])),
        "prefill": {"tokens": B * LM_PROMPT, "t_cold_s": t_prefill[0],
                    "t_warm_s": t_prefill[1],
                    "tokens_per_s_warm": B * LM_PROMPT / t_prefill[1],
                    "dropped_share": sum(moe_rec.dropped)
                    / len(moe_rec.dropped)},
        "decode": {"max_len": steps,
                   "cache_bytes": cache_bytes(run["cache"]),
                   "cache_bytes_if_bf16": 2 * cache_bytes(run["cache"]),
                   "teacher_forced": latency(t_teacher),
                   "greedy_with_checks": latency(run["t_greedy"]),
                   "tokens_per_s_teacher": B * len(t_teacher)
                   / sum(t_teacher),
                   "greedy_tokens": run["greedy_tokens"][0, :8].tolist()},
        "check_dense_oracle": {"layers_checked": checked,
                               "tokens_compared": moe_rec.compared,
                               "routing_flips": moe_rec.flipped,
                               "flip_share": flip_share,
                               "flip_bound": MOE_ROUTING_FLIP_MAX,
                               "max_row_rel_l2": moe_rec.max_rel,
                               "bound": MOE_DENSE_REL_L2},
        "attention_check": {"calls": attn_rec.checked,
                            "max_abs_err": attn_rec.max_abs_err,
                            "max_row_rel_l2": attn_rec.max_row_rel_l2,
                            "atol": ATTN_BF16_TOL, "rtol": ATTN_BF16_TOL,
                            "row_rel_l2_bound": ATTN_BF16_ROW_REL_L2},
        "max_memory_allocated": torch.cuda.max_memory_allocated()})
    del model, run, last
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return {"launches": out["launches"]["splitk_f8"], "steps": steps,
            "layers": L}


# phase train: granite-8b at full width, cut to TRAIN_LAYERS of its 36
# layers and train_4k cut to TRAIN_BATCH x TRAIN_SEQ (about 130 GB at 16
# bytes a parameter for the whole model; 20 GB for the cut), three AdamW
# steps through TrainDriver with remat, a checkpoint after two, an
# injected crash and a resume; then olmoe-1b-7b at full width, 2 of its 16
# layers, for 2 steps
TRAIN_ARCH = "granite-8b"
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 4, 2, 4096
TRAIN_STEPS, TRAIN_CKPT_EVERY = 3, 2
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 2
# check (b): two more steps on batch 0, the schedule continued (counts 3
# and 4 of its 100-step warm-up, lr 9e-6 and 1.2e-5); at its peak (3e-4)
# the first step of a random 4096-wide model overshoots (7.38 -> 12.27 on
# the H100). Cut to 2 layers the same two steps raise the loss (7.49 ->
# 8.86 on the H100) from the resumed and the uninterrupted state alike
# (probes/train_resume_depth.py), so the check runs at 4 layers
TRAIN_REPEATS = 2
TRAIN_DIR = os.path.join(ROOT, "build", "smoke_train")
# check (a): the forward's lse-writing instance (the one training runs)
# against its serving instance (output bit-identical) and the plain
# version (output at the kernels row's tolerance; lse at LSE_TOL: bf16
# inputs, float32 inputs), then the backward kernel against
# flash_attention_bwd_ref fed the plain lse, on the step's attention shape
# in bf16 at the model's hd (wgmma route) and at BWD_MMA_HD (mma route;
# each gradient within 2e-2 of its largest magnitude, and 2e-2 relative
# L2 in every row of hd) and on a float32 shape (1e-4 absolute and
# relative)
BWD_BF16_TOL = 2e-2
# the bf16 head dim that takes the mma.sync route (not 64 or 128)
BWD_MMA_HD = 96
BWD_F32_SHAPE = (1, 1024, 32, 8, 128)
BWD_F32_TOL = 1e-4
LSE_TOL = (1e-3, 1e-4)
# check (d): one granite-8b layer at full width in float32 (TF32 off) on
# GRAD_REF_BATCH x GRAD_REF_SEQ tokens, with remat: the loss and every
# parameter's gradient through the kernels against autograd through
# flash_attention_ref on the same inputs; the loss and the gradient norm
# at GRAD_REF_TOL relative, each gradient within GRAD_REF_TOL of its
# largest magnitude
GRAD_REF_BATCH, GRAD_REF_SEQ = 1, 4096
GRAD_REF_TOL = 1e-4


def train_bundle(arch: str, n_layers: int, opts, batch: int = TRAIN_BATCH,
                 seq: int = TRAIN_SEQ, **cut):
    """The train bundle of ``arch``'s published config cut to ``n_layers``
    (and ``cut``'s other fields) at ``batch x seq``."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.launch import steps
    mod = get(arch)
    cfg = dataclasses.replace(mod.CONFIG, n_layers=n_layers, **cut)
    shape = steps.shape_of(mod, "train_4k", {"seq_len": seq,
                                             "global_batch": batch})
    return steps.lm_bundle(arch, cfg, shape, opts)


def run_driver(torch, bundle, ckpt_dir, total, fail_at=None):
    """``TrainDriver`` on the bundle; (result or None, step times, error)."""
    from repro_torch.ft import DriverConfig, FailureInjector, TrainDriver
    from repro_torch.launch.train import make_init_and_batches
    init_state, batch_fn = make_init_and_batches(bundle, "cuda")
    driver = TrainDriver(
        DriverConfig(total_steps=total, ckpt_dir=ckpt_dir,
                     ckpt_every=TRAIN_CKPT_EVERY, keep=1,
                     async_save=True),
        bundle.step_fn, init_state, batch_fn,
        injector=FailureInjector(fail_at))
    try:
        return driver.run(), driver.step_times, None
    except RuntimeError as e:
        driver.mgr.wait()
        return None, driver.step_times, str(e)


def run_steps(torch, bundle, steps: int = TRAIN_STEPS):
    """``steps`` steps of ``bundle`` from its seeded init on the card, no
    driver and no checkpoint, the launch counts and the peak memory reset
    first: (params, opt state, history, step walls, memory, batch_fn);
    memory is ``max_memory_allocated`` and ``own_peak_bytes``, the peak
    above what was allocated before the run (the state a caller holds
    meanwhile, or an earlier phase's)."""
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.train import make_init_and_batches
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launches()
    init_state, batch_fn = make_init_and_batches(bundle, "cuda")
    params, opt = init_state()
    history, walls = [], []
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = bundle.step_fn(params, opt, *batch_fn(step))
        history.append({"step": step,
                        **{k: float(v) for k, v in m.items()}})
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return (params, opt, history, walls, {"max_memory_allocated": peak,
                                          "own_peak_bytes": peak - held},
            batch_fn)


def same_bits(torch, a, b) -> bool:
    """Two trees (``repro_torch.pytree``) with equal key paths whose
    tensor leaves are equal bit for bit (type, shape, bytes) and whose
    other leaves are equal."""
    from repro_torch.pytree import flatten
    fa, fb = flatten(a), flatten(b)
    if [k for k, _ in fa] != [k for k, _ in fb]:
        return False
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    for (_, x), (_, y) in zip(fa, fb):
        if not torch.is_tensor(x):
            if torch.is_tensor(y) or x != y:
                return False
        elif not (torch.is_tensor(y) and x.dtype == y.dtype
                  and x.shape == y.shape and torch.equal(
                      x.view(ints[x.element_size()]),
                      y.view(ints[y.element_size()]))):
            return False
    return True


def bwd_inputs(torch, gen, B, S, Hq, Hkv, hd, dt):
    def draw(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    return (draw((B, S, Hq, hd)), draw((B, S, Hkv, hd)),
            draw((B, S, Hkv, hd)), draw((B, S, Hq, hd)))


def check_bwd(torch, got, want, dt) -> dict:
    """The backward kernel's (dq, dk, dv) against the plain version's."""
    errs, rels = [], []
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        rel = float(((g - w).norm(dim=-1)
                     / w.norm(dim=-1).clamp_min(1e-3 * scale)).max())
        if dt == torch.float32:
            ok = bool(torch.allclose(g, w, atol=BWD_F32_TOL,
                                     rtol=BWD_F32_TOL))
        else:
            ok = err <= BWD_BF16_TOL * scale and rel <= BWD_BF16_TOL
        require(ok, f"check (a): flash_attention_bwd's {name} disagrees "
                    f"with flash_attention_bwd_ref in {dt}: max abs err "
                    f"{err} (largest {scale}), max row relative L2 {rel}")
        errs.append(err)
        rels.append(rel)
    return {"max_abs_err": max(errs), "max_row_rel_l2": max(rels)}


def check_forward_lse(torch, fops, q, k, v, dt) -> tuple:
    """Check (a)'s forward part: the lse-writing instance's output equals
    the serving instance's bit for bit and the plain version's at the
    kernels row's tolerance, its lse the plain one's at ``LSE_TOL``.
    Returns (the kernel's o and lse, the plain lse, the errors)."""
    o, lse = fops.flash_attention_cuda(q, k, v, True, return_lse=True)
    serving = fops.flash_attention_cuda(q, k, v, True)
    bits = torch.int16 if dt == torch.bfloat16 else torch.int32
    require(torch.equal(o.view(bits), serving.view(bits)),
            f"check (a): flash_attention's output with return_lse differs "
            f"from the serving instance's in {dt}")
    del serving
    o_ref, lse_ref = fops.flash_attention_ref(q, k, v, True, return_lse=True)
    if dt == torch.bfloat16:
        o_err, _ = check_bf16_attention(torch, o, o_ref,
                                        "check (a): flash_attention with "
                                        "return_lse")
        tol = LSE_TOL[0]
    else:
        o_err = float((o - o_ref).abs().max())
        require(torch.allclose(o, o_ref, atol=ATTN_F32_TOL[0],
                               rtol=ATTN_F32_TOL[1]),
                f"check (a): flash_attention with return_lse disagrees "
                f"with its plain version in float32: max abs err {o_err}")
        tol = LSE_TOL[1]
    del o_ref
    lse_err = float((lse - lse_ref).abs().max())
    require(torch.allclose(lse, lse_ref, atol=tol, rtol=tol),
            f"check (a): flash_attention's lse disagrees with the plain "
            f"version's in {dt}: max abs err {lse_err} (atol = rtol = {tol})")
    return o, lse, lse_ref, {"o_max_abs_err": o_err,
                             "lse_max_abs_err": lse_err,
                             "lse_tolerance": tol,
                             "o_equals_serving_bitwise": True}


def check_grad_ref(torch, fops) -> dict:
    """Check (d): the gradients of one float32 granite-8b layer at full
    width through the kernels against autograd through
    ``flash_attention_ref``, the rest of the model the same."""
    from repro_torch.config import RunOptions
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import make_init_and_batches
    from repro_torch.models import transformer
    from repro_torch.pytree import flatten, leaves

    opts = RunOptions(remat=True, seq_parallel=False)
    bundle = train_bundle(TRAIN_ARCH, 1, opts, GRAD_REF_BATCH, GRAD_REF_SEQ,
                          dtype="float32")
    cfg = bundle.cfg
    init_state, batch_fn = make_init_and_batches(bundle, "cuda")
    params = init_state()[0]
    tok, tgt = batch_fn(0)

    def loss_and_grads():
        loss = transformer.lm_loss(params, tok, tgt, cfg, opts)
        grads = torch.autograd.grad(loss, leaves(params))
        return float(loss.detach()), grads

    def plain_attention(q, k, v, causal=True, *, q_offset=None,
                        kv_valid_len=None, arm=None):
        return fops.flash_attention_ref(q, k, v, causal, q_offset=q_offset,
                                        kv_valid_len=kv_valid_len)

    reset_launches()
    loss, grads = loss_and_grads()
    launched = {k: LAUNCHES[k] for k in ("flash_attention", "attn_scalar",
                                         "flash_attention_bwd",
                                         "bwd_scalar")}
    want = {"flash_attention": 2, "attn_scalar": 2,
            "flash_attention_bwd": 1, "bwd_scalar": 1}
    require(launched == want,
            f"check (d): launches {launched}, expected {want} (forward and "
            f"remat recompute on the float32 route, one backward)")
    kernel_attention = transformer.gqa_attention
    transformer.gqa_attention = plain_attention
    try:
        loss_ref, grads_ref = loss_and_grads()
    finally:
        transformer.gqa_attention = kernel_attention
    torch.cuda.synchronize()
    require(LAUNCHES["flash_attention"] == 2
            and LAUNCHES["flash_attention_bwd"] == 1,
            "check (d): the plain side launched an attention kernel")
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads)))
    norm_ref = float(torch.sqrt(sum((g * g).sum() for g in grads_ref)))
    worst, worst_name = 0.0, None
    for (path, _), g, w in zip(flatten(params), grads, grads_ref):
        share = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
        if share >= worst:
            worst, worst_name = share, "/".join(map(str, path))
    out = {"arch": TRAIN_ARCH, "layers": 1, "dtype": "float32",
           "tf32": False, "remat": True,
           "tokens": {"batch": GRAD_REF_BATCH, "seq": GRAD_REF_SEQ},
           "loss": loss, "loss_plain": loss_ref, "grad_norm": norm,
           "grad_norm_plain": norm_ref,
           "max_err_of_largest": worst, "worst_leaf": worst_name,
           "leaves": len(grads), "tolerance": GRAD_REF_TOL,
           "launches": launched}
    require(abs(loss - loss_ref) <= GRAD_REF_TOL * abs(loss_ref)
            and abs(norm - norm_ref) <= GRAD_REF_TOL * norm_ref
            and worst <= GRAD_REF_TOL,
            f"check (d): the kernels' gradients disagree with autograd "
            f"through flash_attention_ref: {out}")
    return out


def train_dots(torch, opts, history, launches, want) -> dict:
    """Phase train's ``remat_policy="dots"`` run: the uninterrupted steps
    again from the same masters and batches under the selective
    checkpoint that keeps the matmul outputs. Its losses and grad norms
    must equal the ``"nothing"`` run's (``history``) within
    ``TRAIN_DOTS_REL`` relative, and it launches what that run did (the
    recompute launches the attention kernel again: it is not a matmul).
    Step walls and the peak memory beside the other policy's."""
    import dataclasses
    from repro_torch.kernels import LAUNCHES

    dopts = dataclasses.replace(opts, remat_policy="dots")
    bundle = train_bundle(TRAIN_ARCH, TRAIN_LAYERS, dopts)
    params, opt, hist, times, mem, _ = run_steps(torch, bundle)
    got = {k: LAUNCHES[k] for k in launches}
    require(got == want,
            f"train dots: launches {got}, expected {want} (the recompute "
            f"launches the attention forward again)")
    worst = 0.0
    for h, w in zip(hist, history):
        for key in ("loss", "grad_norm"):
            worst = max(worst, abs(h[key] - w[key]) / abs(w[key]))
    require(worst <= TRAIN_DOTS_REL,
            f"train dots: loss or grad norm {worst} relative from the "
            f"'nothing' policy's (bound {TRAIN_DOTS_REL}): {hist} against "
            f"{history}")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"remat_policy": "dots", "history": hist, "step_wall_s": times,
            "max_rel_diff_vs_nothing": worst, "bound": TRAIN_DOTS_REL,
            "launches": got, **mem}


def phase_train(torch) -> dict:
    """Phase 15: LM training on the card (granite-8b cut in depth through
    the fault-tolerant driver, then olmoe-1b-7b cut in depth), with checks
    (a)-(d)."""
    import math
    import shutil
    from repro_torch.config import RunOptions
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    opts = RunOptions(remat=True, seq_parallel=False)
    bundle = train_bundle(TRAIN_ARCH, TRAIN_LAYERS, opts)
    cfg = bundle.cfg
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"phase": "train", "arch": TRAIN_ARCH, "dtype": cfg.dtype,
           "masters": "float32", "opts": {"remat": True, "loss_chunk":
                                          opts.loss_chunk, "moe_groups":
                                          opts.moe_groups},
           "reduced": {"n_layers": [36, TRAIN_LAYERS],
                       "seq_len": [4096, TRAIN_SEQ],
                       "global_batch": [256, TRAIN_BATCH]},
           "params": cfg.param_count(), "tokens_per_step": tokens}

    # -- the uninterrupted run, the step itself with no driver and no
    # checkpoint, counted: forward + remat recompute + backward of every
    # layer each step
    t0 = time.perf_counter()
    params, opt, history, ref_times, mem, batch_fn = run_steps(torch,
                                                               bundle)
    t_ref = time.perf_counter() - t0
    launches = {k: LAUNCHES[k] for k in ("flash_attention", "attn_wgmma",
                                         "flash_attention_bwd", "bwd_wgmma")}
    L = cfg.n_layers
    want = {"flash_attention": 2 * L * TRAIN_STEPS,
            "attn_wgmma": 2 * L * TRAIN_STEPS,
            "flash_attention_bwd": L * TRAIN_STEPS,
            "bwd_wgmma": L * TRAIN_STEPS}
    require(launches == want,
            f"check (c): launches {launches}, expected {want} (forward and "
            f"remat recompute on wgmma, one backward on wgmma, per layer "
            f"and step)")
    require(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                for h in history),
            f"check (b): a loss or grad norm is not finite: {history}")
    # the uninterrupted state is kept for the resumed one to equal
    dots = train_dots(torch, opts, history, launches, want)

    # -- crash after the checkpoint of step 2, then resume
    crash_dir = os.path.join(TRAIN_DIR, "crash")
    t0 = time.perf_counter()
    first, _, err = run_driver(torch, bundle, crash_dir, TRAIN_STEPS,
                               fail_at=TRAIN_CKPT_EVERY)
    require(first is None and err is not None and "injected" in err,
            f"train: the injected crash did not happen ({err})")
    from repro_torch.checkpoint import latest_step
    saved = latest_step(crash_dir)
    require(saved == TRAIN_CKPT_EVERY - 1,
            f"train: latest checkpoint {saved} after the crash, expected "
            f"{TRAIN_CKPT_EVERY - 1}")
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    resumed, _, err = run_driver(torch, bundle, crash_dir, TRAIN_STEPS)
    torch.cuda.synchronize()
    require(err is None, f"train: the resumed run failed: {err}")
    t_resume = time.perf_counter() - t1
    got = resumed["history"]
    require(got == history[TRAIN_CKPT_EVERY:],
            f"train: resumed history {got} differs from the uninterrupted "
            f"{history[TRAIN_CKPT_EVERY:]}")
    params_equal = same_bits(torch, resumed["params"], params)
    opt_equal = same_bits(torch, resumed["opt_state"], opt)
    require(params_equal and opt_equal,
            f"train: the resumed run's state after its step differs from "
            f"the uninterrupted run's (parameters equal: {params_equal}, "
            f"AdamW state equal: {opt_equal})")
    del params, opt

    # -- check (b): the repeated batch's loss falls, from the resumed state
    params, opt = resumed["params"], resumed["opt_state"]
    del resumed
    tok, tgt = batch_fn(0)
    repeated = []
    for _ in range(TRAIN_REPEATS):
        params, opt, m = bundle.step_fn(params, opt, tok, tgt)
        repeated.append(float(m["loss"]))
    with torch.no_grad():
        repeated.append(float(transformer.lm_loss(params, tok, tgt, cfg,
                                                  opts)))
    require(all(math.isfinite(x) for x in repeated)
            and repeated[-1] < repeated[0],
            f"check (b): the loss of a repeated batch does not fall: "
            f"{repeated}")
    del params, opt, m
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    step_wall = statistics.median(ref_times)
    out.update({
        "history": history, "step_wall_s": ref_times,
        "tokens_per_s": tokens / step_wall, "t_uninterrupted_s": t_ref,
        "t_crash_run_s": t1 - t0, "t_resume_s": t_resume,
        "checkpoint": {"after_step": TRAIN_CKPT_EVERY - 1, "crashed_at":
                       TRAIN_CKPT_EVERY, "resumed_history": got,
                       "resume_exact": True,
                       "resumed_state_equal_bitwise": True},
        "repeated_batch_loss": repeated,
        "launches": launches, "launches_per_step":
            {k: v // TRAIN_STEPS for k, v in launches.items()},
        **mem, "remat_dots": dots})

    # -- olmoe-1b-7b at full width, 2 of 16 layers: the MoE backward
    mopts = RunOptions(remat=True, seq_parallel=False, moe_groups=4)
    mbundle = train_bundle(MOE_ARCH, MOE_TRAIN_LAYERS, mopts)
    params, opt, mhist, mtimes, mmem, _ = run_steps(torch, mbundle,
                                                     MOE_TRAIN_STEPS)
    mlaunch = {k: LAUNCHES[k] for k in ("flash_attention", "attn_wgmma",
                                        "flash_attention_bwd", "bwd_wgmma")}
    Lm = MOE_TRAIN_LAYERS
    mwant = {"flash_attention": 2 * Lm * MOE_TRAIN_STEPS,
             "attn_wgmma": 2 * Lm * MOE_TRAIN_STEPS,
             "flash_attention_bwd": Lm * MOE_TRAIN_STEPS,
             "bwd_wgmma": Lm * MOE_TRAIN_STEPS}
    require(mlaunch == mwant,
            f"check (c): olmoe launches {mlaunch}, expected {mwant}")
    require(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                for h in mhist),
            f"check (b): an olmoe loss or grad norm is not finite: {mhist}")
    out["moe"] = {"arch": MOE_ARCH, "reduced": {
        "n_layers": [16, Lm], "seq_len": [4096, TRAIN_SEQ],
        "global_batch": [256, TRAIN_BATCH]}, "moe_groups": 4,
        "history": mhist, "step_wall_s": mtimes,
        "tokens_per_s": tokens / mtimes[-1], "launches": mlaunch,
        **mmem}
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()

    # -- check (a): the lse-writing forward against its serving instance
    # and the plain version, and the backward kernel against its plain
    # version fed the plain lse, on the step's shape (bf16, wgmma), the
    # step's shape at hd BWD_MMA_HD (bf16, mma) and a float32 shape; the
    # first case's inputs are kept for the kernels row
    gen = torch.Generator(device="cuda").manual_seed(11)
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    step_shape = (TRAIN_BATCH, TRAIN_SEQ, Hq, Hkv)
    checks = {}
    for name, (B, S, hq, hkv, d), dt, want_route in (
            ("bf16", (*step_shape, hd), torch.bfloat16, "wgmma"),
            ("bf16_mma", (*step_shape, BWD_MMA_HD), torch.bfloat16, "mma"),
            ("f32", BWD_F32_SHAPE, torch.float32, "scalar")):
        q, k, v, dout = bwd_inputs(torch, gen, B, S, hq, hkv, d, dt)
        o, lse, lse_ref, fwd = check_forward_lse(torch, fops, q, k, v, dt)
        route = fops.bwd_plan(q, k, v, o, dout)
        require(route == want_route,
                f"check (a): the backward takes route {route} in {dt} at "
                f"hd {d}, expected {want_route}")
        got = fops.flash_attention_bwd_cuda(q, k, v, o, lse, dout)
        again = fops.flash_attention_bwd_cuda(q, k, v, o, lse, dout)
        torch.cuda.synchronize()
        bits = torch.int16 if dt == torch.bfloat16 else torch.int32
        require(all(torch.equal(x.view(bits), y.view(bits))
                    for x, y in zip(got, again)),
                f"check (a): two launches of flash_attention_bwd on the same "
                f"inputs differ in {dt}")
        del again
        want = fops.flash_attention_bwd_ref(q, k, v, o, lse_ref, dout)
        checks[name] = {"shape": {"B": B, "S": S, "Hq": hq, "Hkv": hkv,
                                  "hd": d}, "route": f"bwd_{route}",
                        "repeat_bitwise_equal": True, **fwd,
                        **check_bwd(torch, got, want, dt)}
        if name == "bf16":
            bwd_args = (q, k, v, o, lse, dout)
        del q, k, v, dout, o, lse, lse_ref, got, want
        torch.cuda.empty_cache()
    out["check_a"] = {**checks, "tolerance": {
        "bfloat16": {"of_largest": BWD_BF16_TOL, "row_rel_l2": BWD_BF16_TOL,
                     "lse": LSE_TOL[0]},
        "float32": {"atol": BWD_F32_TOL, "rtol": BWD_F32_TOL,
                    "lse": LSE_TOL[1]}}}
    out["check_d"] = check_grad_ref(torch, fops)
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return {"launches": launches["flash_attention_bwd"],
            "per_step": launches["flash_attention_bwd"] // TRAIN_STEPS,
            "steps": TRAIN_STEPS, "layers": L,
            "moe_launches": mlaunch["flash_attention_bwd"],
            "check_a": checks, "bwd_args": bwd_args}


def flash_attention_bwd_row(torch, train) -> dict:
    """``flash_attention_bwd`` at the training step's shape (granite-8b,
    B 2, S 4096, causal, bf16) on check (a)'s inputs: timed beside its
    plain version, SDPA's backward and the bound; launches from phase
    train."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    args = train.pop("bwd_args")
    q, k, v, o, lse, dout = args
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    err = train["check_a"]["bf16"]         # check (a) of phase train
    ms = cuda_ms(torch, fops.flash_attention_bwd_cuda, lambda: args, reps=5)
    plain_ms = cuda_ms(torch, fops.flash_attention_bwd_ref, lambda: args,
                       reps=3)
    torch.cuda.empty_cache()
    device_ms = graph_ms(torch, lambda: fops.flash_attention_bwd_cuda(*args),
                         n=10)
    # SDPA's backward alone: one forward kept, its graph walked again
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    sd = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                        enable_gqa=True)
    g_sd = dout.transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(sd, leaves, g_sd, retain_graph=True)

    library_ms = cuda_ms(torch, sdpa_bwd, reps=5)
    del sd, leaves
    pairs = S * (S + 1) // 2
    n_ops = 10 * hd * pairs * B * Hq
    nbytes = 2 * (4 * B * S * Hq * hd + 4 * B * S * Hkv * hd) + 4 * B * Hq * S
    kernel_route = fops.bwd_plan(q, k, v, o, dout)
    del q, k, v, dout, o, lse, args
    torch.cuda.empty_cache()
    lim = bound(nbytes, n_ops / BF16_OPS_PER_S * 1e3)
    return {"name": "flash_attention_bwd", "route": "cuda",
            "kernel_route": f"bwd_{kernel_route}",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "none (no TPU kernel has a backward; the JAX "
                        "package trains through chunked_attention, "
                        "src/repro/models/transformer.py:246)",
            "launches": train["launches"], "max_abs_err": err["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms, **lim,
            "library_ms": library_ms, "device_ms": device_ms,
            "device_ms_launches": 10,
            "device_share_of_bound": lim["bound_ms"] / device_ms,
            "ms_over_library": ms / library_ms,
            "ops": n_ops, "pairs_per_head": pairs,
            "max_row_rel_l2": err["max_row_rel_l2"],
            "shape": {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "hd": hd,
                      "causal": True, "dtype": "bfloat16"},
            "ops_counted": "10 hd per visible (query, key) pair and q-head "
                           "(5 products) at BF16_OPS_PER_S",
            "library_call": "torch.autograd.grad of "
                            "torch.nn.functional.scaled_dot_product_attention"
                            " (is_causal, enable_gqa): its backward alone",
            "tolerance": {"of_largest": BWD_BF16_TOL,
                          "row_rel_l2": BWD_BF16_TOL},
            "launches_from": "phase train (granite-8b, the uninterrupted "
                             "run: one a layer and step)",
            "launches_per_step": train["per_step"],
            "train_steps": train["steps"], "train_layers": train["layers"],
            "moe_train_launches": train["moe_launches"]}


# ----------------------------------------------------------------------
# phase gnn: the GNN zoo at its published configs
# ----------------------------------------------------------------------

# (arch, shape) of the train steps: each arch's CONFIG at full width and
# depth, three AdamW steps on one batch through its own bundle's step
# (build_bundle(arch, shape).step_fn); the host graphs are the launcher's
# (generators.powerlaw(n_nodes, 4.0, seed=0): 2,708 nodes, and for
# minibatch_lg 232,965 nodes with 0.93 M edges, a cut of the Reddit
# graph's 114.6 M)
GNN_CASES = (("graphcast", "full_graph_sm"), ("meshgraphnet", "full_graph_sm"),
             ("schnet", "molecule"), ("graphsage-reddit", "minibatch_lg"))
GNN_STEPS = 3
# check (a): each arch at full width cut to GNN_CHECK_LAYERS layers, in
# float32 with TF32 off: the card's forward, loss and gradient norm against
# the port on the CPU from the same weights and batch, at rtol = atol =
# GNN_TOL (float32 sums in another order on either side: about 1e-6)
GNN_CHECK_LAYERS = 2
GNN_TOL = 1e-4
# the large forward: graphsage-reddit's CONFIG on ogb_products (2,449,029
# nodes, d_feat 100), the graph core/generators.py's powerlaw law drawn on
# the card (a host build of 61.9 M edges takes minutes) at the published
# 61,859,140 edge draws, self loops and repeats dropped, in the bundle's
# 61,859,328 edge slots; check (c) on GNN_BALL_SAMPLE seeded nodes
GNN_LARGE = ("graphsage-reddit", "ogb_products")
GNN_BALL_SAMPLE = 64
# check (d): crash-resume through TrainDriver (phase train's run_driver:
# a checkpoint after two steps, a crash at the third)
GNN_CRASH_ARCH = "meshgraphnet"
GNN_DIR = os.path.join(ROOT, "build", "smoke_gnn")


def cpu_params(torch, params):
    """A CPU copy of a parameter tree (float32 ``nn.Parameter`` leaves)."""
    from repro_torch.pytree import tree_map
    return tree_map(lambda p: torch.nn.Parameter(p.detach().cpu()), params)


def close(torch, got, want, tol: float) -> dict:
    """``got`` (any device) against ``want`` (CPU) at atol = rtol = tol."""
    got = got.detach().cpu().double()
    want = want.detach().cpu().double()
    excess = float(((got - want).abs() - tol * want.abs()).max())
    return {"max_abs_err": float((got - want).abs().max()),
            "ok": bool(torch.isfinite(got).all()) and excess <= tol}


def gnn_check_cpu(torch, arch, bundle, batch, mol: bool) -> dict:
    """Check (a): ``bundle``'s config cut to GNN_CHECK_LAYERS layers, the
    card's forward, loss and gradient norm against the CPU's."""
    import dataclasses
    from repro_torch.launch import steps
    from repro_torch.models import gnn
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(bundle.cfg, n_layers=GNN_CHECK_LAYERS)
    cut = steps.gnn_bundle(arch, cfg, bundle.spec, bundle.opts)
    gen = torch.Generator(device="cuda").manual_seed(1)
    p_gpu = gnn.init_gnn_params(cfg, *steps.gnn_dims(cfg, bundle.spec),
                                generator=gen, device="cuda")
    p_cpu = cpu_params(torch, p_gpu)
    b_cpu = {k: v.cpu() for k, v in batch.items()}
    flat = gnn.flatten_molecules if mol else (lambda b: b)
    t0 = time.perf_counter()
    with torch.no_grad():
        o_gpu = gnn.gnn_forward(p_gpu, flat(batch), cfg)
        o_cpu = gnn.gnn_forward(p_cpu, flat(b_cpu), cfg)
    _, _, m_gpu = cut.step_fn(p_gpu, adamw_init(p_gpu), batch)
    _, _, m_cpu = cut.step_fn(p_cpu, adamw_init(p_cpu), b_cpu)
    res = {"layers": GNN_CHECK_LAYERS, "forward": close(torch, o_gpu, o_cpu,
                                                        GNN_TOL)}
    for k in ("loss", "grad_norm"):
        res[k] = {"card": float(m_gpu[k]), "cpu": float(m_cpu[k]),
                  **close(torch, m_gpu[k], m_cpu[k], GNN_TOL)}
    res["t_s"] = time.perf_counter() - t0
    require(all(res[k]["ok"] for k in ("forward", "loss", "grad_norm")),
            f"gnn check (a): {arch} at {GNN_CHECK_LAYERS} layers, the card "
            f"against the CPU beyond {GNN_TOL}: {res}")
    return res


def gnn_train_case(torch, arch: str, shape: str) -> dict:
    """GNN_STEPS AdamW steps of ``arch``'s published config on batch 0 of
    its launcher's stream, with checks (a) and (b)."""
    import math
    from repro_torch.launch import steps
    from repro_torch.launch.train import make_init_and_batches
    from repro_torch.models import gnn
    bundle = steps.build_bundle(arch, shape)
    mol = bundle.kind == "gnn_mol"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    init_state, batch_fn = make_init_and_batches(bundle, "cuda")
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    (batch,) = batch_fn(0)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    params, opt = init_state()
    losses, norms, walls = [], [], []
    for _ in range(GNN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = bundle.step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        walls.append(time.perf_counter() - t0)
    loss_fn = gnn.gnn_molecule_loss if mol else gnn.gnn_loss
    with torch.no_grad():
        losses.append(float(loss_fn(params, batch, bundle.cfg)))
    require(all(math.isfinite(x) for x in losses + norms),
            f"gnn check (b): {arch}: a loss or grad norm is not finite: "
            f"{losses}, {norms}")
    require(losses[-1] < losses[0],
            f"gnn check (b): {arch}: the loss of the repeated batch does not "
            f"fall over {GNN_STEPS} steps: {losses}")
    rec = {"shape": shape, "kind": bundle.kind,
           "params": bundle.meta["params"], "layers": bundle.cfg.n_layers, "d_hidden": bundle.cfg.d_hidden,
           "inputs": {k: list(v[0]) for k, v in bundle.inputs.items()},
           "t_graph_s": t_graph, "t_batch_s": t_batch,
           "step_wall_s": walls, "loss": losses, "grad_norm": norms,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    if not mol:
        rec["real"] = {"nodes": int(batch["node_mask"].sum()),
                       "edges": int(batch["edge_mask"].sum())}
        rec["order_ms"] = order_ms(torch, batch)
    del params, opt, m
    rec["check_a"] = gnn_check_cpu(torch, arch, bundle, batch, mol)
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def device_powerlaw(torch, n: int, draws: int, gen):
    """``core/generators.py``'s powerlaw law drawn on the card: ``draws``
    uniform sources, destinations 70% Pareto-skewed towards low ids and 30%
    uniform; self loops and repeats dropped. (src, dst) int64, sorted by
    (dst, src) as ``Graph.edges_by_dst``."""
    dev = "cuda"
    src = torch.randint(0, n, (draws,), generator=gen, device=dev)
    u = torch.rand(draws, generator=gen, device=dev, dtype=torch.float64)
    zipf = torch.clamp((((1.0 - u) ** (-1.0 / 1.5) - 1.0) * n * 0.01).long(),
                       max=n - 1)
    del u
    uni = torch.randint(0, n, (draws,), generator=gen, device=dev)
    pick = torch.rand(draws, generator=gen, device=dev) < 0.7
    dst = torch.where(pick, zipf, uni)
    del zipf, uni, pick
    keep = src != dst
    key = torch.unique(dst[keep] * n + src[keep])
    return key % n, key // n


def order_ms(torch, batch: dict) -> float:
    """CUDA-event ms of the fixed order of summation's setup for one step
    on ``batch`` (a flat graph): the destination sort of ``EdgeList`` (the
    destination gather's backward adds through it too) and the sort by
    source that the source gather's backward adds through."""
    from repro_torch.models import gnn

    def setup():
        ed = gnn.EdgeList(batch["edge_src"], batch["edge_dst"],
                          batch["edge_mask"], batch["nodes"].shape[0])
        return ed.src_rows.ids, ed.by_key.ids

    return cuda_ms(torch, setup, reps=3)


def gnn_large_forward(torch) -> dict:
    """graphsage-reddit's forward under no_grad at ogb_products, and
    check (c): 64 seeded nodes' output rows against a CPU forward on their
    2-hop in-ball.

    The forward's gathered rows (24.7 and 31.7 GB) take most of the card,
    so its memory comes from expandable segments: a freed block's pages go
    back to the device even where a live tensor shares its segment. With
    fixed segments, small tensors placed in the freed layer-1 rows' block
    (and in the graph draw's) hold it, and whether layer 2's rows fit
    depends on the allocator's history."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        return large_forward_run(torch)
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def large_forward_run(torch) -> dict:
    """The body of :func:`gnn_large_forward`."""
    import numpy as np
    from repro_torch.launch import steps
    from repro_torch.models import gnn
    arch, shape = GNN_LARGE
    bundle = steps.build_bundle(arch, shape)
    cfg = bundle.cfg
    n, draws = bundle.dims["n_nodes"], bundle.dims["n_edges"]
    (N, d_in), _ = bundle.inputs["nodes"]
    (E,), _ = bundle.inputs["edge_src"]
    d_out = steps.gnn_dims(cfg, bundle.spec)[1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    src, dst = device_powerlaw(torch, n, draws, gen)
    m = int(src.shape[0])
    require(m <= E, f"gnn: {m} edges in {E} slots")
    batch = {"nodes": torch.zeros((N, d_in), device="cuda"),
             "edge_src": torch.zeros(E, dtype=torch.int32, device="cuda"),
             "edge_dst": torch.zeros(E, dtype=torch.int32, device="cuda"),
             "edge_mask": torch.arange(E, device="cuda") < m}
    batch["nodes"][:n] = torch.randn((n, d_in), generator=gen, device="cuda")
    batch["edge_src"][:m] = src
    batch["edge_dst"][:m] = dst
    src_h, dst_h = src.cpu().numpy(), dst.cpu().numpy()   # for check (c)
    del src, dst
    params = gnn.init_gnn_params(cfg, d_in, d_out, generator=gen,
                                 device="cuda")
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = gnn.gnn_forward(params, batch, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    require(bool(torch.isfinite(out).all()) and out.shape == (N, d_out),
            f"gnn: the ogb_products forward {tuple(out.shape)} is not finite")

    # check (c): the rows of GNN_BALL_SAMPLE nodes against a CPU forward on
    # their 2-hop in-ball (under mean aggregation and per-row
    # normalisation a row depends on that ball alone)
    t0 = time.perf_counter()
    sample = np.sort(np.random.default_rng(0).choice(n, GNN_BALL_SAMPLE,
                                                     replace=False))

    def in_edges(vs):           # the ids of the in-edges of vs, in order
        lo = np.searchsorted(dst_h, vs)
        hi = np.searchsorted(dst_h, vs, side="right")
        return np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)])

    hop1 = np.union1d(sample, src_h[in_edges(sample)])
    eids = in_edges(hop1)
    ball = np.union1d(hop1, src_h[eids])
    rows = torch.from_numpy(ball).cuda()
    sub = {"nodes": batch["nodes"].index_select(0, rows).cpu(),
           "edge_src": torch.from_numpy(np.searchsorted(ball, src_h[eids])),
           "edge_dst": torch.from_numpy(np.searchsorted(ball, dst_h[eids]))}
    with torch.no_grad():
        want = gnn.gnn_forward(cpu_params(torch, params), sub, cfg)
    want = want[torch.from_numpy(np.searchsorted(ball, sample))]
    got = out[torch.from_numpy(sample).cuda()]
    check_c = {"sample": GNN_BALL_SAMPLE, "ball_nodes": int(ball.size),
               "ball_edges": int(eids.size), **close(torch, got, want,
                                                     GNN_TOL),
               "t_s": time.perf_counter() - t0}
    require(check_c["ok"], f"gnn check (c): ogb_products rows against their "
                           f"2-hop balls on the CPU: {check_c}")
    # the cost of the fixed order at this size: the edge sort, and layer
    # 1's segmented sum beside one index_add_ of the same rows (atomics,
    # no fixed order)
    del out
    ed = gnn.EdgeList(batch["edge_src"], batch["edge_dst"],
                      batch["edge_mask"], N)
    # the sorted keys: a masked edge's is the extra segment N
    key = ed.by_key.idx.index_select(0, ed.perm)
    with torch.no_grad():
        rows = ed.gather_src(batch["nodes"])
        acc = torch.zeros((N + 1, d_in), device="cuda")
        order = {
            "edge_sort_ms": cuda_ms(torch, lambda: gnn.EdgeList(
                batch["edge_src"], batch["edge_dst"], batch["edge_mask"], N),
                reps=3),
            "segment_sum_ms": cuda_ms(
                torch, lambda: ed.by_key.reduce(rows, "sum"), reps=3),
            "index_add_ms": cuda_ms(
                torch, lambda: acc.zero_().index_add_(0, key, rows),
                reps=3)}
        order["max_abs_diff"] = float(
            (ed.by_key.reduce(rows, "sum") - acc).abs().max())
    del ed, rows, acc, key
    # the forward gathers a row for each of the E edge slots (a masked
    # edge's row goes to the dropped segment, as in the JAX package)
    gathered = {f"layer_{i + 1}": E * w.shape[0] * 4 for i, w in
                enumerate(lp["w_self"] for lp in params["layers"])}
    # the least the forward must move: the features and edge ids read
    # once, the output written once
    least = N * d_in * 4 + E * (4 + 4 + 1) + N * d_out * 4
    del batch, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "shape": shape, "nodes": n, "d_feat": d_in,
            "edge_draws": draws, "edges": m, "edge_slots": E,
            "t_data_s": t_data, "forward_wall_s": walls,
            "gathered_bytes": gathered, "least_bytes": least,
            "bound_ms": least / HBM_BYTES_PER_S * 1e3,
            "gathered_ms": 3 * sum(gathered.values()) / HBM_BYTES_PER_S
            * 1e3,
            "max_memory_allocated": peak, "memory_before": base,
            "check_c": check_c, "fixed_order": order}


def phase_gnn(torch) -> dict:
    """Phase 16: the GNN zoo on the card, with checks (a)-(d)."""
    import shutil
    from repro_torch.checkpoint import latest_step
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(GNN_DIR, ignore_errors=True)
    reset_launches()
    out = {"phase": "gnn", "steps": GNN_STEPS, "tolerance": GNN_TOL,
           "archs": {arch: gnn_train_case(torch, arch, shape)
                     for arch, shape in GNN_CASES}}
    out["large_forward"] = gnn_large_forward(torch)

    # check (d): crash after the checkpoint of step 2, then an exact resume
    bundle = steps.build_bundle(GNN_CRASH_ARCH, "full_graph_sm")
    t0 = time.perf_counter()
    ref, _, err = run_driver(torch, bundle, os.path.join(GNN_DIR, "ref"),
                             TRAIN_STEPS)
    require(err is None, f"gnn check (d): the uninterrupted run failed: {err}")
    crash_dir = os.path.join(GNN_DIR, "crash")
    first, _, err = run_driver(torch, bundle, crash_dir, TRAIN_STEPS,
                               fail_at=TRAIN_CKPT_EVERY)
    require(first is None and err is not None and "injected" in err,
            f"gnn check (d): the injected crash did not happen ({err})")
    saved = latest_step(crash_dir)
    require(saved == TRAIN_CKPT_EVERY - 1,
            f"gnn check (d): latest checkpoint {saved} after the crash")
    resumed, _, err = run_driver(torch, bundle, crash_dir, TRAIN_STEPS)
    require(err is None, f"gnn check (d): the resumed run failed: {err}")
    require(resumed["history"] == ref["history"][TRAIN_CKPT_EVERY:],
            f"gnn check (d): resumed {resumed['history']} against "
            f"{ref['history'][TRAIN_CKPT_EVERY:]}")
    out["check_d"] = {"arch": GNN_CRASH_ARCH, "history": ref["history"],
                      "resumed": resumed["history"], "exact": True,
                      "t_s": time.perf_counter() - t0}
    del ref, resumed
    shutil.rmtree(GNN_DIR, ignore_errors=True)
    out["kernel_launches"] = sum(LAUNCHES.values())
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return out


# ----------------------------------------------------------------------
# phase recsys: two-tower retrieval at its published config
# ----------------------------------------------------------------------

RECSYS_ARCH = "two-tower-retrieval"
RECSYS_SERVE = ("serve_p99", "serve_bulk")
RECSYS_CALLS = 3                     # cold once, warm twice
# train_batch's 65,536 cut to 32,768: at 65,536 the (B, B) logits, their
# log-softmax and its gradient are about 52 GB beside the 30.1 GB of
# tables, gradients and AdamW moments
RECSYS_TRAIN_BATCH = 32768
RECSYS_STEPS = 3
# check (a): the card's scores against the CPU towers (the rows used
# copied over) at rtol = atol = RECSYS_TOL, on the serve_p99 batch and
# RECSYS_SAMPLE seeded candidates of the retrieval
RECSYS_TOL = 1e-4
RECSYS_SAMPLE = 65536


def cpu_towers(torch, params, user_ids, item_ids):
    """A CPU copy of the towers holding only the table rows of
    ``user_ids`` / ``item_ids`` (numpy, -1 pads allowed): (params, a map
    of user ids and of item ids to the copy's rows)."""
    import numpy as np
    from repro_torch.pytree import tree_map
    u = np.unique(user_ids[user_ids >= 0])
    i = np.unique(item_ids[item_ids >= 0])

    def rows(table, ids):
        return table.detach().index_select(
            0, torch.from_numpy(ids).cuda()).cpu()

    cpu = {"user_table": rows(params["user_table"], u),
           "item_table": rows(params["item_table"], i),
           "user_mlp": tree_map(lambda p: p.detach().cpu(),
                                params["user_mlp"]),
           "item_mlp": tree_map(lambda p: p.detach().cpu(),
                                params["item_mlp"])}

    def remap(ids, table_ids):
        return torch.from_numpy(np.where(ids >= 0, np.searchsorted(
            table_ids, np.maximum(ids, 0)), -1).astype(np.int64))

    return cpu, (lambda x: remap(x, u)), (lambda x: remap(x, i))


def timed_calls(torch, fn, *args) -> tuple:
    walls = []
    for _ in range(RECSYS_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, walls


def phase_recsys(torch) -> dict:
    """Phase 17: two-tower-retrieval on the card, with checks (a)-(c)."""
    import math
    import numpy as np
    from repro_torch.configs import get
    from repro_torch.data.recsys_data import InteractionStream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps
    from repro_torch.models import recsys
    from repro_torch.optim import adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launches()
    cfg = get(RECSYS_ARCH).CONFIG
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = recsys.init_recsys_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    torch.cuda.synchronize()
    out = {"phase": "recsys", "arch": RECSYS_ARCH,
           "params": recsys.recsys_param_count(cfg),
           "table_bytes": (cfg.n_users + cfg.n_items) * cfg.embed_dim * 4,
           "t_init_s": time.perf_counter() - t0, "serve": {}}

    def on_card(b):
        return {k: torch.from_numpy(v).cuda() for k, v in b.items()}

    # -- serving: pointwise scores at B 512 and 262,144
    checks = {}
    for shape in RECSYS_SERVE:
        bundle = steps.build_bundle(RECSYS_ARCH, shape)
        B = bundle.dims["batch"]
        data = InteractionStream(cfg, B, seed=0).batch_at(0)
        b = on_card(data)
        scores, walls = timed_calls(torch, bundle.step_fn, params,
                                    b["hist_ids"], b["item_ids"])
        require(bool(torch.isfinite(scores).all())
                and scores.shape == (B,), f"recsys: {shape} scores")
        out["serve"][shape] = {"batch": B, "wall_s": walls,
                               "pairs_per_s": B / min(walls[1:])}
        if shape == "serve_p99":             # check (a) on this batch
            cpu, umap, imap = cpu_towers(torch, params, data["hist_ids"],
                                         data["item_ids"])
            with torch.no_grad():
                want = recsys.score_candidates(
                    cpu, umap(data["hist_ids"]), imap(data["item_ids"]))
            checks["serve_p99"] = close(torch, scores, want, RECSYS_TOL)
        del b, scores

    # -- retrieval: one query against 1,000,000 candidates (padded), top 100
    bundle = steps.build_bundle(RECSYS_ARCH, "retrieval_cand")
    Nc = bundle.dims["n_candidates"]
    (Np,), _ = bundle.inputs["cand_ids"]
    cands = torch.full((Np,), -1, dtype=torch.int32, device="cuda")
    cands[:Nc] = torch.arange(Nc, dtype=torch.int32, device="cuda")
    hist = InteractionStream(cfg, 1, seed=0).batch_at(0)["hist_ids"]
    (vals, ids), walls = timed_calls(torch, bundle.step_fn, params,
                                     torch.from_numpy(hist).cuda(), cands)
    out["retrieval"] = {"candidates": Nc, "padded_to": Np,
                        "k": int(ids.shape[0]), "wall_s": walls,
                        "candidates_per_s": Nc / min(walls[1:])}
    # check (b): the card's own scores, stably sorted
    with torch.no_grad():
        u = recsys.user_tower(params, torch.from_numpy(hist).cuda())
        v = recsys.item_tower(params, torch.clamp(cands, min=0))
        s = torch.where(cands >= 0, (v @ u[0]).float(), -math.inf)
    del v
    order = torch.sort(s, descending=True, stable=True)[1][:ids.shape[0]]
    check_b = {"ids_equal": bool(torch.equal(ids, cands[order])),
               "vals_equal": bool(torch.equal(vals, s[order])),
               "padded_ids": int((ids < 0).sum())}
    require(check_b["ids_equal"] and check_b["vals_equal"]
            and check_b["padded_ids"] == 0,
            f"recsys check (b): the top {ids.shape[0]} against a stable "
            f"sort of the card's scores: {check_b}")
    out["check_b"] = check_b
    # check (a) on a seeded sample of the candidates
    pick = np.sort(np.random.default_rng(0).choice(Nc, RECSYS_SAMPLE,
                                                   replace=False))
    cpu, umap, imap = cpu_towers(torch, params, hist, pick)
    with torch.no_grad():
        want = recsys.item_tower(cpu, imap(pick)) @ recsys.user_tower(
            cpu, umap(hist))[0]
    checks["retrieval_sample"] = close(
        torch, s[torch.from_numpy(pick).cuda()], want, RECSYS_TOL)
    require(all(c["ok"] for c in checks.values()),
            f"recsys check (a): scores against the CPU towers beyond "
            f"{RECSYS_TOL}: {checks}")
    out["check_a"] = {**checks, "sample": RECSYS_SAMPLE,
                      "tolerance": RECSYS_TOL}
    del s, u, cands, vals, ids
    gc.collect()
    torch.cuda.empty_cache()

    # -- training: three AdamW steps on one batch of RECSYS_TRAIN_BATCH
    bundle = steps.build_bundle(RECSYS_ARCH, "train_batch",
                                overrides={"batch": RECSYS_TRAIN_BATCH})
    b = on_card(InteractionStream(cfg, RECSYS_TRAIN_BATCH,
                                  seed=0).batch_at(0))
    opt = adamw_init(params)
    torch.cuda.reset_peak_memory_stats()
    losses, norms, walls = [], [], []
    for _ in range(RECSYS_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = bundle.step_fn(params, opt, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        walls.append(time.perf_counter() - t0)
    with torch.no_grad():
        losses.append(float(recsys.recsys_loss(params, b, cfg)))
    require(all(math.isfinite(x) for x in losses + norms)
            and losses[-1] < losses[0],
            f"recsys check (c): losses {losses}, grad norms {norms}")
    out["train"] = {"batch": RECSYS_TRAIN_BATCH,
                    "reduced": {"batch": [65536, RECSYS_TRAIN_BATCH]},
                    "step_wall_s": walls, "loss": losses, "grad_norm": norms,
                    "examples_per_s": RECSYS_TRAIN_BATCH / min(walls[1:]),
                    "max_memory_allocated": torch.cuda.max_memory_allocated()}
    out["kernel_launches"] = sum(LAUNCHES.values())
    del params, opt, m, b
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return out


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
            "replaces": replaces,
            "launches": lm["launches"] + lm["mesh_launches"]["splitk"]
            + sum(lm["serve_launches"].values()),
            "launches_mesh_decode": lm["mesh_launches"]["splitk"],
            "launches_mesh_serve": lm["serve_launches"],
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
            "launches_from": "phase lm (prefill, decode_step, lm_forward)"
                             " and phase mesh_decode's decode_32k steps (one "
                             "split-K launch a slot and layer)",
            "launches_per_call": lm["per_call"], "calls": lm["calls"],
            "routes": lm["routes"], "kernel_route": head["route"],
            **shapes}


def f8_float32_q(torch, fops, q, k, v, kw) -> dict:
    """A float32 q over a float8 cache: one ``attn_scalar`` launch on the
    float32 copies, p rounded to bf16 against each row's max; its
    relative L2 error from the plain version (which rounds p alike) at
    most ``ATTN_F8_F32_SHARE`` of the plain version's own error when p is
    left unrounded (over float32 copies), and within the bf16 tolerance
    elementwise."""
    from repro_torch.kernels import LAUNCHES
    before = attn_counts(LAUNCHES, fops)
    got = fops.flash_attention_cuda(q, k, v, True, **kw)
    after = attn_counts(LAUNCHES, fops)
    taken = [r for r in after if after[r] > before[r]]
    require(taken == ["scalar"],
            f"a float32 q over the f8 cache took {taken}")
    want = fops.flash_attention_ref(q, k, v, True, **kw)
    unrounded = fops.flash_attention_ref(q, k.float(), v.float(), True,
                                         **kw)
    err = float((got - want).norm() / want.norm())
    gap = float((unrounded - want).norm() / want.norm())
    max_abs = float((got - want).abs().max())
    require(torch.allclose(got, want, atol=ATTN_BF16_TOL, rtol=ATTN_BF16_TOL)
            and err <= ATTN_F8_F32_SHARE * gap,
            f"attn_scalar over the f8 cache: relative L2 {err} from the "
            f"plain version against {gap} unrounded (share bound "
            f"{ATTN_F8_F32_SHARE}), max abs err {max_abs}")
    return {"route": "scalar", "rel_l2": err, "rel_l2_p_unrounded": gap,
            "share": err / gap, "share_bound": ATTN_F8_F32_SHARE,
            "max_abs_err": max_abs,
            "ms": cuda_ms(torch, lambda: fops.flash_attention_cuda(
                q, k, v, True, **kw))}


def flash_attention_f8_row(torch, lm, moonshot) -> dict:
    """Row 8': the split-K kernel over a float8 KV cache
    (``attn_splitk_f8``) at ``ATTN_F8_SHAPES`` on seeded inputs (k and v
    quantised with ``quantize_f8``, layer 1 of a two-layer cache whose
    keys past the valid length are NaN): held to its plain version at the
    bf16 tolerance and to the bf16 route on the dequantised bf16 copy of
    the same cache (the same values in the same order: bit for bit), at
    ``"decode"`` also a float32 q (``f8_float32_q``); timed beside both,
    ``scaled_dot_product_attention`` on the bf16 copy (SDPA reads no
    float8) and the bound with k and v at one byte. The
    row's launches are phase lm's float8 decode's."""
    import torch.nn.functional as F
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models.transformer import quantize_f8

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(8)
    shapes = {}
    for name, B, Sq, Skv, Hq, Hkv, hd, q_offset, valid in ATTN_F8_SHAPES:
        q = torch.randn((B, Sq, Hq, hd), generator=gen, device="cuda") \
            .bfloat16()
        cache = [quantize_f8(torch.randn((2, B, Skv, Hkv, hd),
                                         generator=gen, device="cuda"))
                 for _ in range(2)]
        nan = quantize_f8(torch.full((1,), float("nan"), device="cuda"))
        for c in cache:
            c[:, :, valid:] = nan
        k, v = cache[0][1], cache[1][1]
        kb, vb = k.bfloat16(), v.bfloat16()          # the same values
        kw = {"q_offset": q_offset, "kv_valid_len": valid}

        def kernel(*a):
            return fops.flash_attention_cuda(*a, True, **kw)

        def plain(*a):
            return fops.flash_attention_ref(*a, True, **kw)

        route, chunk, splits = fops.attention_plan(q, k, v, True, **kw,
                                                   sms=sms)
        require(route == "splitk_f8",
                f"flash_attention plans {route} over the f8 cache at {name}")
        plan = {"chunk": chunk, "splits": splits, "blocks": B * Hkv * splits,
                "warps": fops.SPLITK_WARPS, "tile_keys": fops.SPLITK_TILE,
                "stages": fops.splitk_stages(hd, 1, chunk),
                "bf16_route_stages": fops.splitk_stages(hd, 2, chunk)}
        emit({"splitk_plan": name, **plan})
        before = attn_counts(LAUNCHES, fops)
        got = kernel(q, k, v)
        after = attn_counts(LAUNCHES, fops)
        taken = [r for r in after if after[r] > before[r]]
        require(taken == ["splitk_f8"],
                f"flash_attention over the f8 cache at {name} took {taken}")
        err, rel = check_bf16_attention(torch, got, plain(q, k, v),
                                        f"attn_splitk_f8 at {name}")
        same = kernel(q, kb, vb)
        require(torch.equal(got.view(torch.int16), same.view(torch.int16)),
                f"attn_splitk_f8 at {name} differs from the bf16 split-K "
                f"route on the dequantised copy (max abs "
                f"{float((got.float() - same.float()).abs().max())})")
        del got, same
        f32 = f8_float32_q(torch, fops, q.float(), k, v, kw) \
            if name == "decode" else None
        qt, kt, vt = (q.transpose(1, 2), kb[:, :valid].transpose(1, 2),
                      vb[:, :valid].transpose(1, 2))

        def sdpa():      # one query over every valid key: no mask
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  enable_gqa=True)

        pairs, n_ops, _ = attention_work(B, Sq, Skv, Hq, Hkv, hd, q_offset,
                                         valid)
        nbytes = 2 * 2 * B * Sq * Hq * hd + 1 * 2 * B * valid * Hkv * hd
        shapes[name] = {
            "shape": {"B": B, "Sq": Sq, "Skv": Skv, "Hq": Hq, "Hkv": Hkv,
                      "hd": hd, "q_offset": q_offset, "kv_valid_len": valid,
                      "kv_dtype": "float8_e4m3fn"},
            "plan": plan,
            "max_abs_err": err, "max_row_rel_l2": rel,
            "bitwise_equal_to_bf16_route_on_copy": True,
            "ms": cuda_ms(torch, kernel, lambda: (q, k, v)),
            "plain_ms": cuda_ms(torch, plain, lambda: (q, k, v)),
            "library_ms": cuda_ms(torch, sdpa),
            "bf16_route_ms": cuda_ms(torch, kernel, lambda: (q, kb, vb)),
            "device_ms": graph_ms(torch, lambda: kernel(q, k, v)),
            "bf16_route_device_ms": graph_ms(torch,
                                             lambda: kernel(q, kb, vb)),
            "library_device_ms": graph_ms(torch, sdpa),
            "device_ms_launches": ATTN_GRAPH_LAUNCHES,
            **({"float32_q": f32} if f32 else {}),
            "pairs_per_head": pairs, "ops": n_ops,
            "bf16_route_bound_ms": bound(
                nbytes + 2 * B * valid * Hkv * hd,
                n_ops / BF16_OPS_PER_S * 1e3)["bound_ms"],
            **bound(nbytes, n_ops / BF16_OPS_PER_S * 1e3)}
        del q, k, v, kb, vb, cache, qt, kt, vt
        torch.cuda.empty_cache()
    head = shapes["decode"]
    src, replaces = KERNEL_ROWS["flash_attention"]
    return {"name": "flash_attention_f8", "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": lm["f8_launches"] + lm["mesh_launches"]["splitk_f8"],
            "launches_mesh_decode": lm["mesh_launches"]["splitk_f8"],
            "max_abs_err": max(x["max_abs_err"] for x in shapes.values()),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "kernel_route": "attn_splitk_f8",
            "library_call": "torch.nn.functional.scaled_dot_product_attention"
                            " (enable_gqa, no mask: one query over every "
                            "valid key) on a bf16 copy of the float8 cache, "
                            "since SDPA reads no float8",
            "tolerance": {"atol": ATTN_BF16_TOL, "rtol": ATTN_BF16_TOL,
                          "row_rel_l2": ATTN_BF16_ROW_REL_L2},
            "launches_from": "phase lm's float8 decode (decode_step into "
                             "a float8 cache) and phase mesh_decode's "
                             "long_500k steps (one launch a slot and layer)",
            "launch_steps": lm["f8_steps"],
            "moonshot_launches": moonshot["launches"],
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
                  w1_rec, lm, main_index, engine) -> list[dict]:
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
    # at the engine's word width (W = 16), on a graph of its law
    call = engine_width_call(torch)
    shape3, err3, ms3, plain3, nbytes3, t_ops3, bits3, x3 = msbfs_step(
        {"msbfs_step": types.SimpleNamespace(best=call, calls=[call])})
    del call
    require(err3 == 0, "msbfs_step disagrees with its plain version at the "
                       "engine's word width")
    shape, err, ms, plain_ms, nbytes, t_ops, new_bits, x = \
        msbfs_step(main_rec)
    first = engine["first"]
    row("msbfs_step", shape, err, ms, plain_ms, nbytes=nbytes,
        t_ops_ms=t_ops, new_bits=new_bits, **x,
        delta_sweep={"shape": shape2, "max_abs_err": err2, "ms": ms2,
                     "plain_ms": plain2, "new_bits": bits2, **x2,
                     **bound(nbytes2, t_ops2)},
        engine_width={"shape": shape3, "max_abs_err": err3, "ms": ms3,
                      "plain_ms": plain3, "new_bits": bits3, **x3,
                      **bound(nbytes3, t_ops3)},
        engine_batch_1b={
            "launches": first["launches"]["msbfs_step"],
            "shape": {"V": 1 << 26, "D": 64, "W": 16},
            "ms": engine["msbfs_step_ms"],
            "bound_ms": [s["msbfs_step_bound"]["bound_ms"]
                         for s in first["supersteps"]],
            "new_pairs": [s["new_pairs"] for s in first["supersteps"]],
            "sampled_rows_equal_plain": [
                all(c["plain"][n] for n in ("frontier_equal",
                                            "visited_equal", "dist_equal"))
                for c in first["certificate"]],
            "sampled_rows": ENGINE_SAMPLE,
            "from": "phase engine, one launch a superstep (CUDA events)"})

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
        engine_batch_1b={
            "launches": engine["first"]["launches"]["level_fused"],
            "ms": engine["expand_ms"],
            "bound_ms": engine["first"]["expand_ref"]["bound"]["bound_ms"],
            "counts": engine["first"]["expand_counts"],
            "from": "phase engine, one fused level a superstep (CUDA "
                    "events), 65,536 level-1 paths into 2**20 rows"},
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
    # phase engine runs the batch_1b cell in a fresh process
    ap.add_argument("--engine-child", action="store_true",
                    help=argparse.SUPPRESS)
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
    if args.engine_child:
        emit(engine_child())
        return 0

    t_start = time.perf_counter()
    dev_info = phase_device(torch)
    phase_build()
    child = engine_start()      # on the card while the host builds the graph
    try:
        g, queries = phase_workload(args.n, args.queries)
    except BaseException:
        child.kill()
        child.communicate()
        raise
    engine = phase_engine(torch, child)
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
    phase_segment(torch, g, (("main", queries, main_report),
                             ("sharing", share_queries,
                              plan_reports["batch"])))
    del level_1x, plan_reports
    ops = phase_ops(torch, g, main_rec, join_rec)
    del g, session, main_report, share_report       # the graph state
    gc.collect()
    torch.cuda.empty_cache()
    lm = phase_lm(torch)
    phase_moe(torch)
    moonshot = phase_moonshot(torch)
    train = phase_train(torch)
    phase_gnn(torch)
    phase_recsys(torch)
    phase_mesh(torch)
    peaks = phase_peaks(torch, dev_info)
    rows = phase_kernels(torch, dev_info, peaks, main_rec, launches,
                         share_rec, share_launches, plan_rec, plan_launches,
                         ops, w1_rec, lm, main_index, engine)
    r = flash_attention_f8_row(torch, lm, moonshot)
    emit({"phase": "kernel", **r})
    rows.append(r)
    r = flash_attention_bwd_row(torch, train)
    emit({"phase": "kernel", **r})
    rows.append(r)
    emit({"phase": "done", "t_total_s": time.perf_counter() - t_start})
    print(dev_info["nvidia_smi"], flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": dev_info["kind"],
                                 "count": dev_info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
