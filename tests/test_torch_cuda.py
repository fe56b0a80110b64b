"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc``; elsewhere each one
skips with the reason. Run them on a machine with a card::

    python -m pytest -q -m gpu tests/test_torch_cuda.py

The inputs are integers, or (``ell_spmm``) float32 sums taken in the same
order by the kernel and its plain version, so every comparison is exact
equality. Also: graph deltas patch the card's ELL tables to equal a fresh
build, and the engine's deltas on the card equal those on the CPU.
``flash_attention`` sums in another order than its plain version (and in
bf16 rounds p before the PV product), so it is held to tolerances: 3e-5
absolute / 1e-4 relative in float32 (the JAX kernel tests'); in bf16
1e-2 elementwise and a relative L2 error of at most 2e-2 in every output
row. Each route of ``flash_attention`` (wgmma, split-K, mma, float32) and
of ``ell_spmm`` (the F = 1 kernel or the general one) is taken by the
shapes it is for. The reduced transformer on the card matches the CPU port
in float32 (TF32 off) at 1e-4. Two and four engine replicas on streams of
one card give one replica's results, the segment index route's sweeps and
engine on one slot and over three and four streams equal the CPU's, and
four threads that load a kernel
library first run one build. The programs over a layout of ``cuda:0``
slots: a slot's attention partial on each decode route (zeros and an lse
of -inf where it sees no key, float32 out rounding to the bf16 out bit for
bit), ``flash_decode`` against the CPU slots (float32) and the one-slot
decode (bf16 and float8 caches), ``ring_aggregate`` against the CPU, the
collectives and ``ef_compressed_psum_axis``; the sharded model (weights
cut over the slots) against the CPU slots in float32, and in bf16 on the
one-device routes (wgmma prefill, split-K decode, once a slot and layer).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import LAUNCHES, build  # noqa: E402
from repro_torch.kernels.ell_spmm.ops import (  # noqa: E402
    ell_aggregate, ell_spmm_cuda, ell_spmm_ref)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    attention_plan, bwd_plan, bwd_route, flash_attention_bwd_cuda,
    flash_attention_bwd_ref,
    flash_attention_cuda, flash_attention_ref, flash_attention_splitk_ref,
    gqa_attention)
from repro_torch.kernels.msbfs_expand.ops import (  # noqa: E402
    msbfs_expand_cuda, msbfs_expand_ref, msbfs_hop_packed, msbfs_step_cuda,
    msbfs_step_ref, pack_bits)
from repro_torch.kernels.pairwise_popcount.ops import (  # noqa: E402
    gamma_intersections, gamma_pack_cuda, gamma_pack_ref, intersections,
    pairwise_popcount_cuda)
from repro_torch.kernels.path_join.ops import (  # noqa: E402
    keyed_join_valid, path_member_cuda, path_member_ref, path_overlap_cuda,
    path_overlap_ref, rowwise_overlap_cuda, rowwise_overlap_ref,
    splice_join_valid)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    build.build()          # all sources at once, compiled in parallel
    return torch.device("cuda")


def _ell(r, V, D, pad_frac):
    ell = r.integers(0, V, size=(V, D)).astype(np.int32)
    ell[r.random((V, D)) < pad_frac] = V
    return ell


@pytest.mark.parametrize("V,D,S", [(1 << 20, 32, 256), (1000, 5, 40),
                                   (37, 3, 1), (64, 1, 33)])
def test_msbfs_step_matches_plain(dev, V, D, S):
    r = np.random.default_rng(V + D + S)
    ell = torch.from_numpy(_ell(r, V, D, 0.6)).to(dev)
    ell[: min(V, 5)] = V                                  # all-sentinel rows
    fr = pack_bits(torch.from_numpy(r.random((V + 1, S)) < 0.01).to(dev))
    fr[V] = 0
    vis = pack_bits(torch.from_numpy(r.random((V, S)) < 0.05).to(dev)) | fr[:V]
    W = fr.shape[1]
    dist = torch.full((V, W * 32), 9, dtype=torch.int8, device=dev)
    before = LAUNCHES["msbfs_step"]
    vis_k, dist_k = vis.clone(), dist.clone()
    out_k = msbfs_step_cuda(ell, fr, vis_k, dist_k, 3)
    out_r = msbfs_step_ref(ell, fr, vis, dist, 3)
    torch.cuda.synchronize()
    assert LAUNCHES["msbfs_step"] == before + 1
    assert torch.equal(out_k, out_r)
    assert torch.equal(vis_k, vis)
    assert torch.equal(dist_k, dist)
    assert not out_k[V].any()


def test_msbfs_step_empty_frontier_and_zero_dims(dev):
    V, W = 50, 2
    ell = torch.full((V, 4), V, dtype=torch.int32, device=dev)
    fr = torch.zeros((V + 1, W), dtype=torch.int32, device=dev)
    vis = torch.zeros((V, W), dtype=torch.int32, device=dev)
    dist = torch.full((V, W * 32), 7, dtype=torch.int8, device=dev)
    out = msbfs_step_cuda(ell, fr, vis, dist, 1)
    assert not out.any() and not vis.any() and bool((dist == 7).all())
    out0 = msbfs_step_cuda(ell[:0], fr[:1], vis[:0], dist[:0], 1)
    assert out0.shape == (1, W) and not out0.any()


@pytest.mark.parametrize("W", [1, 2, 8, 9, 40])
@pytest.mark.parametrize("D", [1, 5, 33, 64])
def test_msbfs_step_warp_level_cases(dev, D, W):
    # all-pad rows, rows whose visited words are all ones (skipped), rows
    # saturated in some words only, a dense frontier and hop 127
    V = 3000
    r = np.random.default_rng(D * 100 + W)
    ell = torch.from_numpy(_ell(r, V, D, 0.5)).to(dev)
    ell[:7] = V
    fr = torch.from_numpy(r.integers(-2**31, 2**31, size=(V + 1, W),
                                     dtype=np.int64).astype(np.int32)).to(dev)
    fr &= torch.from_numpy(r.integers(-2**31, 2**31, size=(V + 1, W),
                                      dtype=np.int64).astype(np.int32)).to(dev)
    fr[V] = 0
    vis = torch.from_numpy(r.integers(-2**31, 2**31, size=(V, W),
                                      dtype=np.int64).astype(np.int32)).to(dev)
    vis[7:40] = -1                                       # reached from all
    vis[40:60, 0] = -1                                   # one word full
    ell[7:20, 0] = 100                                   # full, not pads
    dist = torch.from_numpy(r.integers(-5, 120, size=(V, W * 32))
                            .astype(np.int8)).to(dev)
    vis_k, dist_k = vis.clone(), dist.clone()
    n0 = LAUNCHES["msbfs_step"]
    out_k = msbfs_step_cuda(ell, fr, vis_k, dist_k, 127)
    out_r = msbfs_step_ref(ell, fr, vis, dist, 127)
    torch.cuda.synchronize()
    assert LAUNCHES["msbfs_step"] == n0 + 1
    assert torch.equal(out_k, out_r)
    assert torch.equal(vis_k, vis)
    assert torch.equal(dist_k, dist)
    assert not out_k[V].any() and not out_k[7:40].any()


def test_msbfs_step_in_a_cuda_graph_restoring_visited(dev):
    # chip_smoke.py's device_ms: each captured call restores visited first
    V, D, S = 1 << 16, 32, 256
    r = np.random.default_rng(21)
    ell = torch.from_numpy(_ell(r, V, D, 0.75)).to(dev)
    fr = pack_bits(torch.from_numpy(r.random((V + 1, S)) < 0.02).to(dev))
    fr[V] = 0
    vis0 = pack_bits(torch.from_numpy(r.random((V, S)) < 0.05).to(dev))
    dist = torch.full((V, S), 9, dtype=torch.int8, device=dev)
    vis_r, dist_r = vis0.clone(), dist.clone()
    want = msbfs_step_ref(ell, fr, vis_r, dist_r, 4)
    vis = vis0.clone()
    msbfs_step_cuda(ell, fr, vis, dist, 4)             # warm, off the graph
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = []
        for _ in range(20):
            vis.copy_(vis0)
            outs.append(msbfs_step_cuda(ell, fr, vis, dist, 4))
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)
    assert torch.equal(vis, vis_r) and torch.equal(dist, dist_r)


def test_msbfs_sweeps_on_card_match_cpu(dev):
    from repro_torch.core import generators
    from repro_torch.core.graph import DeviceGraph
    from repro_torch.core.msbfs import msbfs_dist_ell, msbfs_set_dist_ell
    g = generators.community(20_000, n_comm=8, avg_deg=8.0, seed=8)
    card, cpu = DeviceGraph.build(g, "cuda"), DeviceGraph.build(g, "cpu")
    srcs = torch.from_numpy(np.random.default_rng(9).choice(
        g.n, 300, replace=False))
    seed = torch.zeros(g.n + 1, dtype=torch.int8)
    seed[srcs[:50]] = 1
    for table in ("ell_idx", "r_ell_idx"):
        n0 = LAUNCHES["msbfs_step"]
        got = msbfs_dist_ell(getattr(card, table), srcs, n=g.n, k_max=6)
        assert LAUNCHES["msbfs_step"] == n0 + 6
        want = msbfs_dist_ell(getattr(cpu, table), srcs, n=g.n, k_max=6)
        assert torch.equal(got.cpu(), want)
        got = msbfs_set_dist_ell(getattr(card, table), seed.to(dev), n=g.n,
                                 k_max=8)
        want = msbfs_set_dist_ell(getattr(cpu, table), seed, n=g.n, k_max=8)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("V,D,W", [(1 << 20, 32, 8), (1 << 20, 32, 1),
                                   (1000, 5, 3), (37, 3, 1), (300, 1, 9),
                                   (50, 0, 2), (0, 4, 1)])
def test_msbfs_expand_matches_plain(dev, V, D, W):
    r = np.random.default_rng(V + 3 * D + W)
    ell = torch.from_numpy(_ell(r, V, D, 0.6)).to(dev)
    ell[: min(V, 5)] = V                                  # all-pad rows
    fr = torch.from_numpy(r.integers(-2**31, 2**31, size=(V + 1, W),
                                     dtype=np.int64).astype(np.int32)).to(dev)
    fr[V] = -1                                  # row V holds garbage
    before_fr = fr.clone()
    n0 = LAUNCHES["msbfs_expand"]
    got = msbfs_expand_cuda(ell, fr)
    want = msbfs_expand_ref(ell, fr)
    torch.cuda.synchronize()
    assert LAUNCHES["msbfs_expand"] == n0 + (V > 0 and D > 0 and W > 0)
    assert torch.equal(got, want)
    assert not got[V].any()
    assert torch.equal(fr, before_fr), "the kernel wrote its input"
    assert torch.equal(msbfs_hop_packed(ell, fr), want)   # the CUDA arm


@pytest.mark.parametrize("NA,NB,LA,LB", [(4096, 4096, 6, 6), (1000, 1, 9, 9),
                                         (33, 700, 1, 9), (65, 63, 9, 1),
                                         (70_000, 3, 5, 40), (5, 0, 3, 3),
                                         (3, 4, 0, 2),
                                         # more row tiles than one grid
                                         # column holds (65,535 x 32)
                                         (2_200_000, 2, 2, 3)])
def test_path_overlap_matches_plain(dev, NA, NB, LA, LB):
    r = np.random.default_rng(NA + NB + LA * LB)
    a = torch.from_numpy(r.integers(-1, 30, size=(NA, LA + 3))
                         .astype(np.int32)).to(dev)[:, :LA]   # strided rows
    b = torch.from_numpy(r.integers(-3, 30, size=(NB, LB + 1))
                         .astype(np.int32)).to(dev)[:, :LB]
    n0 = LAUNCHES["path_overlap"]
    got = path_overlap_cuda(a, b)
    want = path_overlap_ref(a, b)
    torch.cuda.synchronize()
    assert LAUNCHES["path_overlap"] == n0 + (NA * NB * LA * LB > 0)
    assert got.shape == (NA, NB) and torch.equal(got, want)
    if NA and NB and LA and LB:                 # the ops on both arms
        for op in (keyed_join_valid, splice_join_valid):
            assert torch.equal(op(a, LA - 1, b, LB - 1).cpu(),
                               op(a.cpu(), LA - 1, b.cpu(), LB - 1))


@pytest.mark.parametrize("V,D,W,ell_off,fr_off", [
    (1 << 16, 32, 8, 1, 0),       # ELL rows without 16-byte loads
    (1 << 16, 32, 8, 0, 1),       # frontier 4-byte aligned: a word a thread
    (1 << 16, 32, 8, 0, 2),       # 8-byte aligned: two words a thread
    (5000, 40, 6, 0, 0),          # D past one 32-entry pass, W = 6
    (3000, 70, 12, 3, 2), (777, 33, 33, 0, 0), (500, 7, 64, 2, 0)])
def test_msbfs_expand_misaligned_matches_plain(dev, V, D, W, ell_off,
                                               fr_off):
    """Tensors that start past a 16-byte boundary (views into a larger
    buffer) and widths that are not a multiple of 4."""
    r = np.random.default_rng(V + D + W + ell_off + fr_off)
    ell_buf = torch.empty(ell_off + V * D, dtype=torch.int32, device=dev)
    ell = ell_buf[ell_off:].view(V, D)
    ell.copy_(torch.from_numpy(_ell(r, V, D, 0.5)))
    fr_buf = torch.empty(fr_off + (V + 1) * W, dtype=torch.int32, device=dev)
    fr = fr_buf[fr_off:].view(V + 1, W)
    fr.copy_(torch.from_numpy(r.integers(-2**31, 2**31, size=(V + 1, W),
                                         dtype=np.int64).astype(np.int32)))
    got = msbfs_expand_cuda(ell, fr)
    want = msbfs_expand_ref(ell, fr)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and not got[V].any()


def _overlap_edge(case):
    """(A, B) numpy int32 rows at one edge of path_overlap's dictionary
    design (32-row A tiles, at most 256 distinct ids, int8 counts)."""
    r = np.random.default_rng(len(case) * 7)
    big = 2**31 - 1
    if case == "ids_near_int32_max":      # and pads other than -1 in A
        A = r.integers(big - 60, big + 1, (97, 6)).astype(np.int32)
        B = r.integers(big - 60, big + 1, (300, 5)).astype(np.int32)
        A[r.random(A.shape) < 0.3] = -5
        A[:, 0] = -big - 1
        B[r.random(B.shape) < 0.2] = -1
    elif case == "repeats":               # [5, 5] against [5] counts 2
        A = r.integers(0, 6, (64, 8)).astype(np.int32)
        B = r.integers(-3, 6, (513, 7)).astype(np.int32)
        A[0], B[0] = 5, 5
    elif case == "dictionary_overflow":   # tile 0: 32 x 9 distinct ids
        A = r.permutation(10**7)[:100 * 9].reshape(100, 9).astype(np.int32)
        A[32:] = r.integers(0, 50, (68, 9))
        B = A[r.integers(0, 100, 700)][:, ::-1].copy()
    elif case == "long_rows":             # LA 121 against LB 40
        A = r.integers(-1, 200, (70, 121)).astype(np.int32)
        A[64:] = r.integers(-1, 3, (6, 121))
        B = r.integers(-1, 200, (260, 40)).astype(np.int32)
    elif case == "long_b_rows":           # LA 40 against LB 121
        A = r.integers(-1, 100, (33, 40)).astype(np.int32)
        B = r.integers(-1, 100, (255, 121)).astype(np.int32)
    elif case == "rows_past_127":         # every tile compares
        A = np.full((40, 130), 9, np.int32)
        A[1::2, ::3] = 4
        B = r.integers(3, 11, (37, 3)).astype(np.int32)
    elif case == "odd_widths":            # NB odd: no paired stores
        A = r.integers(-1, 40, (1, 3)).astype(np.int32)
        B = r.integers(-1, 40, (257, 1)).astype(np.int32)
    elif case == "all_pads":              # an empty dictionary
        A = np.full((35, 4), -1, np.int32)
        B = r.integers(-1, 9, (40, 4)).astype(np.int32)
    else:
        raise ValueError(case)
    return A, B


@pytest.mark.parametrize("case", ["ids_near_int32_max", "repeats",
                                  "dictionary_overflow", "long_rows",
                                  "long_b_rows", "rows_past_127",
                                  "odd_widths", "all_pads"])
def test_path_overlap_design_edges_match_plain(dev, case):
    A, B = _overlap_edge(case)
    NA, LA = A.shape
    NB, LB = B.shape
    # strided row slices of wider matrices
    a = torch.full((NA, LA + 2), 7, dtype=torch.int32, device=dev)[:, :LA]
    b = torch.full((NB, LB + 1), 7, dtype=torch.int32, device=dev)[:, 1:]
    a.copy_(torch.from_numpy(A))
    b.copy_(torch.from_numpy(B))
    got = path_overlap_cuda(a, b)
    want = path_overlap_ref(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if case == "repeats":
        assert int(got[0, 0]) == 8 * 7


def test_path_overlap_more_b_tiles_than_one_grid_row(dev):
    """NB past 65,535 tiles of 256: a block walks several B tiles."""
    r = np.random.default_rng(11)
    a = torch.from_numpy(r.integers(-1, 9, (3, 2)).astype(np.int32)).to(dev)
    b = torch.from_numpy(r.integers(-1, 9, (17_000_000, 1))
                         .astype(np.int32)).to(dev)
    got = path_overlap_cuda(a, b)
    want = path_overlap_ref(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_delta_patches_card_tables_like_a_fresh_build(dev):
    from repro_torch.core import (DeviceGraph, GraphDelta, apply_delta,
                                  generators, host_set_dist,
                                  update_device_graph)
    from repro_torch.core.msbfs import msbfs_set_dist_ell
    g = generators.community(5000, n_comm=5, avg_deg=6.0, seed=5)
    dg = DeviceGraph.build(g, dev)
    r = np.random.default_rng(6)
    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    pick = r.choice(g.m, 40, replace=False)
    delta = GraphDelta(r.integers(0, g.n, 40), r.integers(0, g.n, 40),
                       src[pick], g.indices[pick])
    applied = apply_delta(g, delta)
    mask = torch.zeros(g.n + 1, dtype=torch.int8)
    mask[torch.from_numpy(applied.touched)] = 1
    for reverse, ell in ((False, dg.r_ell_idx), (True, dg.ell_idx)):
        got = msbfs_set_dist_ell(ell, mask.to(dev), n=g.n, k_max=4)
        assert np.array_equal(got.cpu().numpy(),
                              host_set_dist(g, applied, 4, reverse))
    dg2, incremental = update_device_graph(dg, applied)
    assert incremental and dg2.ell_idx.device.type == "cuda"
    fresh = DeviceGraph.build(applied.graph, dev)
    assert torch.equal(dg2.ell_idx, fresh.ell_idx)
    assert torch.equal(dg2.r_ell_idx, fresh.r_ell_idx)
    # past the cap: a rebuild on the card whose caps do not shrink
    v = int(np.argmax(applied.graph.in_degree()))
    have = set(applied.graph.neighbors(v, reverse=True).tolist()) | {v}
    srcs = [u for u in range(g.n) if u not in have][:dg2.r_ell_cap]
    applied3 = apply_delta(applied.graph,
                           GraphDelta.from_pairs(add=[(u, v) for u in srcs]))
    dg3, incremental = update_device_graph(dg2, applied3)
    assert not incremental and dg3.r_ell_cap > dg2.r_ell_cap
    assert dg3.ell_cap >= dg2.ell_cap and dg3.ell_idx.device.type == "cuda"
    fresh = DeviceGraph.build(applied3.graph, dev,
                              min_ell_caps=(dg2.ell_cap, dg2.r_ell_cap))
    assert torch.equal(dg3.ell_idx, fresh.ell_idx)
    assert torch.equal(dg3.r_ell_idx, fresh.r_ell_idx)


def test_engine_deltas_on_card_match_cpu(dev):
    from repro_torch.core import (EngineConfig, GraphDelta, PathSession,
                                  generators)
    from repro_torch.kernels import reset_launches
    g = generators.community(3000, n_comm=6, avg_deg=6.0, seed=3)
    qs = generators.random_queries(g, 12, k_range=(3, 5), seed=4)
    for backend in ("host", "msbfs"):
        cfg = EngineConfig(cache_bytes=1 << 24, delta_backend=backend)
        on_card = PathSession(g, cfg, device="cuda")
        on_cpu = PathSession(g, cfg, device="cpu")
        on_card.run(qs)
        on_cpu.run(qs)
        s, _, _ = qs[0]
        delta = GraphDelta.from_pairs(remove=[(s, int(g.neighbors(s)[0]))])
        reset_launches()
        a = on_card.apply_delta(delta)
        assert (LAUNCHES["msbfs_step"] > 0) == (backend == "msbfs")
        b = on_cpu.apply_delta(delta)
        a.pop("t_apply_s")
        b.pop("t_apply_s")
        assert a == b
        for x, y in zip(on_card.run(qs), on_cpu.run(qs)):
            assert np.array_equal(x.paths, y.paths)


def _popcounts(words):
    from repro_torch.kernels.pairwise_popcount.ops import popcount32
    return popcount32(words.to(torch.int64) & 0xFFFFFFFF).sum(1)


@pytest.mark.parametrize("Q,W", [(256, 1 << 15), (16, 8), (255, 9), (300, 7),
                                 (33, (1 << 15) + 3), (17, 100), (1, 1),
                                 (5, 0), (0, 4), (0, 0)])
def test_pairwise_popcount_matches_plain(dev, Q, W):
    r = np.random.default_rng(Q * 7 + W)
    words = torch.from_numpy(
        r.integers(-2**31, 2**31, size=(Q, W), dtype=np.int64)
        .astype(np.int32)).to(dev)
    n0 = LAUNCHES["pairwise_popcount"]
    got = pairwise_popcount_cuda(words)
    assert LAUNCHES["pairwise_popcount"] == n0 + (Q > 0 and W > 0)
    assert torch.equal(got, intersections(words))
    assert torch.equal(got, got.T)
    assert torch.equal(torch.diagonal(got).long(), _popcounts(words))


def test_pairwise_popcount_all_ones_rows_reach_2_20(dev):
    Q, W = 200, 1 << 15
    r = np.random.default_rng(11)
    words = torch.from_numpy(
        r.integers(-2**31, 2**31, size=(Q, W), dtype=np.int64)
        .astype(np.int32)).to(dev)
    words[::3] = -1                                     # all 32 bits set
    got = pairwise_popcount_cuda(words)
    assert torch.equal(got, intersections(words))
    assert int(got[0, 3]) == int(got[0, 0]) == 1 << 20
    assert torch.equal(got, got.T)
    assert torch.equal(torch.diagonal(got).long(), _popcounts(words))


def test_pairwise_popcount_in_a_cuda_graph(dev):
    # the split-K zeroing is a memset inside the call: 50 captured calls
    # replay to the same exact result
    r = np.random.default_rng(12)
    words = torch.from_numpy(
        r.integers(-2**31, 2**31, size=(256, 1 << 15), dtype=np.int64)
        .astype(np.int32)).to(dev)
    want = intersections(words)
    pairwise_popcount_cuda(words)                      # warm, off the graph
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [pairwise_popcount_cuda(words) for _ in range(50)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, want) for o in outs)


def _gamma_inputs(dev, n, Su, Q, seed, *, inf=7):
    r = np.random.default_rng(seed)
    dist = r.integers(0, inf + 1, size=(n + 1, Su)).astype(np.int8)
    dist[r.random((n + 1, Su)) < 0.4] = inf
    dist[n] = inf
    col = r.integers(0, Su, Q).astype(np.int32)
    col[: min(Q, Su)] = np.arange(min(Q, Su))            # every column used
    ks = r.integers(0, inf, Q).astype(np.int8)
    ks[:2] = 0
    return (torch.from_numpy(dist).to(dev), torch.from_numpy(col).to(dev),
            torch.from_numpy(ks).to(dev))


@pytest.mark.parametrize("n,Su,Q", [(1 << 20, 256, 256), (1000, 7, 12),
                                    (1000, 8, 8), (70_001, 255, 300),
                                    (5000, 300, 310), (31, 3, 5), (1, 1, 1),
                                    (513, 4, 2)])
def test_gamma_pack_matches_plain(dev, n, Su, Q):
    dist, col, ks = _gamma_inputs(dev, n, Su, Q, seed=n + Su + Q)
    n0 = LAUNCHES["gamma_pack"]
    got = gamma_pack_cuda(dist, col, ks, n)
    assert LAUNCHES["gamma_pack"] == n0 + 1
    assert torch.equal(got, gamma_pack_ref(dist, col, ks, n))
    # a view of the first rows (the index's dist[:n] is n+1 rows)
    assert torch.equal(gamma_pack_cuda(dist[:n], col, ks, n), got)


def test_gamma_pack_all_inf_and_zero_budgets(dev):
    n, Su, Q = 4099, 6, 9
    dist = torch.full((n + 1, Su), 7, dtype=torch.int8, device=dev)
    dist[5, 2] = 0                                       # the source itself
    col = torch.tensor([2, 2, 0, 1, 2, 3, 4, 5, 2], dtype=torch.int32,
                       device=dev)
    ks = torch.tensor([0, 6, 0, 0, 3, 6, 6, 6, 7], dtype=torch.int8,
                      device=dev)
    got = gamma_pack_cuda(dist, col, ks, n)
    assert torch.equal(got, gamma_pack_ref(dist, col, ks, n))
    assert int(got[0, 0]) == 1 << 5 and int(got[8].count_nonzero()) > 100


def test_gamma_intersections_on_card_match_cpu(dev):
    dist, col, ks = _gamma_inputs(dev, 100_003, 61, 70, seed=5)
    got = gamma_intersections(dist, col, ks, 100_003)
    want = gamma_intersections(dist.cpu(), col.cpu(), ks.cpu(), 100_003)
    assert torch.equal(got.cpu(), want)


def test_similarity_on_card_matches_cpu(dev):
    from repro_torch.core import generators
    from repro_torch.core.graph import DeviceGraph
    from repro_torch.core.index import build_index
    from repro_torch.core.similarity import similarity_matrix
    from repro_torch.kernels import reset_launches
    g = generators.community(5001, n_comm=4, avg_deg=6.0, seed=6)
    qs = generators.random_queries(g, 40, k_range=(2, 5), seed=7)
    qs += [(qs[0][0], qs[1][1], 0), (qs[0][0], qs[2][1], 3)]
    reset_launches()
    mu = similarity_matrix(build_index(DeviceGraph.build(g, "cuda"), qs))
    assert LAUNCHES["gamma_pack"] == LAUNCHES["pairwise_popcount"] == 2
    ref = similarity_matrix(build_index(DeviceGraph.build(g, "cpu"), qs))
    assert np.array_equal(mu, ref)


@pytest.mark.parametrize("N,L,D", [(200_000, 7, 32), (300, 1, 4), (0, 3, 8)])
def test_path_member_matches_plain(dev, N, L, D):
    r = np.random.default_rng(N + L + D)
    wide = torch.from_numpy(r.integers(-1, 50, size=(N, L + 3))
                            .astype(np.int32)).to(dev)
    verts = wide[:, :L]                                  # strided rows
    cand = torch.from_numpy(r.integers(0, 50, size=(N, D))
                            .astype(np.int32)).to(dev)
    assert torch.equal(path_member_cuda(verts, cand),
                       path_member_ref(verts, cand))


@pytest.mark.parametrize("N,LA,LB", [(200_000, 4, 5), (77, 1, 9), (0, 2, 2)])
def test_rowwise_overlap_matches_plain(dev, N, LA, LB):
    r = np.random.default_rng(N + LA * LB)
    a = torch.from_numpy(r.integers(-1, 20, size=(N, LA + 2))
                         .astype(np.int32)).to(dev)[:, :LA]
    b = torch.from_numpy(r.integers(-1, 20, size=(N, LB))
                         .astype(np.int32)).to(dev)
    assert torch.equal(rowwise_overlap_cuda(a, b), rowwise_overlap_ref(a, b))


def test_engine_on_card_matches_cpu(dev):
    from repro_torch.core import EngineConfig, PathSession, generators
    from repro_torch.kernels import reset_launches
    g = generators.community(3000, n_comm=6, avg_deg=6.0, seed=3)
    qs = generators.random_queries(g, 12, k_range=(3, 5), seed=4)
    cfg = EngineConfig(plan_caps=False)
    reset_launches()
    on_card = PathSession(g, cfg, device="cuda").run(qs)
    # every engine kernel but the walk-count DP's, which plan_caps=False
    # skips; the ops API's kernels are on no engine path
    assert all(LAUNCHES[k] > 0 for k in ("msbfs_step", "pairwise_popcount",
                                         "path_member", "rowwise_overlap")), \
        LAUNCHES
    assert LAUNCHES["ell_spmm"] == LAUNCHES["msbfs_expand"] == \
        LAUNCHES["path_overlap"] == 0
    on_cpu = PathSession(g, cfg, device="cpu").run(qs)
    for a, b in zip(on_card, on_cpu):
        assert np.array_equal(a.paths, b.paths)


@pytest.mark.parametrize("V,D,F,op", [(1 << 20, 32, 1, "sum"),
                                      (1 << 16, 32, 8, "max"),
                                      (1000, 5, 3, "sum"), (37, 3, 128, "max"),
                                      (50, 0, 2, "max"), (0, 4, 1, "sum")])
def test_ell_spmm_matches_plain_bit_for_bit(dev, V, D, F, op):
    r = np.random.default_rng(V + D + F)
    ell = torch.from_numpy(_ell(r, V, D, 0.3)).to(dev)
    ell[: min(V, 5)] = V                                  # all-pad rows
    # arbitrary float32s: equal only because the order of adds is the same
    x = torch.from_numpy((r.standard_normal((V, F)) * 10.0 ** r.integers(
        -3, 4, (V, F))).astype(np.float32)).to(dev)
    fill = 0.0 if op == "sum" else float("-inf")
    xs = torch.cat([x, torch.full((1, F), fill, device=dev)])
    before = LAUNCHES["ell_spmm"]
    got = ell_spmm_cuda(ell, xs, op)
    want = ell_spmm_ref(ell, xs, op)
    torch.cuda.synchronize()
    assert LAUNCHES["ell_spmm"] == before + (V > 0 and D > 0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    agg = ell_aggregate(ell, x, op)                      # the CUDA arm
    assert torch.isfinite(agg).all()


def test_default_config_engine_on_card_matches_cpu(dev):
    from repro_torch.core import EngineConfig, PathSession, generators
    from repro_torch.kernels import reset_launches
    g = generators.community(3000, n_comm=6, avg_deg=6.0, seed=3)
    qs = generators.random_queries(g, 12, k_range=(3, 5), seed=4)
    on_card = PathSession(g, EngineConfig(cache_bytes=1 << 24),
                          device="cuda")
    on_cpu = PathSession(g, EngineConfig(cache_bytes=1 << 24), device="cpu")
    for planner in ("batch", "batch+", "basic+", "pathenum", "auto"):
        reset_launches()
        a = on_card.run(qs, planner=planner)
        assert LAUNCHES["ell_spmm"] > 0, planner
        b = on_cpu.run(qs, planner=planner)
        assert a.routes == b.routes
        for key in ("n_materialized", "n_cache_hits"):
            assert a.stats.get(key) == b.stats.get(key), (planner, key)
        for x, y in zip(a, b):
            assert np.array_equal(x.paths, y.paths), planner


@pytest.mark.parametrize("slots", [1, 3, 4])
@pytest.mark.parametrize("edge_chunk", [1 << 10, 1 << 22])
def test_segment_sweeps_on_card_match_cpu(dev, slots, edge_chunk):
    """The segment route's sweeps on the card (``segment_reduce`` over
    float16 / float32 rows) equal the CPU's, on one slot and on slots cut
    over streams of one card."""
    from repro_torch.core import DeviceGraph, generators
    from repro_torch.core.distributed import (_replica_stream,
                                              distributed_graph)
    from repro_torch.core.index import walk_counts
    from repro_torch.core.msbfs import edge_span, msbfs_dist, msbfs_set_dist
    g = generators.erdos(20000, 6.0, seed=slots)
    cpu = DeviceGraph.build(g, "cpu", edge_lists=True)
    if slots == 1:
        card = DeviceGraph.build(g, dev, edge_lists=True)
    else:
        mesh = [torch.device("cuda", 0)] * slots
        card = distributed_graph(g, mesh, [None] + [
            _replica_stream(mesh[j], j) for j in range(1, slots)])
        assert all(s is not None for s in card.esrc.streams[1:])
    r = np.random.default_rng(slots + edge_chunk)
    srcs = torch.from_numpy(r.choice(g.n, 200, replace=False))
    mask = torch.zeros(g.n + 1, dtype=torch.int8)
    mask[torch.from_numpy(r.choice(g.n, 30, replace=False))] = 1
    slack = torch.from_numpy(r.integers(-1, 8, g.n + 1).astype(np.int8))
    slack[-1] = -1
    kws = [dict(n=g.n, edge_chunk=edge_chunk,
                m_valid=edge_span(g.m, edge_chunk, x.m_cap))
           for x in (cpu, card)]
    for reverse in (False, True):
        lists = [(x.r_esrc, x.r_edst) if reverse else (x.esrc, x.edst)
                 for x in (cpu, card)]
        got = [msbfs_dist(*ls, srcs, k_max=6, **kw).cpu()
               for ls, kw in zip(lists, kws)]
        assert torch.equal(got[0], got[1])
        got = [msbfs_set_dist(*ls, mask, k_max=8, **kw).cpu()
               for ls, kw in zip(lists, kws)]
        assert torch.equal(got[0], got[1])
        got = [walk_counts(*ls, int(srcs[0]), slack.to(ls[0].device),
                           budget=7, **kw).cpu()
               for ls, kw in zip(lists, kws)]
        assert torch.equal(got[0], got[1])


@pytest.mark.parametrize("mesh", [None, ["cuda:0"] * 3])
def test_segment_engine_on_card_matches_cpu(dev, mesh):
    """The segment route on the card (one slot, three over streams of one
    card): distances, path sets and a delta under ``delta_backend=
    "msbfs"`` equal the CPU engine's on as many slots; enumeration still
    runs the fused kernels and the walk counts launch no ``ell_spmm``."""
    from repro_torch.core import (EngineConfig, GraphDelta, PathSession,
                                  generators)
    from repro_torch.kernels import reset_launches
    g = generators.community(3000, n_comm=6, avg_deg=6.0, seed=3)
    qs = generators.random_queries(g, 12, k_range=(3, 5), seed=4)
    kw = dict(index_route="segment", edge_chunk=1 << 12,
              cache_bytes=1 << 24, delta_backend="msbfs")
    on_card = PathSession(g, EngineConfig(mesh=mesh, **kw), device="cuda")
    # the same slots on the CPU: each replica keeps its own cache, so
    # the delta's cache counts compare like with like
    on_cpu = PathSession(g, EngineConfig(
        mesh=None if mesh is None else ["cpu"] * len(mesh), **kw),
        device="cpu")
    for planner in ("batch", "batch+", "basic", "auto"):
        reset_launches()
        a = on_card.run(qs, planner=planner)
        assert LAUNCHES["ell_spmm"] == LAUNCHES["msbfs_step"] == 0
        assert LAUNCHES["path_member"] > 0, (planner, dict(LAUNCHES))
        if planner.startswith("batch"):
            assert LAUNCHES["pairwise_popcount"] > 0, planner
        b = on_cpu.run(qs, planner=planner)
        for x, y in zip(a, b):
            assert np.array_equal(x.paths, y.paths), planner
    ia, ib = (x.engine._build_index(qs) for x in (on_card, on_cpu))
    assert torch.equal(ia.dist_s.cpu(), ib.dist_s)
    assert torch.equal(ia.dist_t.cpu(), ib.dist_t)
    src, dst = g.edges_by_dst
    delta = GraphDelta.from_pairs(
        add=[(1, 2), (5, 2999)], remove=[(int(src[7]), int(dst[7]))])
    ra, rb = on_card.apply_delta(delta), on_cpu.apply_delta(delta)
    keys = ("n_touched", "cache_mode", "cache_evicted", "cache_kept")
    assert {k: ra[k] for k in keys} == {k: rb[k] for k in keys}
    for x, y in zip(on_card.run(qs), on_cpu.run(qs)):
        assert np.array_equal(x.paths, y.paths)


# (B, Sq, Skv, Hq, Hkv, hd, causal, q_offset, kv_valid_len): square causal,
# non-causal, decode rows with offsets, a cache tail cut by kv_valid_len,
# hd 8 / 12 / 24 / 128 and Hq:Hkv 1:1, 4:1 and 5:1 (qwen2.5-14b's 40:8)
ATTN_CASES = [
    (2, 64, 64, 4, 4, 8, True, None, None),
    (2, 64, 64, 4, 1, 12, False, None, None),
    (3, 33, 65, 40, 8, 24, True, None, None),
    (1, 7, 50, 5, 1, 12, True, 20, 27),
    (2, 1, 96, 8, 2, 128, True, 70, 71),
    (2, 130, 130, 32, 8, 128, True, None, None),
    (1, 19, 200, 40, 8, 128, False, None, 150),
    (2, 5, 300, 4, 1, 24, True, 3, 300),
]


def assert_attention_close(got, want, dtype):
    """float32 at 3e-5 / 1e-4. bf16 (p and the output rounded to bf16,
    about 2**-8 of a value each): elementwise at 1e-2, and at most 2e-2
    relative L2 error in every output row (one query, one q-head; rows of
    8 to 24 values measure up to 8e-3, rows of 128 about 4e-3)."""
    got, want = got.float(), want.float()
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=3e-5, rtol=1e-4)
        return
    torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-2)
    rel = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    assert float(rel.max()) <= 2e-2, float(rel.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_attention_matches_plain(dev, case, dtype):
    B, Sq, Skv, Hq, Hkv, hd, causal, q_offset, valid = case
    dt = getattr(torch, dtype)
    r = np.random.default_rng(Sq * 131 + Skv + hd)
    q, k, v = (torch.from_numpy(r.standard_normal(shape).astype(np.float32))
               .to(dev, dt) for shape in ((B, Sq, Hq, hd), (B, Skv, Hkv, hd),
                                          (B, Skv, Hkv, hd)))
    before = LAUNCHES["flash_attention"]
    got = flash_attention_cuda(q, k, v, causal, q_offset=q_offset,
                               kv_valid_len=valid)
    want = flash_attention_ref(q, k, v, causal, q_offset=q_offset,
                               kv_valid_len=valid)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dt and got.shape == (B, Sq, Hq, hd)
    assert_attention_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_on_a_cache_layer_slice(dev, dtype):
    """Strided k / v: one layer of an (L, B, max_len, Hkv, hd) cache, the
    tail past kv_valid_len holding garbage that must not leak in."""
    dt = getattr(torch, dtype)
    L, B, max_len, Hkv, Hq, hd, pos = 3, 2, 80, 2, 8, 64, 37
    gen = torch.Generator(device=dev).manual_seed(5)
    cache = torch.randn((L, B, max_len, Hkv, hd), generator=gen,
                        device=dev).to(dt)
    cache[:, :, pos + 1:] = float("nan")
    q = torch.randn((B, 1, Hq, hd), generator=gen, device=dev).to(dt)
    k, v = cache[1], cache[2]
    got = gqa_attention(q, k, v, True, q_offset=pos, kv_valid_len=pos + 1)
    want = flash_attention_ref(q, k[:, :pos + 1].clone(),
                               v[:, :pos + 1].clone(), True)
    assert_attention_close(got, want, dtype)
    # a transposed view (head stride != hd) is fine too: last dim contiguous
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    torch.testing.assert_close(
        gqa_attention(qt, k, v, True, q_offset=pos, kv_valid_len=pos + 1)
        .float(), got.float(), atol=0, rtol=0)


def test_flash_attention_refuses_what_it_cannot_run(dev):
    q = torch.zeros((1, 4, 2, 8), device=dev)
    k = torch.zeros((1, 4, 1, 8), device=dev)
    with pytest.raises(TypeError):
        flash_attention_cuda(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="4-D"):
        flash_attention_cuda(q[0], k, k)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k.cpu(), k)
    big = torch.zeros((1, 4, 1, 257), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q, k, torch.zeros((1, 4, 1, 16),
                                               device=dev)[..., ::2])


# (route, (B, Sq, Skv, Hq, Hkv, hd, causal, q_offset, kv_valid_len)):
# wgmma at hd 64 and 128, at G 5 (65 rows and 35), non-causal with a
# valid length; split-K at granite-8b's and qwen2.5-14b's decode, hd 24,
# 256 and an unaligned hd 12, rows that see no key, an empty cache; mma at
# hd 96 and 256
ROUTE_CASES = [
    ("wgmma", (2, 64, 64, 4, 1, 64, True, None, None)),
    ("wgmma", (1, 13, 40, 40, 8, 128, True, None, None)),
    ("wgmma", (2, 100, 333, 10, 2, 64, False, None, 310)),
    ("wgmma", (1, 300, 300, 8, 2, 128, True, None, None)),
    ("splitk", (2, 1, 600, 32, 8, 128, True, 599, 600)),
    ("splitk", (2, 1, 77, 40, 8, 128, True, 76, 77)),
    ("splitk", (2, 3, 300, 10, 2, 24, True, 100, 120)),
    ("splitk", (1, 1, 700, 8, 1, 256, True, 699, 700)),
    ("splitk", (1, 2, 50, 8, 2, 12, False, None, 40)),
    ("splitk", (1, 4, 64, 4, 1, 64, True, -2, 64)),
    ("splitk", (1, 1, 16, 4, 1, 64, True, 0, 0)),
    # the valid length at 1, one key before, at and past the kernel's
    # 32-key tile, at and past a round of its four warps' tiles (128), at
    # and past the reach of a warp's ring at hd 128 (384), G 1, 4 and 5,
    # and decode_32k's cache at batch 4
    ("splitk", (2, 1, 64, 32, 8, 128, True, 0, 1)),
    ("splitk", (2, 1, 64, 32, 8, 128, True, 30, 31)),
    ("splitk", (2, 1, 64, 40, 8, 128, True, 31, 32)),
    ("splitk", (2, 1, 64, 16, 16, 128, True, 32, 33)),
    ("splitk", (1, 1, 200, 32, 8, 128, True, 127, 128)),
    ("splitk", (1, 1, 200, 40, 8, 96, True, 128, 129)),
    ("splitk", (1, 1, 400, 8, 2, 128, True, 383, 384)),
    ("splitk", (1, 1, 400, 8, 8, 128, True, 384, 385)),
    ("splitk", (4, 1, 32768, 32, 8, 128, True, 32767, 32768)),
    ("wgmma", (1, 7, 50, 5, 1, 128, True, 20, 27)),
    ("mma", (1, 7, 50, 5, 1, 96, True, 20, 27)),
    ("mma", (2, 40, 90, 8, 2, 256, True, None, None)),
]


@pytest.mark.parametrize("route,case", ROUTE_CASES, ids=str)
def test_flash_attention_route_matches_plain(dev, route, case):
    """bf16: each shape takes its route (and only it) and matches the
    plain version; split-K also its own plain version, cut into the
    kernel's chunks."""
    B, Sq, Skv, Hq, Hkv, hd, causal, q_offset, valid = case
    r = np.random.default_rng(Sq * 7 + Skv + hd)
    q, k, v = (torch.from_numpy(r.standard_normal(shape).astype(np.float32))
               .to(dev, torch.bfloat16)
               for shape in ((B, Sq, Hq, hd), (B, Skv, Hkv, hd),
                             (B, Skv, Hkv, hd)))
    kw = dict(q_offset=q_offset, kv_valid_len=valid)
    plan = attention_plan(q, k, v, causal, **kw,
                          sms=torch.cuda.get_device_properties(dev)
                          .multi_processor_count)
    assert plan[0] == route
    before = {n: LAUNCHES[f"attn_{n}"] for n in ("wgmma", "splitk", "mma")}
    got = flash_attention_cuda(q, k, v, causal, **kw)
    torch.cuda.synchronize()
    assert {n: LAUNCHES[f"attn_{n}"] - c for n, c in before.items()} \
        == {n: int(n == route) for n in before}
    assert_attention_close(got, flash_attention_ref(q, k, v, causal, **kw),
                           "bfloat16")
    if route == "splitk":
        assert_attention_close(got, flash_attention_splitk_ref(
            q, k, v, causal, chunk=plan[1], **kw), "bfloat16")


def test_wgmma_prefill_chunk_on_a_cache_layer_slice(dev):
    """The wgmma route's TMA reads K / V of one cache layer up to
    kv_valid_len only: the NaN tail past it never reaches the output."""
    L, B, max_len, Hkv, Hq, hd = 2, 2, 256, 2, 8, 128
    gen = torch.Generator(device=dev).manual_seed(9)
    cache = torch.randn((L, B, max_len, Hkv, hd), generator=gen,
                        device=dev).bfloat16()
    pos, n = 40, 64                       # 64 new queries after 40 cached
    cache[:, :, pos + n:] = float("nan")
    q = torch.randn((B, n, Hq, hd), generator=gen, device=dev).bfloat16()
    k, v = cache[0], cache[1]
    before = LAUNCHES["attn_wgmma"]
    got = gqa_attention(q, k, v, True, q_offset=pos, kv_valid_len=pos + n)
    torch.cuda.synchronize()
    assert LAUNCHES["attn_wgmma"] == before + 1
    want = flash_attention_ref(q, k[:, :pos + n].clone(),
                               v[:, :pos + n].clone(), True, q_offset=pos)
    assert_attention_close(got, want, "bfloat16")


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("aligned", [True, False])
def test_ell_gather_f1_matches_plain_on_special_floats(dev, op, aligned):
    """F = 1: pads in the middle of rows, -0.0, +-inf and NaN; the F = 1
    kernel where the table is 16-byte aligned, the other kernel where it
    is not, both equal to the plain version bit for bit."""
    V, D = 1 << 16, 32
    r = np.random.default_rng(21)
    ell_np = r.integers(0, V, size=(V, D)).astype(np.int32)
    ell_np[r.random((V, D)) < 0.6] = V
    flat = torch.empty(V * D + 1, dtype=torch.int32, device=dev)
    ell = (flat[:-1] if aligned else flat[1:]).view(V, D)
    ell.copy_(torch.from_numpy(ell_np))
    x = (r.standard_normal((V, 1)) * 10.0 ** r.integers(-3, 4, (V, 1))) \
        .astype(np.float32)
    for i, special in enumerate((-0.0, np.inf, -np.inf, np.nan)):
        x[i::11] = special
    fill = 0.0 if op == "sum" else float("-inf")
    xs = torch.cat([torch.from_numpy(x).to(dev),
                    torch.full((1, 1), fill, device=dev)])
    before = LAUNCHES["ell_gather_f1"]
    got = ell_spmm_cuda(ell, xs, op)
    want = ell_spmm_ref(ell, xs, op)
    torch.cuda.synchronize()
    assert LAUNCHES["ell_gather_f1"] == before + aligned
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("arch", ["granite-8b", "qwen2.5-14b"])
def test_reduced_model_on_card_matches_cpu(dev, arch):
    """float32 (TF32 off): lm_forward, prefill and six decode steps into a
    cache of 16 on the card equal the CPU port's at 1e-4, every layer of
    every call through the kernel."""
    from repro_torch.configs import get
    from repro_torch.kernels import reset_launches
    from repro_torch.models.transformer import LM
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get(arch).REDUCED
    on_cpu = LM(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    params = {name: getattr(on_cpu, name)
              for name in ("embed", "final_norm", "unembed")}
    params["layers"] = {name: torch.stack([getattr(lp, name)
                                           for lp in on_cpu.layers])
                        for name, _ in on_cpu.layers[0].named_parameters()}
    on_card = LM(cfg, params, device="cuda")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12))
    reset_launches()
    tol = dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(on_card(toks).cpu(), on_cpu(toks), **tol)
    torch.testing.assert_close(on_card.prefill(toks).cpu(),
                               on_cpu.prefill(toks), **tol)
    c_card, c_cpu = on_card.init_cache(2, 16), on_cpu.init_cache(2, 16)
    for i in range(6):
        a, c_card = on_card.decode_step(toks[:, i:i + 1], c_card)
        b, c_cpu = on_cpu.decode_step(toks[:, i:i + 1], c_cpu)
        torch.testing.assert_close(a.cpu(), b, **tol)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == cfg.n_layers * (2 + 6)


# ----------------------------------------------------------------------
# the fused expand level and joins (csrc/path_join.cu) against their plain
# versions: every output bit for bit, rows in order
# ----------------------------------------------------------------------

def _simple_rows(r, N, L, hi):
    rows = [r.choice(hi, size=L, replace=False) for _ in range(N)]
    return np.array(rows, np.int32).reshape(N, L)


def _level(dev, seed, n, D, cap, count, level, budget, pad_frac=0.4,
           splice_frac=0.1, strided=False):
    from repro_torch.core.enumerate import prune_table
    r = np.random.default_rng(seed)
    ell = r.integers(0, n, (n, D)).astype(np.int32)
    ell[r.random((n, D)) < pad_frac] = n
    verts = np.full((cap, budget + 3), -1, np.int32)
    if n >= level + 1 and count:
        # distinct vertices per row, drawn fast: a random offset walk
        start = r.integers(0, n, (count, 1))
        steps = np.cumsum(r.integers(1, max(n // (level + 2), 2),
                                     (count, level + 1)), axis=1)
        verts[:count, :level + 1] = (start + steps) % n
    remaining = budget - (level + 1)
    slack = r.integers(-1, budget + 1, n + 1).astype(np.int8)
    splice = np.where(r.random(n + 1) < splice_frac,
                      r.integers(remaining, remaining + 2, n + 1),
                      -1).astype(np.int8)
    slack[-1] = splice[-1] = -1
    v = torch.from_numpy(verts).to(dev)
    v = v[:, :budget + 1] if strided else v[:, :budget + 1].contiguous()
    return (v, torch.tensor(count, device=dev), torch.from_numpy(ell).to(dev),
            prune_table(torch.from_numpy(slack), torch.from_numpy(splice))
            .to(dev))


def _outputs(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for part in out for t in _outputs(part)]


def _equal(got, want):
    got, want = _outputs(got), _outputs(want)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# (n, D, cap, count, level, budget, out_cap, stop, strided): D 32 and 64,
# count < cap, overflowing out_caps, stop_vertex set and -2, an empty
# frontier, the first level, a 2**16-row frontier, a strided frontier
LEVEL_CASES = [(300, 32, 64, 50, 2, 5, 4096, -2, False),
               (300, 32, 64, 50, 2, 5, 40, -2, True),
               (200, 64, 32, 31, 3, 6, 2048, "row", False),
               (200, 64, 32, 20, 1, 4, 100, "row", True),
               (120, 32, 16, 0, 2, 5, 256, -2, False),
               (90, 32, 1, 1, 0, 3, 64, -2, False),
               (1000, 96, 40, 40, 3, 7, 5000, 5, False),
               (1 << 20, 32, 1 << 16, 60000, 3, 7, 1 << 21, -2, False),
               # planned caps: many rows per warp, most rows past count
               (1 << 20, 32, 1 << 20, 3000, 3, 7, 1 << 20, -2, False),
               (5000, 32, 200_000, 150_001, 2, 6, 1 << 18, "row", True),
               (1 << 20, 32, 1 << 16, 1 << 16, 5, 8, 1 << 16, "row", True)]


@pytest.mark.parametrize("case", LEVEL_CASES)
def test_fused_expand_level_matches_plain(dev, case):
    from repro_torch.core.enumerate import expand_level_cuda, expand_level_ref
    n, D, cap, count, level, budget, out_cap, stop, strided = case
    verts, cnt, ell, prune = _level(dev, cap + D, n, D, cap, count, level,
                                    budget, strided=strided)
    if stop == "row":
        stop = int(verts[count // 2, level])
    kw = dict(level=level, budget=budget, out_cap=out_cap)
    before = (LAUNCHES["path_member"], LAUNCHES["level_fused"])
    got = expand_level_cuda(verts, cnt, ell, prune, stop, **kw)
    want = expand_level_ref(verts, cnt, ell, prune, stop, **kw)
    torch.cuda.synchronize()
    assert (LAUNCHES["path_member"], LAUNCHES["level_fused"]) == \
        (before[0] + 1, before[1] + 1)
    _equal(got, want)


def test_fused_expand_level_in_a_cuda_graph(dev):
    """Nothing inside allocates outside the graph's pool or syncs: 50
    levels captured in one graph and replayed equal the plain version."""
    from repro_torch.core.enumerate import expand_level_cuda, expand_level_ref
    verts, cnt, ell, prune = _level(dev, 7, 5000, 32, 4096, 3000, 3, 6)
    kw = dict(level=3, budget=6, out_cap=1 << 15)
    want = expand_level_ref(verts, cnt, ell, prune, -2, **kw)
    expand_level_cuda(verts, cnt, ell, prune, -2, **kw)          # warm
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [expand_level_cuda(verts, cnt, ell, prune, -2, **kw)
                for _ in range(50)]
    graph.replay()
    torch.cuda.synchronize()
    for got in (outs[0], outs[-1]):
        _equal(got, want)


def _joins(dev, seed, NA, NB, a_col, b_col, a_count, b_count, keys):
    from repro_torch.core.join import sort_by_last
    r = np.random.default_rng(seed)
    # rows wider than the halves the join reads, as in the engine
    A = torch.from_numpy(_simple_rows(r, NA, a_col + 3, keys)).to(dev)
    B = torch.from_numpy(_simple_rows(r, NB, b_col + 2, keys)).to(dev)
    sa = sort_by_last(A, torch.tensor(a_count, device=dev), col=a_col)
    return A, B, sa, torch.tensor(b_count, device=dev)


# (NA, NB, a_col, b_col, a_count, b_count, keys, cap): few keys make big
# buckets; caps that overflow; an empty side; 2**16 pairs and more
KEYED_CASES = [(64, 48, 3, 2, 60, 40, 10, 1024),
               (64, 48, 3, 2, 60, 40, 10, 32),
               (20, 200, 1, 4, 20, 150, 10, 512),
               (9, 9, 2, 2, 0, 9, 10, 16),
               (4096, 4096, 3, 3, 4000, 4096, 300, 1 << 16),
               (4096, 4096, 3, 3, 4000, 4096, 300, 1 << 20)]


@pytest.mark.parametrize("case", KEYED_CASES)
def test_fused_keyed_joins_match_plain(dev, case):
    from repro_torch.core import join
    NA, NB, a_col, b_col, a_count, b_count, keys, cap = case
    A, B, sa, bc = _joins(dev, NA + cap, NA, NB, a_col, b_col, a_count,
                          b_count, keys)
    width = a_col + b_col + 2
    kw = dict(a_col=a_col, b_col=b_col)
    before = (LAUNCHES["rowwise_overlap"], LAUNCHES["join_fused"])
    _equal(join.keyed_join_cuda(sa, B, bc, out_cap=cap, out_width=width,
                                **kw),
           join.keyed_join_ref(sa, B, bc, out_cap=cap, out_width=width, **kw))
    _equal(join.keyed_join_count_cuda(sa, B, bc, pair_cap=cap, **kw),
           join.keyed_join_count_ref(sa, B, bc, pair_cap=cap, **kw))
    assert (LAUNCHES["rowwise_overlap"], LAUNCHES["join_fused"]) == \
        (before[0] + 2, before[1] + 2)


# (NP, NC, p_col, c_col, p_count, c_count, cap): overflow, an empty child
# set, 2**16 pairs and more
SPLICE_CASES = [(40, 30, 2, 3, 35, 30, 2048), (40, 30, 2, 3, 35, 30, 100),
                (16, 16, 0, 4, 16, 0, 64), (7, 50, 3, 1, 7, 44, 512),
                (512, 256, 3, 3, 500, 256, 1 << 17),
                (512, 256, 3, 3, 500, 256, 1 << 16)]


@pytest.mark.parametrize("case", SPLICE_CASES)
def test_fused_splice_join_matches_plain(dev, case):
    from repro_torch.core import join
    NP, NC, p_col, c_col, p_count, c_count, cap = case
    r = np.random.default_rng(NP + cap)
    P = torch.from_numpy(_simple_rows(r, NP, p_col + 2, 400)).to(dev)
    C = torch.from_numpy(_simple_rows(r, NC, c_col + 1, 400)).to(dev)
    kw = dict(p_col=p_col, c_col=c_col, out_cap=cap,
              out_width=p_col + c_col + 3)
    args = (P, torch.tensor(p_count, device=dev), C,
            torch.tensor(c_count, device=dev))
    _equal(join.cross_join_cuda(*args, **kw), join.cross_join_ref(*args, **kw))


def test_engine_on_card_runs_the_fused_passes_only(dev, monkeypatch):
    """Every level and join of the engine on the card is a fused launch,
    no CUDA tensor reaches a plain version, and the answers equal the
    CPU's."""
    from repro_torch.core import (EngineConfig, PathQuery, PathSession,
                                  enumerate as enum, generators, join)
    from repro_torch.kernels import reset_launches

    def refuse_cuda(fn):
        def plain(*args, **kw):
            assert not any(isinstance(a, torch.Tensor) and a.is_cuda
                           for a in args), f"{fn.__name__} on the card"
            return fn(*args, **kw)
        return plain

    g = generators.community(3000, n_comm=6, avg_deg=6.0, seed=3)
    base = generators.similar_queries(g, 12, similarity=0.8, k_range=(5, 6),
                                      seed=4)
    qs = [PathQuery(s, t, k) for s, t, k in base]
    qs += [PathQuery(s, t, k, output="count") for s, t, k in base[:4]]
    on_cpu = PathSession(g, EngineConfig(), device="cpu").run(qs)
    for mod, name in ((enum, "expand_level_ref"), (join, "keyed_join_ref"),
                      (join, "keyed_join_count_ref"),
                      (join, "cross_join_ref")):
        monkeypatch.setattr(mod, name, refuse_cuda(getattr(mod, name)))
    reset_launches()
    on_card = PathSession(g, EngineConfig(), device="cuda").run(qs)
    assert LAUNCHES["level_fused"] == LAUNCHES["path_member"] > 0
    assert LAUNCHES["join_fused"] == LAUNCHES["rowwise_overlap"] > 0
    for q, a, b in zip(qs, on_card, on_cpu):
        assert a.count == b.count
        if q.output.value == "paths":
            assert np.array_equal(a.paths, b.paths)


@pytest.mark.parametrize("n_replicas", [2, 4])
def test_replicas_on_one_card_match_one_replica(dev, n_replicas):
    """Replicas on streams of one card give one replica's results; each
    replica's fused levels run on its own stream."""
    from repro_torch.core import EngineConfig, PathSession, generators
    from repro_torch.kernels import reset_launches
    g = generators.community(2400, n_comm=12, avg_deg=4.0, p_intra=1.0,
                             seed=0)
    qs = generators.random_queries(g, 24, k_range=(4, 5), seed=1)
    one = PathSession(g, EngineConfig(min_cap=128), device="cuda")
    many = PathSession(g, EngineConfig(min_cap=128), device="cuda",
                       mesh=["cuda:0"] * n_replicas)
    for planner in ("batch", "basic", "auto"):
        want = one.run(qs, planner=planner)
        reset_launches()
        got = many.run(qs, planner=planner)
        assert got.stats.get("n_clusters") == want.stats.get("n_clusters")
        for a, b in zip(got, want):
            assert np.array_equal(a.paths, b.paths)
    got = many.run(qs, planner="batch")
    assert len(got.stats["per_device"]) == n_replicas
    assert sum(d["n_clusters"] for d in got.stats["per_device"]) == \
        got.stats["n_clusters"] > 1
    streams = {s.cuda_stream for s in many.engine.executor._streams[1:]}
    assert len(streams) == n_replicas - 1 and \
        torch.cuda.current_stream().cuda_stream not in streams
    # a second engine's replicas take the same streams: blocks cached on
    # them stay in use instead of stranding on streams no one takes again
    again = PathSession(g, EngineConfig(min_cap=128), device="cuda",
                        mesh=["cuda:0"] * n_replicas)
    again.run(qs, planner="batch")
    assert {s.cuda_stream for s in again.engine.executor._streams[1:]} \
        == streams


def test_first_kernel_load_from_four_threads(dev, tmp_path, monkeypatch):
    """Four threads load a library that is not built yet: one ``nvcc``,
    one library, no temporary file left, and each thread's launch
    counted."""
    import threading

    from repro_torch.kernels import reset_launches
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    build._cdll.cache_clear()
    ell = torch.randint(0, 1001, (1000, 8), dtype=torch.int32, device=dev)
    xs = torch.rand((1001, 1), device=dev)            # (V+1, F): a pad row
    want = ell_spmm_ref(ell, xs, "sum")
    barrier = threading.Barrier(4)
    outs, errs = [None] * 4, []

    def work(i):
        try:
            barrier.wait()
            outs[i] = ell_spmm_cuda(ell, xs, "sum")
            torch.cuda.current_stream(dev).synchronize()
        except BaseException as e:  # noqa: BLE001 -- reported below
            errs.append(e)

    reset_launches()
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)                       # one nvcc at most
        assert not any(t.is_alive() for t in threads)
    finally:
        build._cdll.cache_clear()
    assert not errs, errs
    assert all(torch.equal(o, want) for o in outs)
    assert [p.name for p in tmp_path.iterdir()] == \
        [build.library_path("ell_spmm").name]
    assert LAUNCHES["ell_spmm"] == 4


# ---------------------------------------------------------------------
# the gradient: each route's lse, flash_attention_bwd, a training step
# ---------------------------------------------------------------------

@pytest.mark.parametrize("route,case", ROUTE_CASES, ids=str)
def test_flash_attention_lse_on_every_route(dev, route, case):
    """return_lse leaves the output bit-identical and gives each row's
    log-sum-exp: 1e-3 of the plain version's (the scores sum in another
    order; -inf where a row sees no key)."""
    B, Sq, Skv, Hq, Hkv, hd, causal, q_offset, valid = case
    r = np.random.default_rng(Sq * 7 + hd)
    q, k, v = (torch.from_numpy(r.standard_normal(shape).astype(np.float32))
               .to(dev, torch.bfloat16)
               for shape in ((B, Sq, Hq, hd), (B, Skv, Hkv, hd),
                             (B, Skv, Hkv, hd)))
    kw = dict(q_offset=q_offset, kv_valid_len=valid)
    plain = flash_attention_cuda(q, k, v, causal, **kw)
    out, lse = flash_attention_cuda(q, k, v, causal, return_lse=True, **kw)
    assert torch.equal(out.view(torch.int16), plain.view(torch.int16))
    _, want = flash_attention_ref(q, k, v, causal, return_lse=True, **kw)
    torch.testing.assert_close(lse, want, atol=1e-3, rtol=1e-3)
    _, lse32 = flash_attention_cuda(q.float(), k.float(), v.float(), causal,
                                    return_lse=True, **kw)
    torch.testing.assert_close(lse32, want, atol=1e-4, rtol=1e-4)


# (B, Sq, Skv, Hq, Hkv, hd, causal, q_offset, kv_valid_len)
BWD_CASES = [
    (2, 64, 64, 4, 2, 64, True, None, None),
    (1, 130, 130, 32, 8, 128, True, None, None),
    (2, 50, 50, 6, 3, 24, True, None, None),
    (1, 40, 90, 8, 2, 256, False, None, 70),
    (1, 33, 40, 4, 1, 96, True, 5, 37),
    (1, 6, 6, 2, 1, 16, True, -2, None),
    (2, 20, 20, 4, 2, 12, True, None, None),       # unaligned: no vec
    (1, 200, 200, 8, 8, 128, True, None, None),    # several key tiles, G 1
    # the wgmma route (bf16, hd 64 or 128): S not a multiple of the tiles,
    # G 1, 4 and 5 (row tiles of 60 rows), q_offset, kv_valid_len with and
    # without the mask, a key tile wholly past kv_valid_len, B > 1
    (1, 77, 77, 10, 2, 128, True, None, None),
    (2, 45, 45, 5, 1, 64, True, None, None),
    (2, 100, 100, 8, 2, 64, True, None, None),
    (1, 100, 150, 8, 2, 128, True, 30, None),
    (1, 40, 40, 2, 2, 64, True, -3, None),         # rows that see no key
    (2, 70, 190, 4, 1, 64, False, None, 133),
    (1, 96, 96, 4, 4, 64, True, None, 70),
    (1, 64, 300, 4, 1, 128, False, None, 100),
    # the mma route at HDP 64 (hd 48; hd 36, no 16-byte loads) and past
    # the wgmma route's groups (G 65 at hd 128)
    (1, 70, 70, 8, 2, 48, True, None, None),
    (2, 30, 30, 4, 2, 36, True, None, None),
    (1, 20, 20, 65, 1, 128, True, None, None),
    # wgmma at the groups of GQA configs: G 8 (P 8), G 64 (one position a
    # tile), G 7 (63-row tiles)
    (1, 50, 50, 16, 2, 128, True, None, None),
    (1, 9, 9, 64, 1, 64, True, None, None),
    (2, 30, 30, 14, 2, 64, True, None, None),
]


def assert_grads_close(got, want, dtype):
    """float32 at 1e-4; bf16 (float32 accumulation; the tensor-core route
    rounds P and dS to bf16 for its products, and each gradient once): at
    most 2e-2 of each tensor's largest magnitude and 2e-2 relative L2 in
    every row of hd values."""
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if dtype == "float32":
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
            continue
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 2e-2 * scale
        rel = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-3 * scale)
        assert float(rel.max()) <= 2e-2, float(rel.max())


def _bwd_inputs(dev, case, dt):
    B, Sq, Skv, Hq, Hkv, hd = case[:6]
    r = np.random.default_rng(Sq * 13 + hd)
    return tuple(
        torch.from_numpy(r.standard_normal(shape).astype(np.float32))
        .to(dev, dt) for shape in ((B, Sq, Hq, hd), (B, Skv, Hkv, hd),
                                   (B, Skv, Hkv, hd), (B, Sq, Hq, hd)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_flash_attention_bwd_matches_plain(dev, case, dtype):
    B, Sq, Skv, Hq, Hkv, hd, causal, q_offset, valid = case
    dt = getattr(torch, dtype)
    q, k, v, dout = _bwd_inputs(dev, case, dt)
    kw = dict(q_offset=q_offset, kv_valid_len=valid)
    o, lse = flash_attention_cuda(q, k, v, causal, return_lse=True, **kw)
    route = f"bwd_{bwd_plan(q, k, v, o, dout)}"
    before = dict(LAUNCHES)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, dout, causal, **kw)
    want = flash_attention_bwd_ref(q, k, v, o, lse, dout, causal, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    assert LAUNCHES[route] == before[route] + 1
    # contiguous inputs allow 16-byte loads iff hd % 8 == 0
    assert route == f"bwd_{bwd_route(Hq // Hkv, hd, dt, hd % 8 == 0)}"
    assert [g.dtype for g in got] == [dt] * 3
    assert_grads_close(got, want, dtype)
    if valid is not None:
        assert not got[1][:, valid:].any() and not got[2][:, valid:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [BWD_CASES[i] for i in
                                  (1, 4, 8, 10, 13, 16, 18, 20, 21)],
                         ids=str)
def test_flash_attention_bwd_is_bitwise_repeatable(dev, case, dtype):
    """Two launches on the same inputs give the same dQ, dK and dV bit for
    bit on every route: each gradient is summed in a fixed order (exact
    crash-resume depends on it)."""
    causal, q_offset, valid = case[6:]
    dt = getattr(torch, dtype)
    q, k, v, dout = _bwd_inputs(dev, case, dt)
    kw = dict(q_offset=q_offset, kv_valid_len=valid)
    o, lse = flash_attention_cuda(q, k, v, causal, return_lse=True, **kw)
    first = flash_attention_bwd_cuda(q, k, v, o, lse, dout, causal, **kw)
    again = flash_attention_bwd_cuda(q, k, v, o, lse, dout, causal, **kw)
    torch.cuda.synchronize()
    bits = torch.int16 if dt == torch.bfloat16 else torch.int32
    for a, b in zip(first, again):
        assert torch.equal(a.view(bits), b.view(bits))


@pytest.mark.parametrize("case", [BWD_CASES[i] for i in (9, 21)], ids=str)
def test_flash_attention_bwd_refuses_a_short_scratch(dev, monkeypatch, case):
    """The launch checks the length of the wrapper's delta scratch against
    the wgmma route's row tiles: one tile too few is refused with an
    error, not written past."""
    from repro_torch.kernels.flash_attention import ops
    causal = case[6]
    q, k, v, dout = _bwd_inputs(dev, case, torch.bfloat16)
    o, lse = flash_attention_cuda(q, k, v, causal, return_lse=True)
    assert bwd_plan(q, k, v, o, dout) == "wgmma"
    tiles = ops.bwd_row_tiles
    monkeypatch.setattr(ops, "bwd_row_tiles",
                        lambda Sq, group: (tiles(Sq, group)[0],
                                           tiles(Sq, group)[1] - 1))
    before = dict(LAUNCHES)
    with pytest.raises(RuntimeError, match="flash_attention_bwd"):
        flash_attention_bwd_cuda(q, k, v, o, lse, dout, causal)
    assert LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"]


def test_gqa_attention_gradient_on_card_goes_through_the_kernels(dev):
    r = np.random.default_rng(3)
    q, k, v, dout = (
        torch.from_numpy(r.standard_normal(shape).astype(np.float32))
        .to(dev, torch.bfloat16)
        for shape in ((2, 96, 8, 128), (2, 96, 2, 128), (2, 96, 2, 128),
                      (2, 96, 8, 128)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = dict(LAUNCHES)
    out = gqa_attention(*leaves)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert LAUNCHES["attn_wgmma"] == before["attn_wgmma"] + 1
    assert LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    route = f"bwd_{bwd_route(4, 128, torch.bfloat16, True)}"
    assert route == "bwd_wgmma"
    assert LAUNCHES[route] == before[route] + 1
    # the plain backward of the same forward (o and lse): dS = P (dP - D)
    # cancels where a row's attention is concentrated, so a forward that
    # rounds p elsewhere would move it by more than the bf16 tolerance
    o, lse = flash_attention_cuda(q, k, v, True, return_lse=True)
    torch.testing.assert_close(out.detach(), o, atol=0, rtol=0)
    assert_grads_close(got, flash_attention_bwd_ref(q, k, v, o, lse, dout),
                       "bfloat16")


@pytest.mark.parametrize("arch", ["granite-8b", "olmoe-1b-7b"])
def test_reduced_training_step_on_card_matches_cpu(dev, arch):
    """float32 (TF32 off), remat on: one step of the train bundle on the
    card equals the CPU port's at 1e-4 (loss, grad norm, parameters),
    with the forward twice a layer (remat) and the backward kernel once."""
    from repro_torch.config import RunOptions
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.steps import build_bundle
    from repro_torch.launch.train import make_init_and_batches
    from repro_torch.models.transformer import train_params
    from repro_torch.optim import adamw_init
    from repro_torch.pytree import leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    bundle = build_bundle(arch, "train_4k",
                          RunOptions(seq_parallel=False, loss_chunk=16,
                                     moe_groups=4),
                          reduced=True,
                          overrides={"seq_len": 32, "global_batch": 2})
    init_state, batch_fn = make_init_and_batches(bundle, "cpu")
    cpu_params, cpu_opt = init_state()
    card_params = train_params(bundle.cfg, cpu_params, device="cuda")
    card_opt = adamw_init(card_params)
    tok, tgt = batch_fn(0)
    _, _, m_cpu = bundle.step_fn(cpu_params, cpu_opt, tok, tgt)
    reset_launches()
    _, _, m_card = bundle.step_fn(card_params, card_opt, tok.cuda(),
                                  tgt.cuda())
    torch.cuda.synchronize()
    for key in ("loss", "grad_norm"):
        assert float(m_card[key]) == pytest.approx(float(m_cpu[key]),
                                                   rel=1e-4)
    for a, b in zip(leaves(card_params), leaves(cpu_params)):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), atol=1e-4,
                                   rtol=1e-4)
    L = bundle.cfg.n_layers
    assert LAUNCHES["flash_attention"] == LAUNCHES["attn_scalar"] == 2 * L
    assert LAUNCHES["flash_attention_bwd"] == LAUNCHES["bwd_scalar"] == L


# ----------------------------------------------------------------------
# the programs over a layout of slots (launch/collectives.py) on
# ["cuda:0"] * n: each slot on its own stream of one card
# ----------------------------------------------------------------------

# (route, q type, cache type): the decode routes a slot's partial takes
PARTIAL_ROUTES = (("splitk", torch.bfloat16, torch.bfloat16),
                  ("splitk_f8", torch.bfloat16, torch.float8_e4m3fn),
                  ("scalar", torch.float32, torch.float32))


@pytest.mark.parametrize("valid", [0, 1, 77, 640])
@pytest.mark.parametrize("route,qt,kt", PARTIAL_ROUTES, ids=str)
def test_attention_partial_on_card_matches_plain(dev, route, qt, kt, valid):
    """A slot's partial (flash_decode): float32 out and the lse; a slot
    that sees no key gives zeros and -inf (no NaN, nothing unwritten),
    as the plain version; the split-K routes' float32 out rounds to their
    bf16 out bit for bit."""
    from repro_torch.kernels.flash_attention.ops import attention_partial
    from repro_torch.models.transformer import quantize_f8
    gen = torch.Generator(device="cuda").manual_seed(valid + len(route))
    q = torch.randn(2, 1, 32, 128, generator=gen, device=dev).to(qt)
    k = torch.randn(2, 640, 8, 128, generator=gen, device=dev)
    v = torch.randn(2, 640, 8, 128, generator=gen, device=dev)
    if kt == torch.float8_e4m3fn:
        k, v = quantize_f8(k), quantize_f8(v)
    else:
        k, v = k.to(kt), v.to(kt)
    k[:, valid:] = float("nan")             # a stale tail is never read
    v[:, valid:] = float("nan")
    before = LAUNCHES[f"attn_{route}"]
    out, lse = attention_partial(q, k, v, valid)
    torch.cuda.synchronize()
    assert LAUNCHES[f"attn_{route}"] == before + 1
    assert out.dtype == torch.float32 and lse.shape == (2, 32, 1)
    want, want_lse = attention_partial(q.cpu(), k.cpu(), v.cpu(), valid)
    if valid == 0:
        assert torch.equal(out.cpu(), torch.zeros_like(want))
        assert bool((lse == float("-inf")).all())
        assert torch.equal(want, torch.zeros_like(want))
        assert bool((want_lse == float("-inf")).all())
        return
    assert bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
    tol = 3e-5 if qt == torch.float32 else 1e-2
    torch.testing.assert_close(out.cpu(), want, atol=tol, rtol=tol)
    torch.testing.assert_close(lse.cpu(), want_lse, atol=tol, rtol=tol)
    if route.startswith("splitk"):
        rounded = flash_attention_cuda(q, k, v, False, q_offset=0,
                                       kv_valid_len=valid)
        assert torch.equal(out.to(torch.bfloat16), rounded)


def _reduced_lm(dtype: str, device: str, tp: int = 1):
    """REDUCED granite-8b in ``dtype``, drawn on the CPU from seed 0 with
    its q heads padded for a ``tp``-way tensor axis, on ``device``."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.models.transformer import LM, init_lm_params
    cfg = dataclasses.replace(get("granite-8b").REDUCED, dtype=dtype)
    params = init_lm_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu", tp=tp)
    return LM(cfg, params, device=device)


def _mesh_decode(model, layout, kv, B=4, S=512, steps=6, start=316):
    """Six teacher-forced flash_decode steps over ``layout`` from
    position ``start`` of a seeded cache (slots past it empty)."""
    from repro_torch.config import RunOptions
    from repro_torch.models.transformer import quantize_f8, shard_cache
    opts = RunOptions(flash_decode=True, kv_cache_dtype=kv)
    m = model.with_mesh(layout, opts)
    full = model.with_mesh(None, opts).init_cache(B, S)
    gen = torch.Generator().manual_seed(7)
    fill = torch.randn(full["k"][:, :, :start].shape, generator=gen)
    for name, x in (("k", fill), ("v", fill * 0.5)):
        x = x.to(model.device)
        full[name][:, :, :start] = (quantize_f8(x) if kv == "f8"
                                    else x.to(full[name].dtype))
    full["pos"] = start
    cache = full if layout is None else shard_cache(full, m.rules)
    toks = np.random.default_rng(8).integers(0, model.cfg.vocab, (B, steps))
    got = []
    for t in range(steps):
        logits, cache = m.decode_step(toks[:, t:t + 1], cache)
        got.append(logits.cpu())
    return torch.cat(got, 1)


def test_flash_decode_on_card_slots_matches_cpu(dev):
    """float32 (the scalar route): the reduced model's flash_decode over
    eight cuda:0 slots, (2, 4), equals the same over eight CPU slots at
    1e-4, one launch a slot and layer."""
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    on_cpu = _reduced_lm("float32", "cpu")
    on_card = _reduced_lm("float32", "cuda")
    want = _mesh_decode(on_cpu, make_host_mesh(2, 4, ["cpu"] * 8), "bf16")
    reset_launches()
    got = _mesh_decode(on_card, make_host_mesh(2, 4), "bf16")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert LAUNCHES["flash_attention"] == LAUNCHES["attn_scalar"] \
        == 8 * on_card.cfg.n_layers * 6


@pytest.mark.parametrize("kv", ["bf16", "f8"])
def test_flash_decode_on_card_matches_one_slot(dev, kv):
    """bf16 model (split-K, float8 or bf16 cache): flash_decode over (2, 4)
    and (1, 8) slots of one card (the weights cut over them too) against
    the one-slot decode over the same cache; the kernel launched once a
    slot and layer on the cache's split-K route. The slots' float32 partials merge in another order than
    the one-slot chunks: a bf16 output flips a rounding now and then, and
    in this 64-wide model one flip moves a row's logits by up to about 1%
    relative L2 (2e-2 allowed); over a float8 cache the flip also moves
    the next layer's written keys by an e4m3 step, 2**-3 relative (5e-2)."""
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.mesh import make_host_mesh
    route = "attn_splitk_f8" if kv == "f8" else "attn_splitk"
    for shape, B in (((2, 4), 4), ((1, 8), 1)):
        # the layout cuts the weights too: the 4 q heads padded to 8 for
        # the 8-way tensor axis, on both sides
        model = _reduced_lm("bfloat16", "cuda", tp=shape[1])
        want = _mesh_decode(model, None, kv, B=B)
        reset_launches()
        got = _mesh_decode(model, make_host_mesh(*shape), kv, B=B)
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention"] == LAUNCHES[route] \
            == 8 * model.cfg.n_layers * 6
        rel = (got - want).norm(dim=-1) / want.norm(dim=-1)
        bound = 5e-2 if kv == "f8" else 2e-2
        assert float(rel.max()) <= bound, (shape, float(rel.max()))


def _sharded_serve(model, layout, opts, B=4, S=32, steps=4):
    """The sharded prefill of a seeded prompt and ``steps`` gathered or
    ``flash_decode`` steps from position ``S`` of a seeded cache of
    ``2 S``; the logits (on the CPU) and each call's launches by route."""
    from repro_torch.kernels import reset_launches
    from repro_torch.kernels.flash_attention.ops import ROUTES
    from repro_torch.models.transformer import shard_cache
    m = model.with_mesh(layout, opts)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, model.cfg.vocab, (B, S + steps)))
    reset_launches()
    got = [m.prefill(toks[:, :S]).cpu()]
    routes = [{r: LAUNCHES[f"attn_{r}"] for r in ROUTES}]
    full = model.with_mesh(None, opts).init_cache(B, 2 * S)
    gen = torch.Generator().manual_seed(11)
    for name in ("k", "v"):
        x = torch.randn(full[name][:, :, :S].shape, generator=gen)
        full[name][:, :, :S] = x.to(model.device, full[name].dtype)
    full["pos"] = S
    cache = full if layout is None else shard_cache(full, m.rules)
    for t in range(steps):
        reset_launches()
        logits, cache = m.decode_step(toks[:, S + t:S + t + 1], cache)
        got.append(logits.cpu())
        routes.append({r: LAUNCHES[f"attn_{r}"] for r in ROUTES})
    return torch.cat(got, 1), routes


@pytest.mark.parametrize("arch", ["granite-8b", "olmoe-1b-7b"])
def test_sharded_lm_on_card_slots_matches_cpu(dev, arch):
    """float32 (TF32 off): the reduced model served over eight cuda:0
    slots, (2, 4) under "2d" with seq_parallel, prefill and the gathered
    and flash_decode steps, equals the same over eight CPU slots at 1e-4;
    every call one attn_scalar launch a slot and layer."""
    import dataclasses
    from repro_torch.config import RunOptions
    from repro_torch.configs import get
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import LM
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get(arch).REDUCED, dtype="float32")
    on_cpu = LM(cfg, generator=torch.Generator().manual_seed(0),
                device="cpu")
    params = {n: getattr(on_cpu, n) for n, _ in on_cpu.named_parameters()
              if "." not in n}
    params["layers"] = {n: torch.stack([getattr(lp, n)
                                        for lp in on_cpu.layers])
                        for n, _ in on_cpu.layers[0].named_parameters()}
    on_card = LM(cfg, params, device="cuda")
    L = cfg.n_layers
    for flash in (False, True):
        opts = RunOptions(flash_decode=flash)
        want, _ = _sharded_serve(on_cpu, make_host_mesh(2, 4, ["cpu"] * 8),
                                 opts)
        got, routes = _sharded_serve(on_card, make_host_mesh(2, 4), opts)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        for r in routes:
            assert r == {**dict.fromkeys(r, 0), "scalar": 8 * L}, r


def test_sharded_lm_bf16_takes_the_one_device_routes(dev):
    """bf16 at hd 128 (a 4-layer granite cut: 8 q heads over 4 KV heads,
    d_model 512): over (2, 4) and (1, 8) slots of the card each slot's
    prefill runs attn_wgmma and each decode step attn_splitk, once a slot
    and layer, as the one-device shapes do; the logits within 2e-2 row
    relative L2 of the one-device model's (bf16 products over other
    widths, a rounding flipped now and then)."""
    import dataclasses
    from repro_torch.config import RunOptions
    from repro_torch.configs import get
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import LM
    cfg = dataclasses.replace(get("granite-8b").REDUCED, dtype="bfloat16",
                              n_layers=4, d_model=512, n_heads=8,
                              n_kv_heads=4, head_dim=128, d_ff=1024,
                              vocab=1024)
    model = LM(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
               device="cuda")
    L = cfg.n_layers
    for shape, mode in (((2, 4), "2d"), ((1, 8), "tp_only")):
        for flash in (False, True):
            opts = RunOptions(flash_decode=flash, serve_param_sharding=mode)
            want, one = _sharded_serve(model, None, opts)
            got, routes = _sharded_serve(model, make_host_mesh(*shape), opts)
            assert one[0]["wgmma"] == L and one[1]["splitk"] == L
            assert routes[0] == {**dict.fromkeys(routes[0], 0),
                                 "wgmma": 8 * L}
            for r in routes[1:]:
                assert r == {**dict.fromkeys(r, 0), "splitk": 8 * L}, r
            rel = (got - want).norm(dim=-1) / want.norm(dim=-1)
            assert float(rel.max()) <= 2e-2, (shape, flash, float(rel.max()))


@pytest.mark.parametrize("P", [8, 3])
def test_ring_aggregate_on_card_slots_matches_cpu(dev, P):
    """The ring over P cuda:0 slots equals it over P CPU slots: integer
    features exactly, normal ones within 1e-5."""
    from repro_torch.launch.mesh import make_cells_mesh
    from repro_torch.models.gnn import ring_aggregate
    r = np.random.default_rng(P)
    N_loc, F, Eb = 300, 16, 400
    es = torch.from_numpy(r.integers(0, N_loc, (P, P, Eb)).astype(np.int32))
    ed = torch.from_numpy(r.integers(0, N_loc, (P, P, Eb)).astype(np.int32))
    em = torch.from_numpy(r.random((P, P, Eb)) < 0.7)
    for feats, exact in ((r.integers(-50, 50, (P * N_loc, F)), True),
                         (r.standard_normal((P * N_loc, F)), False)):
        h = torch.from_numpy(feats.astype(np.float32))
        want = ring_aggregate(list(h.split(N_loc)), es, ed, em,
                              make_cells_mesh(devices=["cpu"] * P), "cells")
        got = ring_aggregate(list(h.to(dev).split(N_loc)), es.to(dev),
                             ed.to(dev), em.to(dev),
                             make_cells_mesh(devices=["cuda:0"] * P), "cells")
        torch.testing.assert_close(torch.cat(got).cpu(), torch.cat(want),
                                   atol=1e-5, rtol=0)
        if exact:
            assert torch.equal(torch.cat(got).cpu(), torch.cat(want))


def test_collectives_and_ef_psum_on_card_slots(dev):
    """psum / pmax over cuda:0 slots equal the fold over a list on the
    card; a ppermute copies into fresh buffers; ef_compressed_psum_axis
    equals its sequence form bit for bit."""
    import functools
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import Layout, make_host_mesh
    from repro_torch.optim.compress import (ef_compressed_psum,
                                            ef_compressed_psum_axis)
    layout = make_host_mesh(2, 4)
    gen = torch.Generator(device="cuda").manual_seed(9)
    xs = [torch.randn(1000, generator=gen, device=dev) for _ in range(8)]
    got = collectives.psum(xs, layout, "model")
    assert torch.equal(got[5], functools.reduce(torch.add, xs[4:]))
    got = collectives.pmax(xs, layout, "data")
    assert torch.equal(got[6], torch.maximum(xs[2], xs[6]))
    got = collectives.ppermute(xs, layout, "model",
                               [(i, (i + 1) % 4) for i in range(4)])
    assert torch.equal(got[1], xs[0]) and got[1].data_ptr() != xs[0].data_ptr()
    pod = Layout("pods", ("pod",), (8,), ("cuda:0",) * 8)
    errs = seq = [torch.zeros(4096, device=dev) for _ in range(8)]
    for _ in range(5):
        grads = [torch.randn(4096, generator=gen, device=dev) * 100
                 for _ in range(8)]
        red, errs = ef_compressed_psum_axis(grads, errs, pod, "pod")
        want, seq = ef_compressed_psum(grads, seq)
        assert all(torch.equal(x, want) for x in red)
        assert all(torch.equal(a, b) for a, b in zip(errs, seq))
