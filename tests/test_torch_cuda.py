"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc``; elsewhere each one
skips with the reason. Run them on a machine with a card::

    python -m pytest -q -m gpu tests/test_torch_cuda.py

The inputs are integers, or (``ell_spmm``) float32 sums taken in the same
order by the kernel and its plain version, so every comparison is exact
equality.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import LAUNCHES, build  # noqa: E402
from repro_torch.kernels.ell_spmm.ops import (  # noqa: E402
    ell_aggregate, ell_spmm_cuda, ell_spmm_ref)
from repro_torch.kernels.msbfs_expand.ops import (  # noqa: E402
    msbfs_step_cuda, msbfs_step_ref, pack_bits)
from repro_torch.kernels.pairwise_popcount.ops import (  # noqa: E402
    intersections, pairwise_popcount_cuda)
from repro_torch.kernels.path_join.ops import (  # noqa: E402
    path_member_cuda, path_member_ref, rowwise_overlap_cuda,
    rowwise_overlap_ref)

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


@pytest.mark.parametrize("Q,W", [(256, 1 << 15), (17, 100), (1, 1), (5, 0),
                                 (0, 4)])
def test_pairwise_popcount_matches_plain(dev, Q, W):
    r = np.random.default_rng(Q * 7 + W)
    words = torch.from_numpy(
        r.integers(-2**31, 2**31, size=(Q, W), dtype=np.int64)
        .astype(np.int32)).to(dev)
    assert torch.equal(pairwise_popcount_cuda(words), intersections(words))


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
    # every kernel but the walk-count DP's, which plan_caps=False skips
    assert all(LAUNCHES[k] > 0 for k in LAUNCHES if k != "ell_spmm"), \
        LAUNCHES
    assert LAUNCHES["ell_spmm"] == 0
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
