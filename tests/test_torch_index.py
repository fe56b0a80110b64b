"""The port's graph, index, similarity, clustering and detection against
the JAX package, on the same graphs and queries (made from seeds).

Everything compared is integer, float64 computed from integers, or
integer-valued float32 below 2**24 (the walk counts), so the tolerance is
exact equality throughout. The JAX side runs its kernels
under the Pallas interpreter (``backend="interpret"``), as its own tests
do on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import generators as j_gen  # noqa: E402
from repro.core import oracle as j_oracle  # noqa: E402
from repro.core.clustering import cluster_queries as j_cluster  # noqa: E402
from repro.core.detect import detect_common_queries as j_detect  # noqa: E402
from repro.core.graph import DeviceGraph as JDeviceGraph  # noqa: E402
from repro.core.index import build_index as j_build_index  # noqa: E402
from repro.core.index import slack_from_dists as j_slack  # noqa: E402
from repro.core.index import walk_counts as j_walk_counts  # noqa: E402
from repro.core.index import walk_counts_ell as j_walk_counts_ell  # noqa: E402
from repro.core.msbfs import edge_span as j_edge_span  # noqa: E402
from repro.core.msbfs import msbfs_dist_ell as j_msbfs_dist_ell  # noqa: E402
from repro.core.similarity import similarity_matrix as j_similarity  # noqa: E402
from repro_torch.core import generators, oracle  # noqa: E402
from repro_torch.core.clustering import cluster_queries  # noqa: E402
from repro_torch.core.detect import detect_common_queries  # noqa: E402
from repro_torch.core.graph import DeviceGraph, Graph, pow2_ceil  # noqa: E402
from repro_torch.core.index import (build_index,  # noqa: E402
                                    slack_from_dists, walk_counts_ell)
from repro_torch.core.msbfs import (K_MAX_INT8, INF_FOR,  # noqa: E402
                                    msbfs_dist_ell)
from repro_torch.core.query import midpoint_split  # noqa: E402
from repro_torch.core.similarity import similarity_matrix  # noqa: E402

CPU = torch.device("cpu")

GRAPHS = {
    "community": (lambda m: m.community(600, n_comm=5, avg_deg=5.0, seed=0),
                  (3, 5)),
    "powerlaw": (lambda m: m.powerlaw(400, avg_deg=4.0, seed=1), (3, 4)),
    "grid": (lambda m: m.grid(16, seed=2), (4, 6)),
}


def _carry(jg):
    return Graph.from_arrays(jg.n, jg.indptr, jg.indices, jg.r_indptr,
                             jg.r_indices)


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def case(request):
    make, k_range = GRAPHS[request.param]
    jg = make(j_gen)
    g = _carry(jg)
    queries = j_gen.random_queries(jg, 12, k_range=k_range, seed=3)
    jdg = JDeviceGraph.build(jg)
    dg = DeviceGraph.build(g, CPU)
    j_index = j_build_index(jdg, queries, backend="interpret")
    index = build_index(dg, queries)
    return dict(name=request.param, jg=jg, g=g, queries=queries, jdg=jdg,
                dg=dg, j_index=j_index, index=index)


# ----------------------------------------------------------------------
# graph layer
# ----------------------------------------------------------------------

def test_generators_and_oracle_match_reference(case):
    name, jg = case["name"], case["jg"]
    g = GRAPHS[name][0](generators)
    for f in ("indptr", "indices", "r_indptr", "r_indices"):
        assert np.array_equal(getattr(g, f), getattr(jg, f))
    k_range = GRAPHS[name][1]
    assert generators.random_queries(g, 12, k_range=k_range, seed=3) == \
        case["queries"]
    s, t, k = case["queries"][0]
    assert oracle.enumerate_paths_bruteforce(g, s, t, k) == \
        j_oracle.enumerate_paths_bruteforce(jg, s, t, k)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("k_max", [0, 1, 3, 8])
def test_host_bfs_equals_reference(case, k_max, reverse):
    """The port's level-by-level host BFS gives the reference's
    vertex-queue distances (unreached = k_max + 1), from 20 sources."""
    g, jg = case["g"], case["jg"]
    for s in np.random.default_rng(k_max).choice(g.n, 20, replace=False):
        got = oracle.bfs_dist_from(g, int(s), k_max, reverse=reverse)
        want = j_oracle.bfs_dist_from(jg, int(s), k_max, reverse=reverse)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_from_arrays_carries_a_jax_graph_over(case):
    jg, g = case["jg"], case["g"]
    assert g.n == jg.n and g.m == jg.m
    for f in ("indptr", "indices", "r_indptr", "r_indices"):
        a, b = getattr(g, f), getattr(jg, f)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert g.indptr is not jg.indptr          # copied, not aliased
    with pytest.raises(ValueError):
        Graph.from_arrays(jg.n + 1, jg.indptr, jg.indices, jg.r_indptr,
                          jg.r_indices)


def test_device_graph_ell_tables_equal_reference(case):
    dg, jdg = case["dg"], case["jdg"]
    assert (dg.n, dg.m) == (jdg.n, jdg.m)
    assert (dg.ell_cap, dg.r_ell_cap) == (jdg.ell_cap, jdg.r_ell_cap)
    for mine, ref in ((dg.ell_idx, jdg.ell_idx),
                      (dg.r_ell_idx, jdg.r_ell_idx)):
        assert mine.dtype == torch.int32
        assert np.array_equal(mine.numpy(), np.asarray(ref))
    assert dg.ell_cap == pow2_ceil(int(case["g"].out_degree().max()))
    assert torch.equal(dg.direction(True), dg.r_ell_idx)


# ----------------------------------------------------------------------
# index (two MS-BFS sweeps)
# ----------------------------------------------------------------------

def test_build_index_distances_equal_reference(case):
    index, j_index = case["index"], case["j_index"]
    assert index.queries == j_index.queries and index.INF == j_index.INF
    for f in ("sources", "targets", "src_col", "tgt_col"):
        assert np.array_equal(getattr(index, f), getattr(j_index, f))
    for mine, ref in ((index.dist_s, j_index.dist_s),
                      (index.dist_t, j_index.dist_t)):
        assert mine.dtype == torch.int8
        assert np.array_equal(mine.numpy(), np.asarray(ref))


@pytest.mark.parametrize("S,k_max", [(1, 3), (31, 4), (32, 2), (45, 5),
                                     (70, 6)])
def test_msbfs_dist_ell_equals_reference_across_word_counts(S, k_max):
    jg = j_gen.powerlaw(300, avg_deg=3.0, seed=S)
    jdg = JDeviceGraph.build(jg)
    dg = DeviceGraph.build(_carry(jg), CPU)
    srcs = np.random.default_rng(S).integers(0, jg.n, S).astype(np.int32)
    for ell, j_ell in ((dg.r_ell_idx, jdg.r_ell_idx),
                       (dg.ell_idx, jdg.ell_idx)):
        got = msbfs_dist_ell(ell, torch.from_numpy(srcs), n=dg.n,
                             k_max=k_max)
        ref = j_msbfs_dist_ell(j_ell, jnp.asarray(srcs), n=jdg.n,
                               k_max=k_max, backend="jnp")
        assert got.shape == (dg.n + 1, S)
        assert np.array_equal(got.numpy(), np.asarray(ref))
        assert bool((got[dg.n] == INF_FOR(k_max)).all())


def test_msbfs_dist_ell_empty_graph():
    g = Graph.from_edges(5, np.empty(0, np.int32), np.empty(0, np.int32))
    dg = DeviceGraph.build(g, CPU)
    got = msbfs_dist_ell(dg.r_ell_idx, torch.tensor([0, 3]), n=5, k_max=3)
    expect = np.full((6, 2), 4, np.int8)
    expect[0, 0] = expect[3, 1] = 0
    assert np.array_equal(got.numpy(), expect)


@pytest.mark.parametrize("k_max", [-1, K_MAX_INT8 + 1])
def test_msbfs_k_max_guard(k_max):
    dg = DeviceGraph.build(generators.grid(4), CPU)
    with pytest.raises(ValueError, match="K_MAX_INT8"):
        msbfs_dist_ell(dg.r_ell_idx, torch.tensor([0]), n=dg.n, k_max=k_max)


def test_slack_from_dists_equals_reference(case):
    index, j_index = case["index"], case["j_index"]
    qs = [0, 3, 5]
    ks = np.array([index.queries[q][2] for q in qs], np.int32)
    offs = np.array([0, 1, 2], np.int32)
    cols = index.tgt_col[qs]
    got = slack_from_dists(index.dist_t[:, torch.as_tensor(cols,
                                                           dtype=torch.long)],
                           ks, offs, index.INF)
    ref = j_slack(j_index.dist_t[:, cols], ks, offs, j_index.INF)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), np.asarray(ref))


# ----------------------------------------------------------------------
# similarity, clustering, detection
# ----------------------------------------------------------------------

def test_similarity_mu_exactly_equal(case):
    mu = similarity_matrix(case["index"])
    ref = j_similarity(case["j_index"], backend="interpret")
    assert mu.dtype == np.float64
    assert np.array_equal(mu, ref)


@pytest.mark.parametrize("gamma", [0.2, 0.5, 0.8])
def test_cluster_partitions_identical(case, gamma):
    mu = similarity_matrix(case["index"])
    ref_mu = j_similarity(case["j_index"], backend="interpret")
    assert cluster_queries(mu, gamma) == j_cluster(ref_mu, gamma)


def _hop_ok(index, cluster, forward):
    ds, dt = np.asarray(index.dist_s), np.asarray(index.dist_t)
    k_max = max(index.queries[qi][2] for qi in cluster)
    cols = (dt[:-1, index.tgt_col[cluster]] if forward
            else ds[:-1, index.src_col[cluster]])
    return cols.min(axis=1) <= k_max


def _plan_tuple(plan):
    return ([(n.nid, n.src, n.budget, n.query, n.in_edges, n.out_edges,
              n.consumers, n.signature) for n in plan.nodes],
            plan.topo, plan.half_of_query, plan.n_shared)


@pytest.mark.parametrize("min_sb", [0, 2])
def test_detect_plans_identical(case, min_sb):
    index, queries = case["index"], case["queries"]
    cluster = list(range(len(queries)))
    for reverse in (False, True):
        halves, ends = {}, {}
        for qi in cluster:
            s, t, k = queries[qi]
            a, b = midpoint_split(k)
            halves[qi] = (t, b) if reverse else (s, a)
            ends[qi] = (s, k) if reverse else (t, k)
        hop = _hop_ok(index, cluster, forward=not reverse)
        assert np.array_equal(
            hop, _hop_ok(case["j_index"], cluster, forward=not reverse))
        mine = detect_common_queries(case["g"], cluster, halves, hop,
                                     reverse=reverse, min_shared_budget=min_sb,
                                     endpoints=ends)
        ref = j_detect(case["jg"], cluster, halves, hop, reverse=reverse,
                       min_shared_budget=min_sb, endpoints=ends)
        assert _plan_tuple(mine) == _plan_tuple(ref)


# ----------------------------------------------------------------------
# walk-count DP (capacity planning and the "+" split)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("reverse", [False, True])
def test_walk_counts_ell_equal_reference(case, reverse):
    """Each query's dedicated slack, both directions, budget k: the port's
    ELL DP against the JAX ELL DP (interpret-mode Pallas) and the JAX
    segment DP. The counts stay far below 2**24 here, so the totals are
    exact whatever the order of summation."""
    index, dg, jdg, n = case["index"], case["dg"], case["jdg"], case["dg"].n
    m_valid = j_edge_span(jdg.m, 1 << 22, jdg.m_cap)
    for qi, (s, t, k) in enumerate(case["queries"][:4]):
        dist, col, root = ((index.dist_s, index.src_col[qi], t) if reverse
                           else (index.dist_t, index.tgt_col[qi], s))
        slack = slack_from_dists(dist[:, int(col)][:, None],
                                 np.array([k], np.int32),
                                 np.array([0], np.int32), index.INF)
        j_sl = jnp.asarray(slack.numpy())
        got = walk_counts_ell(dg.ell_idx if reverse else dg.r_ell_idx, root,
                              slack, n=n, budget=k)
        assert got.dtype == torch.float32 and got.shape == (k + 1,)
        ref_ell = j_walk_counts_ell(jdg.ell_idx if reverse else jdg.r_ell_idx,
                                    root, j_sl, n=n, budget=k,
                                    backend="interpret")
        esrc, edst = ((jdg.r_esrc, jdg.r_edst) if reverse
                      else (jdg.esrc, jdg.edst))
        ref_seg = j_walk_counts(esrc, edst, root, j_sl, n=n, budget=k,
                                m_valid=m_valid)
        assert np.array_equal(got.numpy(), np.asarray(ref_ell))
        assert np.array_equal(got.numpy(), np.asarray(ref_seg))
        assert float(got[0]) == 1.0 and float(got.max()) < 2 ** 24


def test_walk_counts_ell_counts_walks_on_a_path_graph():
    # 0 -> 1 -> 2 -> 3 with no pruning: one walk of each length
    g = Graph.from_edges(4, [0, 1, 2], [1, 2, 3])
    dg = DeviceGraph.build(g, CPU)
    slack = torch.full((5,), 9, dtype=torch.int8)
    slack[-1] = -1
    got = walk_counts_ell(dg.r_ell_idx, 0, slack, n=4, budget=4)
    assert got.tolist() == [1.0, 1.0, 1.0, 1.0, 0.0]
    slack[2] = 1                # vertex 2 survives only at depth <= 1
    got = walk_counts_ell(dg.r_ell_idx, 0, slack, n=4, budget=4)
    assert got.tolist() == [1.0, 1.0, 0.0, 0.0, 0.0]
