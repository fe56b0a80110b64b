"""The similarity stage's Γ packing and intersections against the JAX
package, on the CPU.

``gamma_intersections`` (the stage's entry: ``gamma_pack`` then
``pairwise_popcount`` on the card, the plain composition on the CPU) is
held to the JAX package's ``gamma_matrix`` + ``intersection_matrix``, and
the port's ``similarity_matrix``, which takes the Γ sizes from the
diagonal of the intersections, to the JAX ``similarity_matrix``. Every
value compared is an integer or float64 computed from integers, so the
tolerance is exact equality. The indexes are built from the same graphs
and queries (made from seeds) by both packages: random batches, batches
whose queries share sources and targets (fewer distance columns than
queries), hop budgets of 0, and graphs whose vertex count is not a
multiple of 32.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import generators as j_gen  # noqa: E402
from repro.core.graph import DeviceGraph as JDeviceGraph  # noqa: E402
from repro.core.index import build_index as j_build_index  # noqa: E402
from repro.core.similarity import gamma_matrix as j_gamma  # noqa: E402
from repro.core.similarity import (  # noqa: E402
    intersection_matrix as j_inter, similarity_matrix as j_similarity)
from repro.kernels.msbfs_expand.ref import (  # noqa: E402
    pack_bits as j_pack_bits)
from repro_torch.core.graph import DeviceGraph, Graph  # noqa: E402
from repro_torch.core.index import build_index  # noqa: E402
from repro_torch.core.similarity import (gamma_inputs,  # noqa: E402
                                         similarity_matrix)
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.pairwise_popcount import ops as pops  # noqa: E402

CPU = torch.device("cpu")


def _carry(jg):
    return Graph.from_arrays(jg.n, jg.indptr, jg.indices, jg.r_indptr,
                             jg.r_indices)


def _shared_endpoints(jg, n_queries, seed):
    """Queries drawn from 3 sources and 4 targets, k in 0..4."""
    r = np.random.default_rng(seed)
    srcs = r.choice(jg.n, 3, replace=False)
    tgts = r.choice(jg.n, 4, replace=False)
    return [(int(r.choice(srcs)), int(r.choice(tgts)), int(r.integers(0, 5)))
            for _ in range(n_queries)]


# (graph, queries): n of 601, 400 and 250 vertices (none a multiple of 32)
CASES = {
    "community-random": (
        lambda: j_gen.community(601, n_comm=5, avg_deg=5.0, seed=0),
        lambda jg: j_gen.random_queries(jg, 12, k_range=(3, 5), seed=3)),
    "powerlaw-random": (
        lambda: j_gen.powerlaw(400, avg_deg=4.0, seed=1),
        lambda jg: j_gen.random_queries(jg, 40, k_range=(1, 4), seed=5)),
    "community-shared": (
        lambda: j_gen.community(250, n_comm=3, avg_deg=4.0, seed=2),
        lambda jg: _shared_endpoints(jg, 20, seed=7)),
    "powerlaw-k0": (
        lambda: j_gen.powerlaw(333, avg_deg=3.0, seed=4),
        lambda jg: [(q[0], q[1], 0) for q in
                    j_gen.random_queries(jg, 9, k_range=(1, 3), seed=8)]
        + [(5, 6, 2)]),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    make_graph, make_queries = CASES[request.param]
    jg = make_graph()
    queries = make_queries(jg)
    j_index = j_build_index(JDeviceGraph.build(jg), queries,
                            backend="interpret")
    index = build_index(DeviceGraph.build(_carry(jg), CPU), queries)
    return dict(name=request.param, index=index, j_index=j_index)


def test_cases_cover_shared_columns_and_zero_budgets(case):
    index = case["index"]
    if case["name"] == "community-shared":
        assert index.dist_s.shape[1] < len(index.queries)
        assert index.dist_t.shape[1] < len(index.queries)
    if case["name"] == "powerlaw-k0":
        assert sum(q[2] == 0 for q in index.queries) == 9
    assert (index.dist_s.shape[0] - 1) % 32


@pytest.mark.parametrize("reverse", [False, True])
def test_gamma_intersections_equal_jax(case, reverse):
    index, j_index = case["index"], case["j_index"]
    dist, col, ks = gamma_inputs(index, reverse)
    n = dist.shape[0] - 1
    got = pops.gamma_intersections(dist, col, ks, n)
    ref = np.asarray(j_inter(j_gamma(j_index, reverse=reverse)))
    assert got.dtype == torch.int32 and got.shape == (len(index.queries),) * 2
    assert np.array_equal(got.numpy(), ref)
    # the diagonal is |Γ|
    sizes = np.asarray(j_gamma(j_index, reverse=reverse)).sum(1)
    assert np.array_equal(np.diagonal(got.numpy()), sizes)


@pytest.mark.parametrize("reverse", [False, True])
def test_gamma_pack_ref_equals_jax_packing(case, reverse):
    index, j_index = case["index"], case["j_index"]
    dist, col, ks = gamma_inputs(index, reverse)
    n = dist.shape[0] - 1
    got = pops.gamma_pack_ref(dist, col, ks, n)
    ref = np.asarray(j_pack_bits(j_gamma(j_index, reverse=reverse)))
    assert got.shape == (len(index.queries), -(-n // 32))
    assert np.array_equal(got.numpy().view(np.uint32), ref)
    # the tail bits past n are zero
    assert not (got.numpy().view(np.uint32)[:, -1] >> (n % 32)).any()
    assert np.array_equal(pops.gamma_bits(dist, col, ks, n).numpy(),
                          np.asarray(j_gamma(j_index, reverse=reverse)))


def test_similarity_matrix_equals_jax_exactly(case):
    mu = similarity_matrix(case["index"])
    ref = j_similarity(case["j_index"], backend="interpret")
    assert mu.dtype == np.float64
    assert np.array_equal(mu, ref)
    ref_jnp = j_similarity(case["j_index"], backend="jnp")
    assert np.array_equal(mu, ref_jnp)


def _handmade(n=70, Su=5, Q=11, seed=0):
    """Random distances with INF entries, columns shared by several
    queries (Su < Q) and budgets from 0 to 6."""
    r = np.random.default_rng(seed)
    dist = r.integers(0, 8, size=(n + 1, Su)).astype(np.int8)
    dist[r.random((n + 1, Su)) < 0.3] = 7                  # INF = 7
    dist[n] = 7
    col = r.integers(0, Su, Q).astype(np.int32)
    ks = r.integers(0, 7, Q).astype(np.int8)
    ks[:2] = 0
    return (torch.from_numpy(dist), torch.from_numpy(col),
            torch.from_numpy(ks))


@pytest.mark.parametrize("n,Su,Q", [(70, 5, 11), (31, 1, 4), (32, 3, 3),
                                    (1, 2, 2), (257, 9, 40)])
def test_gamma_pack_ref_packs_the_compared_distances(n, Su, Q):
    dist, col, ks = _handmade(n, Su, Q, seed=n + Su)
    got = pops.gamma_pack_ref(dist, col, ks, n)
    bits = (dist.numpy()[:n, col.numpy()] <= ks.numpy()[None, :]).T
    ref = np.asarray(j_pack_bits(jnp.asarray(bits)))
    assert np.array_equal(got.numpy().view(np.uint32), ref)
    inter = pops.gamma_intersections(dist, col, ks, n)
    assert np.array_equal(np.diagonal(inter.numpy()), bits.sum(1))
    assert torch.equal(inter, inter.T)


def test_gamma_intersections_takes_the_plain_version_on_cpu(monkeypatch):
    dist, col, ks = _handmade()

    def refuse(*a, **kw):
        raise AssertionError("a CUDA wrapper was called on a CPU tensor")

    monkeypatch.setattr(pops, "gamma_pack_cuda", refuse)
    monkeypatch.setattr(pops, "pairwise_popcount_cuda", refuse)
    before = dict(LAUNCHES)
    got = pops.gamma_intersections(dist, col, ks, 70)
    assert torch.equal(got, pops.gamma_intersections(dist, col, ks, 70,
                                                     arm="torch"))
    assert LAUNCHES == before


def test_gamma_intersections_cuda_arm_on_cpu_tensor_raises():
    dist, col, ks = _handmade()
    with pytest.raises(ValueError, match="cannot run on"):
        pops.gamma_intersections(dist, col, ks, 70, arm="cuda")


def test_gamma_pack_cuda_refuses_cpu_tensors():
    dist, col, ks = _handmade()
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pops.gamma_pack_cuda(dist, col, ks, 70)
    with pytest.raises(TypeError):
        pops.gamma_pack_cuda(dist.to(torch.int32), col, ks, 70)
    assert LAUNCHES == before
