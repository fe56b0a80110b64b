"""The port's segment route and mesh-parallel index against the JAX package.

``EngineConfig.index_route="segment"`` is the counterpart of the
reference's ``kernel_backend="jnp"`` sweeps: the index, the walk-count DP
and the ``"msbfs"`` delta sweep as segmented reductions over
destination-sorted, sentinel-padded edge lists, chunked by
``edge_chunk``, and on a mesh over the executor's edge-sharded view.
Held to the JAX package, all with exact equality (distances are int8,
walk counts integer-valued float32 far below 2**24, paths integers):

* ``pad_edge_list``, ``edge_span`` and ``edge_bucket_for`` over grids;
* ``msbfs_dist``, ``msbfs_set_dist``, ``msbfs_hop`` and ``walk_counts``
  on padded and exact lists, ``edge_chunk`` in {2**6, 2**10, 2**22};
* the device lists of ``DeviceGraph.build`` and ``update_device_graph``
  (in place and on a rebuild, the bucket monotone);
* the port's 8-slot and 3-slot CPU sweeps against the JAX GSPMD sweeps
  over 8 forced host devices (a subprocess, as in
  ``tests/test_distributed.py``);
* the engine (``index_route="segment"``, ``edge_chunk=2**8``, one slot
  and ``mesh=[CPU] * 3``) against the JAX engine (``kernel_backend=
  "jnp"``, ``edge_chunk=2**8``) under every planner, and one delta under
  ``delta_backend="msbfs"``: its distance sweep, report and rerun.

Also: slices that hold only sentinels are inert, the executor's index
view is recut after deltas and graph swaps, and bad routes and lists
raise.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import generators as j_gen  # noqa: E402
from repro.core.delta import GraphDelta as JGraphDelta  # noqa: E402
from repro.core.delta import apply_delta as j_apply_delta  # noqa: E402
from repro.core.delta import update_device_graph as j_update  # noqa: E402
from repro.core.distributed import edge_bucket_for as j_bucket  # noqa: E402
from repro.core.engine import BatchPathEngine as JEngine  # noqa: E402
from repro.core.engine import EngineConfig as JConfig  # noqa: E402
from repro.core.graph import DeviceGraph as JDeviceGraph  # noqa: E402
from repro.core.graph import pad_edge_list as j_pad  # noqa: E402
from repro.core.index import build_index as j_build_index  # noqa: E402
from repro.core.index import walk_counts as j_walk_counts  # noqa: E402
from repro.core.msbfs import edge_span as j_edge_span  # noqa: E402
from repro.core.msbfs import msbfs_dist as j_msbfs_dist  # noqa: E402
from repro.core.msbfs import msbfs_hop as j_msbfs_hop  # noqa: E402
from repro.core.msbfs import msbfs_set_dist as j_msbfs_set_dist  # noqa: E402
from repro_torch.core import (BatchPathEngine, DeviceGraph,  # noqa: E402
                              EngineConfig, Graph, GraphDelta, build_index)
from repro_torch.core.delta import apply_delta, update_device_graph  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    distributed_graph, edge_bucket_for, shard_edges, shard_graph_edges)
from repro_torch.core.graph import EdgeSlices, pad_edge_list  # noqa: E402
from repro_torch.core.index import walk_counts  # noqa: E402
from repro_torch.core.msbfs import (edge_span, msbfs_dist,  # noqa: E402
                                    msbfs_hop, msbfs_set_dist,
                                    segment_sweep)

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
CHUNKS = (1 << 6, 1 << 10, 1 << 22)
PLANNERS = ("batch", "batch+", "basic", "basic+", "pathenum", "auto")


def _port_graph(jg) -> Graph:
    return Graph.from_arrays(jg.n, jg.indptr, jg.indices, jg.r_indptr,
                             jg.r_indices)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def graphs():
    """An Erdos graph of 400 vertices (about 1,600 edges, a 2,048-edge
    bucket), its JAX device graphs padded and exact and the port's."""
    jg = j_gen.erdos(400, 4.0, seed=2)
    g = _port_graph(jg)
    return dict(jg=jg, g=g, jdg=JDeviceGraph.build(jg),
                jdg_exact=JDeviceGraph.build(jg, pad=False),
                dg=DeviceGraph.build(g, CPU, edge_lists=True))


def _lists(graphs, padded: bool, reverse: bool = False):
    """(port esrc, port edst, JAX esrc, JAX edst, m_cap) of one direction."""
    jdg = graphs["jdg"] if padded else graphs["jdg_exact"]
    names = ("r_esrc", "r_edst") if reverse else ("esrc", "edst")
    je, jd = (getattr(jdg, f) for f in names)
    if padded:
        e, d = (getattr(graphs["dg"], f) for f in names)
    else:
        g = graphs["g"]
        e, d = (_t(x) for x in (g.r_edges_by_dst if reverse
                                else g.edges_by_dst))
    return e, d, je, jd, int(je.shape[0])


# ----------------------------------------------------------------------
# shapes and buckets
# ----------------------------------------------------------------------
@pytest.mark.parametrize("m,cap", [(0, 1), (5, 5), (5, 8), (13, 64),
                                   (1000, 1024)])
def test_pad_edge_list_matches_reference(m, cap):
    rng = np.random.default_rng(m + cap)
    n = 50
    dst = np.sort(rng.integers(0, n, m)).astype(np.int32)
    src = rng.integers(0, n, m).astype(np.int32)
    got = pad_edge_list(src, dst, n, cap)
    want = j_pad(src, dst, n, cap)
    for a, b in zip(got, want):
        assert a.dtype == np.int32 and np.array_equal(a, b)
    assert np.all(got[1][:-1] <= got[1][1:])          # still dst-sorted
    with pytest.raises(ValueError, match="smaller"):
        pad_edge_list(src, dst, n, m - 1) if m else \
            pad_edge_list(np.zeros(2, np.int32), np.zeros(2, np.int32),
                          n, 1)


@pytest.mark.parametrize("edge_chunk", [1, 3, 64, 1 << 22])
def test_edge_span_matches_reference(edge_chunk):
    for m_cap in (1, 7, 64, 100, 4096):
        for m_valid in sorted({0, 1, 5, 63, 64, 65, m_cap - 1, m_cap,
                               m_cap + 3}):
            if m_valid < 0:
                continue
            assert edge_span(m_valid, edge_chunk, m_cap) == \
                j_edge_span(m_valid, edge_chunk, m_cap)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 5, 7, 8])
def test_edge_bucket_for_matches_reference(n_dev):
    for m in (0, 1, 2, 3, 9, 100, 1023, 1024, 1025, 8_400_000):
        got = edge_bucket_for(m, n_dev)
        assert got == j_bucket(m, n_dev)
        assert got % n_dev == 0 and got >= m


def test_device_lists_match_reference(graphs):
    dg, jdg = graphs["dg"], graphs["jdg"]
    assert dg.m == jdg.m and dg.m_cap == jdg.m_cap == 2048
    for f in ("esrc", "edst", "r_esrc", "r_edst"):
        x = getattr(dg, f)
        assert x.dtype == torch.int32
        assert np.array_equal(x.numpy(), np.asarray(getattr(jdg, f))), f
    plain = DeviceGraph.build(graphs["g"], CPU)
    assert not plain.has_edge_lists and plain.m_cap == 0
    assert plain.esrc is None and plain.r_edst is None
    capped = DeviceGraph.build(graphs["g"], CPU, edge_lists=True,
                               edge_cap=3000)
    assert capped.m_cap == 3000
    assert np.array_equal(capped.edst.numpy(), np.asarray(
        JDeviceGraph.build(graphs["jg"], edge_cap=3000).edst))


# ----------------------------------------------------------------------
# the sweeps, one slot
# ----------------------------------------------------------------------
@pytest.mark.parametrize("padded", [True, False])
@pytest.mark.parametrize("edge_chunk", CHUNKS)
def test_msbfs_dist_matches_reference(graphs, padded, edge_chunk):
    g = graphs["g"]
    srcs = np.random.default_rng(edge_chunk).choice(g.n, 40, replace=False)
    srcs = np.concatenate([srcs, srcs[:3]]).astype(np.int32)   # repeats
    for reverse in (False, True):
        e, d, je, jd, m_cap = _lists(graphs, padded, reverse)
        m_valid = edge_span(g.m, edge_chunk, m_cap)
        got = msbfs_dist(e, d, _t(srcs), n=g.n, k_max=6,
                         edge_chunk=edge_chunk, m_valid=m_valid)
        want = j_msbfs_dist(je, jd, jnp.asarray(srcs), n=g.n, k_max=6,
                            edge_chunk=edge_chunk, m_valid=m_valid)
        assert got.dtype == torch.int8 and got.shape == (g.n + 1, 43)
        assert np.array_equal(got.numpy(), np.asarray(want))
        # the whole list (m_valid=None) sweeps the same distances
        assert torch.equal(got, msbfs_dist(e, d, _t(srcs), n=g.n, k_max=6,
                                           edge_chunk=edge_chunk))


@pytest.mark.parametrize("padded", [True, False])
@pytest.mark.parametrize("edge_chunk", CHUNKS)
def test_msbfs_set_dist_matches_reference(graphs, padded, edge_chunk):
    g = graphs["g"]
    rng = np.random.default_rng(7 + edge_chunk)
    mask = np.zeros(g.n + 1, np.int8)
    mask[rng.choice(g.n, 6, replace=False)] = 1
    for reverse in (False, True):
        e, d, je, jd, m_cap = _lists(graphs, padded, reverse)
        m_valid = edge_span(g.m, edge_chunk, m_cap)
        for k_max in (1, 4, 8):
            got = msbfs_set_dist(e, d, _t(mask), n=g.n, k_max=k_max,
                                 edge_chunk=edge_chunk, m_valid=m_valid)
            want = j_msbfs_set_dist(je, jd, jnp.asarray(mask), n=g.n,
                                    k_max=k_max, edge_chunk=edge_chunk,
                                    m_valid=m_valid)
            assert got.dtype == torch.int8 and got.shape == (g.n + 1,)
            assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("padded", [True, False])
@pytest.mark.parametrize("edge_chunk", CHUNKS)
def test_walk_counts_matches_reference(graphs, padded, edge_chunk):
    g = graphs["g"]
    rng = np.random.default_rng(11 + edge_chunk)
    for reverse in (False, True):
        e, d, je, jd, m_cap = _lists(graphs, padded, reverse)
        m_valid = edge_span(g.m, edge_chunk, m_cap)
        for source in rng.choice(g.n, 3, replace=False):
            slack = rng.integers(-1, 7, g.n + 1).astype(np.int8)
            slack[-1] = -1
            got = walk_counts(e, d, int(source), _t(slack), n=g.n, budget=6,
                              edge_chunk=edge_chunk, m_valid=m_valid)
            want = j_walk_counts(je, jd, int(source), jnp.asarray(slack),
                                 n=g.n, budget=6, edge_chunk=edge_chunk,
                                 m_valid=m_valid)
            assert got.dtype == torch.float32 and got.shape == (7,)
            assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("edge_chunk", CHUNKS)
def test_msbfs_hop_matches_reference(graphs, edge_chunk):
    g = graphs["g"]
    rng = np.random.default_rng(edge_chunk)
    frontier = (rng.random((g.n + 1, 33)) < 0.05).astype(np.int8)
    frontier[g.n] = 0
    e, d, je, jd, m_cap = _lists(graphs, True)
    m_valid = edge_span(g.m, edge_chunk, m_cap)
    got = msbfs_hop(_t(frontier), e, d, g.n, edge_chunk, m_valid)
    want = j_msbfs_hop(jnp.asarray(frontier), je, jd, g.n, edge_chunk,
                       m_valid)
    assert got.dtype == torch.int8 and not got[g.n].any()
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_sentinel_destinations_are_dropped():
    """A list of sentinels alone reduces to zeros, whatever row n of the
    values holds (the sentinel is dropped, not written to row n)."""
    n = 6
    values = torch.zeros(n + 1, 2, dtype=torch.float16)
    values[n] = 1                         # a non-neutral row n
    es = torch.full((8,), n, dtype=torch.int32)
    out = segment_sweep(values, es, es, n=n, edge_chunk=3, reduce="max")
    assert out.shape == (n, 2) and not out.any()
    es[:2] = torch.tensor([0, 1], dtype=torch.int32)
    ed = es.clone()
    ed[:2] = torch.tensor([4, 4], dtype=torch.int32)
    values[1, 0] = 1
    out = segment_sweep(values, es, ed, n=n, edge_chunk=3, reduce="sum")
    assert out[4].tolist() == [1.0, 0.0] and out.sum() == 1


def test_chunk_plans_are_kept_with_their_lists(graphs):
    """A DeviceGraph's sweeps keep their chunk plans on its lists'
    ``EdgeSlices`` (one plan per chunking, made once and reused); a
    replaced DeviceGraph (as a delta makes one) starts with none."""
    import dataclasses
    g, dg = graphs["g"], graphs["dg"]
    dg = dataclasses.replace(dg)                 # no plans from other tests
    queries = [(0, 1, 4), (2, 3, 5)]
    fwd, rev = dg.edge_list(False), dg.edge_list(True)
    assert dg.edge_list(False) is fwd and not fwd[1].plans
    first = build_index(dg, queries, edge_chunk=1 << 6, route="segment")
    plans = dict(fwd[1].plans)
    assert len(plans) == len(rev[1].plans) == 1
    again = build_index(dg, queries, edge_chunk=1 << 6, route="segment")
    assert torch.equal(first.dist_s, again.dist_s)
    assert fwd[1].plans.keys() == plans.keys() and all(
        fwd[1].plans[k] is plans[k] for k in plans)
    build_index(dg, queries, edge_chunk=1 << 10, route="segment")
    assert len(fwd[1].plans) == 2
    assert not dataclasses.replace(dg).edge_list(False)[1].plans
    view = shard_graph_edges(dg, [CPU] * 3)
    assert view.edge_list(False) == (view.esrc, view.edst)
    with pytest.raises(ValueError, match="edge_lists=True"):
        DeviceGraph.build(g, CPU).edge_list(False)


def test_bad_routes_and_lists_raise(graphs):
    g, dg = graphs["g"], graphs["dg"]
    values = torch.zeros(g.n + 1, dtype=torch.float32)
    with pytest.raises(ValueError, match="reduce"):
        segment_sweep(values, dg.esrc, dg.edst, n=g.n, reduce="min")
    with pytest.raises(ValueError, match="edge_chunk"):
        segment_sweep(values, dg.esrc, dg.edst, n=g.n, edge_chunk=0)
    es, ed = shard_edges(dg.esrc, dg.edst, [CPU] * 2, n=g.n)
    with pytest.raises(TypeError, match="both"):
        segment_sweep(values, dg.esrc, ed, n=g.n)
    es3, _ = shard_edges(dg.esrc, dg.edst, [CPU] * 3, n=g.n)
    with pytest.raises(ValueError, match="same slices"):
        segment_sweep(values, es3, ed, n=g.n)
    with pytest.raises(ValueError, match="index route"):
        build_index(dg, [(0, 1, 3)], route="jnp")
    with pytest.raises(ValueError, match="edge_lists=True"):
        build_index(DeviceGraph.build(g, CPU), [(0, 1, 3)], route="segment")
    with pytest.raises(ValueError, match="edge_lists=True"):
        shard_graph_edges(DeviceGraph.build(g, CPU), [CPU] * 2)
    with pytest.raises(ValueError, match="index_route"):
        BatchPathEngine(g, EngineConfig(index_route="jnp"), device=CPU)
    with pytest.raises(ValueError, match="edge_chunk"):
        BatchPathEngine(g, EngineConfig(edge_chunk=0), device=CPU)


# ----------------------------------------------------------------------
# the sharded sweeps against the JAX GSPMD sweeps on 8 host devices
# ----------------------------------------------------------------------
JAX_GSPMD = """
import json, sys
import numpy as np
sys.path.insert(0, "src")
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core import generators
from repro.core.distributed import distributed_graph
from repro.core.index import walk_counts
from repro.core.msbfs import edge_span, msbfs_dist, msbfs_set_dist

assert len(jax.devices()) == 8
g = generators.erdos(400, 4.0, seed=2)
mesh = Mesh(np.array(jax.devices()), ("cells",))
dg = distributed_graph(g, mesh)
srcs = jnp.asarray(np.arange(0, 400, 9, dtype=np.int32))
mask = np.zeros(g.n + 1, np.int8)
mask[[3, 99, 250]] = 1
slack = np.full(g.n + 1, 5, np.int8)
slack[::7] = 2
slack[-1] = -1
out = {"m_cap": int(dg.esrc.shape[0]),
       "n_shards": len(dg.esrc.addressable_shards)}
for ch in CHUNKS:
    mv = edge_span(dg.m, ch, int(dg.esrc.shape[0]))
    out[str(ch)] = {
        "dist_s": np.asarray(msbfs_dist(dg.esrc, dg.edst, srcs, n=g.n,
                                        k_max=6, edge_chunk=ch,
                                        m_valid=mv)).tolist(),
        "dist_t": np.asarray(msbfs_dist(dg.r_esrc, dg.r_edst, srcs, n=g.n,
                                        k_max=6, edge_chunk=ch,
                                        m_valid=mv)).tolist(),
        "set": np.asarray(msbfs_set_dist(dg.esrc, dg.edst,
                                         jnp.asarray(mask), n=g.n, k_max=5,
                                         edge_chunk=ch,
                                         m_valid=mv)).tolist(),
        "walks": np.asarray(walk_counts(dg.r_esrc, dg.r_edst, 17,
                                        jnp.asarray(slack), n=g.n, budget=5,
                                        edge_chunk=ch,
                                        m_valid=mv)).tolist()}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def gspmd():
    code = "CHUNKS = %r\n" % (CHUNKS,) + textwrap.dedent(JAX_GSPMD)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=600, cwd=str(ROOT),
        env={"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
             "JAX_PLATFORMS": "cpu", "PYTHONPATH": "src",
             "PATH": "/usr/bin:/bin:/usr/local/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(next(ln for ln in out.stdout.splitlines()
                           if ln.startswith("RESULT "))[len("RESULT "):])


@pytest.mark.parametrize("slots", [8, 3])
@pytest.mark.parametrize("edge_chunk", CHUNKS)
def test_sharded_sweeps_match_gspmd(graphs, gspmd, slots, edge_chunk):
    g = graphs["g"]
    assert gspmd["n_shards"] == 8
    dg = distributed_graph(g, [CPU] * slots)
    assert dg.m_cap == edge_bucket_for(g.m, slots)
    if slots == 8:
        assert dg.m_cap == gspmd["m_cap"]
    assert isinstance(dg.esrc, EdgeSlices) and len(dg.esrc.slices) == slots
    assert len({int(x.shape[0]) for x in dg.r_edst.slices}) == 1
    ref = gspmd[str(edge_chunk)]
    m_valid = edge_span(g.m, edge_chunk, dg.m_cap)
    kw = dict(n=g.n, edge_chunk=edge_chunk, m_valid=m_valid)
    srcs = _t(np.arange(0, 400, 9, dtype=np.int32))
    mask = np.zeros(g.n + 1, np.int8)
    mask[[3, 99, 250]] = 1
    slack = np.full(g.n + 1, 5, np.int8)
    slack[::7] = 2
    slack[-1] = -1
    assert msbfs_dist(dg.esrc, dg.edst, srcs, k_max=6, **kw).tolist() \
        == ref["dist_s"]
    assert msbfs_dist(dg.r_esrc, dg.r_edst, srcs, k_max=6, **kw).tolist() \
        == ref["dist_t"]
    assert msbfs_set_dist(dg.esrc, dg.edst, _t(mask), k_max=5,
                          **kw).tolist() == ref["set"]
    assert walk_counts(dg.r_esrc, dg.r_edst, 17, _t(slack), budget=5,
                       **kw).tolist() == ref["walks"]


@pytest.mark.parametrize("slots", [3, 5])
def test_sentinel_only_slices_are_inert(slots):
    """More slots than the valid edges fill: the trailing slices hold only
    sentinels (or lie past the chunk-rounded span) and change nothing."""
    jg = j_gen.erdos(40, 1.5, seed=4)
    g = _port_graph(jg)
    one = DeviceGraph.build(g, CPU, edge_lists=True, edge_cap=4 * g.m)
    many = shard_graph_edges(one, [CPU] * slots)
    tail = many.esrc.slices[-1]
    assert bool((tail == g.n).all()), "the last slice holds real edges"
    srcs = _t(np.arange(0, 40, 3, dtype=np.int32))
    for chunk in (4, 1 << 22):
        for m_valid in (None, edge_span(g.m, chunk, one.m_cap)):
            kw = dict(n=g.n, k_max=5, edge_chunk=chunk, m_valid=m_valid)
            assert torch.equal(msbfs_dist(many.esrc, many.edst, srcs, **kw),
                               msbfs_dist(one.esrc, one.edst, srcs, **kw))


# ----------------------------------------------------------------------
# the engine against the JAX engine
# ----------------------------------------------------------------------
def _rows(report) -> list:
    return [sorted(map(tuple, np.asarray(r.paths).tolist()))
            for r in report.results]


@pytest.fixture(scope="module")
def engine_ref():
    """A 600-vertex community graph, 12 queries (k 3-5) and the JAX
    engine's results on them under every planner (its segment arm,
    ``edge_chunk=2**8``: about 3,600 edges, fifteen chunks)."""
    jg = j_gen.community(600, n_comm=6, avg_deg=6.0, seed=5)
    qs = j_gen.random_queries(jg, 12, k_range=(3, 5), seed=6)
    j_eng = JEngine(jg, JConfig(kernel_backend="jnp", edge_chunk=1 << 8))
    return dict(jg=jg, g=_port_graph(jg), qs=qs,
                rows={p: _rows(j_eng.run(qs, planner=p)) for p in PLANNERS})


@pytest.mark.parametrize("planner", PLANNERS)
@pytest.mark.parametrize("mesh", [None, [CPU] * 3])
def test_engine_matches_reference(engine_ref, planner, mesh):
    eng = BatchPathEngine(engine_ref["g"], EngineConfig(
        index_route="segment", edge_chunk=1 << 8, mesh=mesh), device=CPU)
    assert eng.dg.has_edge_lists
    view = eng.executor.index_dg
    assert isinstance(view.esrc, EdgeSlices) == (mesh is not None)
    rep = eng.run(engine_ref["qs"], planner=planner)
    assert _rows(rep) == engine_ref["rows"][planner]


def test_index_matches_reference(engine_ref):
    """The segment engine's index over three slots: the JAX segment
    index's distances bit for bit."""
    qs = engine_ref["qs"]
    j_index = j_build_index(JDeviceGraph.build(engine_ref["jg"]), qs,
                            edge_chunk=1 << 8, backend="jnp")
    eng = BatchPathEngine(engine_ref["g"], EngineConfig(
        index_route="segment", edge_chunk=1 << 8, mesh=[CPU] * 3),
        device=CPU)
    index = eng._build_index(qs)
    assert np.array_equal(index.dist_s.numpy(), np.asarray(j_index.dist_s))
    assert np.array_equal(index.dist_t.numpy(), np.asarray(j_index.dist_t))


def _delta(g, seed: int):
    """Three absent insertions and two deletions of existing edges."""
    rng = np.random.default_rng(seed)
    src, dst = g.edges_by_dst
    dels = [(int(src[i]), int(dst[i]))
            for i in rng.choice(g.m, 2, replace=False)]
    have = set(zip(src.tolist(), dst.tolist()))
    adds = []
    while len(adds) < 3:
        u, v = (int(x) for x in rng.integers(0, g.n, 2))
        if u != v and (u, v) not in have:
            adds.append((u, v))
            have.add((u, v))
    return adds, dels


REPORT_KEYS = ("n_added", "n_removed", "n_touched", "cache_mode",
               "device_update", "cache_evicted", "cache_kept")


@pytest.mark.parametrize("mesh", [None, [CPU] * 3])
def test_engine_delta_matches_reference(engine_ref, mesh):
    """One delta under ``delta_backend="msbfs"``: the segment sweep's
    distances equal the JAX segment sweep's; on one slot the report
    equals the JAX engine's, on three the ELL engine's on three; the
    rerun's paths equal the JAX engine's."""
    jg, g, qs = engine_ref["jg"], engine_ref["g"], engine_ref["qs"]
    adds, dels = _delta(g, 8)
    common = dict(cache_bytes=64 << 20, delta_backend="msbfs",
                  edge_chunk=1 << 8)
    j_eng = JEngine(jg, JConfig(kernel_backend="jnp", **common))
    eng = BatchPathEngine(g, EngineConfig(index_route="segment", mesh=mesh,
                                          **common), device=CPU)
    ell = BatchPathEngine(g, EngineConfig(mesh=mesh, **common), device=CPU)
    for e in (j_eng, eng, ell):
        e.run(qs)
    # the distance sweep on the old lists, before any table changes
    applied = apply_delta(g, GraphDelta.from_pairs(add=adds, remove=dels))
    j_applied = j_apply_delta(jg, JGraphDelta.from_pairs(add=adds,
                                                         remove=dels))
    got = eng._delta_dists(applied, 5)
    want = j_eng._delta_dists(j_applied, 5)
    for name in ("from", "to"):
        assert got[name].dtype == np.int8
        assert np.array_equal(got[name], np.asarray(want[name])), name
    delta = GraphDelta.from_pairs(add=adds, remove=dels)
    rep = eng.apply_delta(delta)
    j_rep = j_eng.apply_delta(JGraphDelta.from_pairs(add=adds, remove=dels))
    ref = j_rep if mesh is None else ell.apply_delta(delta)
    assert {k: rep[k] for k in REPORT_KEYS} == {k: ref[k]
                                                for k in REPORT_KEYS}
    assert rep["cache_mode"] == "delta" and rep["cache_evicted"] > 0
    if mesh is not None:
        assert rep["cache_epochs"] == ref["cache_epochs"]
    assert _rows(eng.run(qs)) == _rows(j_eng.run(qs))


def test_index_view_is_recut_after_deltas_and_swaps(engine_ref):
    g = engine_ref["g"]
    eng = BatchPathEngine(g, EngineConfig(index_route="segment",
                                          mesh=[CPU] * 3), device=CPU)
    ex = eng.executor
    assert ex.shards_index
    first = ex.index_dg
    assert first.m_cap == eng.dg.m_cap == edge_bucket_for(g.m, 3)
    assert [x.data_ptr() for x in first.esrc.slices] == [
        eng.dg.esrc[j * (first.m_cap // 3):].data_ptr() for j in range(3)]
    adds, dels = _delta(g, 9)
    eng.apply_delta(GraphDelta.from_pairs(add=adds, remove=dels))
    second = ex.index_dg
    assert second is not first and second.m == eng.dg.m == g.m + 1
    assert torch.equal(torch.cat(second.edst.slices), eng.dg.edst)
    eng.set_graph(g)
    third = ex.index_dg
    assert third is not second and third.m == g.m
    assert torch.equal(torch.cat(third.esrc.slices), eng.dg.esrc)
    # the ELL route and one slot sweep the engine's own tables
    for cfg in (EngineConfig(mesh=[CPU] * 3),
                EngineConfig(index_route="segment", mesh=[CPU])):
        e = BatchPathEngine(g, cfg, device=CPU)
        assert not e.executor.shards_index and e.executor.index_dg is e.dg


# ----------------------------------------------------------------------
# the lists through graph deltas
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", ["in_place", "grows_bucket", "rebuild"])
def test_update_device_graph_lists_match_reference(case):
    jg = j_gen.erdos(60, 2.0, seed=12)
    g = _port_graph(jg)
    dg = DeviceGraph.build(g, CPU, edge_lists=True)
    jdg = JDeviceGraph.build(jg)
    src, dst = g.edges_by_dst
    if case == "in_place":
        pairs = dict(add=[(0, 59), (59, 1)],
                     remove=[(int(src[0]), int(dst[0]))])
    elif case == "grows_bucket":
        # one new out-edge and in-edge a vertex, on rows below the caps
        have = set(zip(src.tolist(), dst.tolist()))
        need = dg.m_cap - g.m + 1
        add = [(u, (7 * u + 3) % 60) for u in range(60)
               if u != (7 * u + 3) % 60 and (u, (7 * u + 3) % 60) not in have
               and g.out_degree()[u] < dg.ell_cap
               and g.in_degree()[(7 * u + 3) % 60] < dg.r_ell_cap][:need]
        assert len(add) == need
        pairs = dict(add=add)
    else:                       # an in-degree past the ELL cap
        pairs = dict(add=[(u, 0) for u in range(1, 60)
                          if (u, 0) not in set(zip(src.tolist(),
                                                   dst.tolist()))])
    dg2, inc = update_device_graph(dg, apply_delta(
        g, GraphDelta.from_pairs(**pairs)))
    jdg2, j_inc = j_update(jdg, j_apply_delta(
        jg, JGraphDelta.from_pairs(**pairs)))
    assert inc == j_inc == (case != "rebuild")
    assert dg2.m == jdg2.m and dg2.m_cap == jdg2.m_cap >= dg.m_cap
    if case == "grows_bucket":
        assert dg2.m_cap > dg.m_cap
    for f in ("esrc", "edst", "r_esrc", "r_edst"):
        assert np.array_equal(getattr(dg2, f).numpy(),
                              np.asarray(getattr(jdg2, f))), f
    assert dg.m_cap == int(dg.esrc.shape[0]) == jdg.m_cap   # old kept
    plain, _ = update_device_graph(DeviceGraph.build(g, CPU), apply_delta(
        g, GraphDelta.from_pairs(**pairs)))
    assert not plain.has_edge_lists
