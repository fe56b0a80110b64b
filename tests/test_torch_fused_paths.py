"""The plain versions of the fused expand level and joins against the JAX
package, the arm each call takes, and the packed count/overflow readback.

On the card ``expand_level`` and the keyed, counting and splice joins each
run as one fused kernel (``csrc/path_join.cu``); their plain versions
(``expand_level_ref``, ``keyed_join_ref``, ``keyed_join_count_ref``,
``cross_join_ref``) are the eager PyTorch compositions that the CPU runs
and that the card tests hold the kernels to, bit for bit. Here the plain
versions meet the JAX functions on the same numpy inputs (JAX's
``path_member`` / ``rowwise_overlap`` in Pallas interpret mode): every
output equal, rows in order, the rows at and past ``count`` included.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.enumerate import expand_level as j_expand_level  # noqa: E402
from repro.core.join import cross_join as j_cross_join  # noqa: E402
from repro.core.join import keyed_join as j_keyed_join  # noqa: E402
from repro.core.join import keyed_join_count as j_keyed_join_count  # noqa: E402
from repro.core.join import sort_by_last as j_sort_by_last  # noqa: E402
from repro_torch.core import engine as engine_mod  # noqa: E402
from repro_torch.core import enumerate as enum  # noqa: E402
from repro_torch.core import join  # noqa: E402
from repro_torch.core.enumerate import prune_table  # noqa: E402
from repro_torch.core.pathset import read_status  # noqa: E402
from repro_torch.kernels import LAUNCHES, ROUTE_COUNTS  # noqa: E402
from repro_torch.kernels.path_join import ops as jops  # noqa: E402


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _same(mine, ref):
    return np.array_equal(np.asarray(mine), np.asarray(ref))


def _simple_rows(r, N, L, hi):
    rows = [r.choice(hi, size=L, replace=False) for _ in range(N)]
    return np.array(rows, np.int32).reshape(N, L)


# ----------------------------------------------------------------------
# the fused expand level's plain version
# ----------------------------------------------------------------------

def _level_inputs(seed, n, D, cap, count, level, budget, pad_frac,
                  splice_frac, junk_tail):
    r = np.random.default_rng(seed)
    ell = r.integers(0, n, (n, D)).astype(np.int32)
    ell[r.random((n, D)) < pad_frac] = n
    verts = np.full((cap, budget + 1), -1, np.int32)
    verts[:count, :level + 1] = _simple_rows(r, count, level + 1, n)
    if junk_tail:           # rows past count need not be -1
        verts[count:, :level + 1] = r.integers(-1, n, (cap - count,
                                                       level + 1))
    remaining = budget - (level + 1)
    slack = r.integers(-1, budget + 1, n + 1).astype(np.int8)
    splice = np.where(r.random(n + 1) < splice_frac,
                      r.integers(remaining, remaining + 2, n + 1),
                      -1).astype(np.int8)
    slack[-1] = splice[-1] = -1
    return ell, verts, slack, splice


# (seed, n, D, cap, count, level, budget, out_cap, stop, pad_frac,
#  splice_frac, junk_tail): D 32 and 64, count < cap, an out_cap that
# overflows, stop_vertex set and -2, splice budgets, an empty frontier,
# the first level of a node
LEVEL_CASES = [
    (0, 300, 32, 64, 50, 2, 5, 4096, -2, 0.4, 0.0, False),
    (1, 300, 32, 64, 50, 2, 5, 40, -2, 0.4, 0.0, False),
    (2, 200, 64, 32, 31, 3, 6, 2048, "row", 0.5, 0.2, True),
    (3, 200, 64, 32, 20, 1, 4, 100, "row", 0.2, 0.3, False),
    (4, 120, 32, 16, 0, 2, 5, 256, -2, 0.3, 0.1, True),
    (5, 90, 32, 1, 1, 0, 3, 64, -2, 0.3, 0.1, False),
    (6, 500, 64, 128, 128, 4, 6, 8, 7, -0.1, 0.05, False),
]


@pytest.mark.parametrize("case", LEVEL_CASES)
def test_expand_level_ref_matches_jax(case):
    (seed, n, D, cap, count, level, budget, out_cap, stop, pad_frac,
     splice_frac, junk) = case
    ell, verts, slack, splice = _level_inputs(seed, n, D, cap, count, level,
                                              budget, pad_frac, splice_frac,
                                              junk)
    if stop == "row":       # a vertex that ends one of the valid rows
        stop = int(verts[count // 2, level])
    mine = enum.expand_level_ref(_t(verts), torch.tensor(count), _t(ell),
                                 prune_table(_t(slack), _t(splice)), stop,
                                 level=level, budget=budget, out_cap=out_cap)
    ref = j_expand_level(jnp.asarray(verts), jnp.int32(count),
                         jnp.asarray(ell),
                         jnp.stack([jnp.asarray(slack), jnp.asarray(splice)],
                                   axis=1),
                         jnp.int32(stop), level=level, budget=budget,
                         out_cap=out_cap, backend="interpret")
    assert _same(mine.frontier.verts, ref.frontier.verts)
    assert mine.frontier.count.dtype == torch.int64
    assert int(mine.frontier.count) == int(ref.frontier.count)
    assert bool(mine.frontier.overflow) == bool(ref.frontier.overflow)
    assert _same(mine.nbrs, ref.nbrs)
    assert _same(mine.splice_hit, ref.splice_hit)
    # the rows at and past count: ELL row 0, no splice, -1 past n_out
    assert _same(mine.nbrs[count:], np.broadcast_to(ell[0], (cap - count, D)))
    assert not bool(mine.splice_hit[count:].any())
    assert bool((mine.frontier.verts[int(mine.frontier.count):] == -1).all())


def test_expand_level_cases_overflow_and_splice():
    """The cases above do reach an overflow and a splice hit."""
    seen = {"overflow": False, "splice": False}
    for case in LEVEL_CASES:
        (seed, n, D, cap, count, level, budget, out_cap, stop, pad_frac,
         splice_frac, junk) = case
        ell, verts, slack, splice = _level_inputs(
            seed, n, D, cap, count, level, budget, pad_frac, splice_frac,
            junk)
        got = enum.expand_level_ref(
            _t(verts), torch.tensor(count), _t(ell),
            prune_table(_t(slack), _t(splice)),
            -2 if stop == "row" else stop, level=level, budget=budget,
            out_cap=out_cap)
        seen["overflow"] |= bool(got.frontier.overflow)
        seen["splice"] |= bool(got.splice_hit.any())
    assert seen == {"overflow": True, "splice": True}


# ----------------------------------------------------------------------
# the fused joins' plain versions
# ----------------------------------------------------------------------

@pytest.mark.parametrize("NA,NB,a_col,b_col,a_count,b_count,cap,seed", [
    (64, 48, 3, 2, 60, 40, 1024, 0), (64, 48, 3, 2, 60, 40, 32, 1),
    (20, 200, 1, 4, 20, 150, 512, 2), (9, 9, 2, 2, 0, 9, 16, 3),
    (40, 30, 2, 3, 33, 0, 64, 4)])
def test_keyed_joins_ref_match_jax(NA, NB, a_col, b_col, a_count, b_count,
                                   cap, seed):
    r = np.random.default_rng(seed)
    A = _simple_rows(r, NA, a_col + 1, 10)          # few keys: big buckets
    B = _simple_rows(r, NB, b_col + 1, 10)
    width = a_col + b_col + 1
    sa = join.sort_by_last(_t(A), torch.tensor(a_count), col=a_col)
    j_sa = j_sort_by_last(jnp.asarray(A), jnp.int32(a_count), col=a_col)
    mine = join.keyed_join_ref(sa, _t(B), torch.tensor(b_count), a_col=a_col,
                               b_col=b_col, out_cap=cap, out_width=width)
    ref = j_keyed_join(j_sa, jnp.asarray(B), jnp.int32(b_count), a_col=a_col,
                       b_col=b_col, out_cap=cap, out_width=width,
                       backend="interpret")
    assert _same(mine.verts, ref.verts)
    assert int(mine.count) == int(ref.count)
    assert bool(mine.overflow) == bool(ref.overflow)
    n, ovf = join.keyed_join_count_ref(sa, _t(B), torch.tensor(b_count),
                                       a_col=a_col, b_col=b_col, pair_cap=cap)
    j_n, j_ovf = j_keyed_join_count(j_sa, jnp.asarray(B), jnp.int32(b_count),
                                    a_col=a_col, b_col=b_col, pair_cap=cap,
                                    backend="interpret")
    assert n.dtype == torch.int64
    assert int(n) == int(j_n) and bool(ovf) == bool(j_ovf)


@pytest.mark.parametrize("NP,NC,p_col,c_col,p_count,c_count,cap,seed", [
    (40, 30, 2, 3, 35, 30, 2048, 0), (40, 30, 2, 3, 35, 30, 100, 1),
    (16, 16, 0, 4, 16, 0, 64, 2), (7, 50, 3, 1, 7, 44, 512, 3)])
def test_cross_join_ref_matches_jax(NP, NC, p_col, c_col, p_count, c_count,
                                    cap, seed):
    r = np.random.default_rng(seed)
    P = _simple_rows(r, NP, p_col + 1, 15)
    C = _simple_rows(r, NC, c_col + 1, 15)
    width = p_col + c_col + 3                        # one spare column
    mine = join.cross_join_ref(_t(P), torch.tensor(p_count), _t(C),
                               torch.tensor(c_count), p_col=p_col,
                               c_col=c_col, out_cap=cap, out_width=width)
    ref = j_cross_join(jnp.asarray(P), jnp.int32(p_count), jnp.asarray(C),
                       jnp.int32(c_count), p_col=p_col, c_col=c_col,
                       out_cap=cap, out_width=width, backend="interpret")
    assert _same(mine.verts, ref.verts)
    assert int(mine.count) == int(ref.count)
    assert bool(mine.overflow) == bool(ref.overflow)


# ----------------------------------------------------------------------
# the arm of each call
# ----------------------------------------------------------------------

def _level_args():
    ell, verts, slack, splice = _level_inputs(0, 300, 32, 64, 50, 2, 5,
                                              0.4, 0.1, False)
    return ((_t(verts), torch.tensor(50), _t(ell),
             prune_table(_t(slack), _t(splice)), -2),
            dict(level=2, budget=5, out_cap=256))


def _join_args():
    r = np.random.default_rng(9)
    A, B = _simple_rows(r, 30, 3, 10), _simple_rows(r, 20, 3, 10)
    sa = join.sort_by_last(_t(A), torch.tensor(30), col=2)
    keyed = ((sa, _t(B), torch.tensor(20)),
             dict(a_col=2, b_col=2, out_cap=256, out_width=5))
    count = ((sa, _t(B), torch.tensor(20)),
             dict(a_col=2, b_col=2, pair_cap=256))
    splice = ((_t(A), torch.tensor(30), _t(B), torch.tensor(20)),
              dict(p_col=2, c_col=2, out_cap=1024, out_width=6))
    return {"keyed": (join.keyed_join, join.keyed_join_ref,
                      join.keyed_join_cuda, keyed),
            "keyed_count": (join.keyed_join_count, join.keyed_join_count_ref,
                            join.keyed_join_count_cuda, count),
            "splice": (join.cross_join, join.cross_join_ref,
                       join.cross_join_cuda, splice)}


def _flat(out):
    """The tensors of an output, nested tuples (ExpandOut, PathSet)
    flattened."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for part in out for t in _flat(part)]


def _calls():
    args, kw = _level_args()
    calls = {"level": (enum.expand_level, enum.expand_level_ref,
                       enum.expand_level_cuda, (args, kw))}
    calls.update(_join_args())
    return calls


@pytest.mark.parametrize("what", ["level", "keyed", "keyed_count", "splice"])
def test_cpu_tensors_take_the_plain_version(what):
    dispatch, plain, _, (args, kw) = _calls()[what]
    before = dict(LAUNCHES)
    want = _flat(plain(*args, **kw))
    for arm in (None, "torch"):
        got = _flat(dispatch(*args, **kw, arm=arm))
        assert len(got) == len(want)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert LAUNCHES == before                        # no kernel counted


@pytest.mark.parametrize("what", ["level", "keyed", "keyed_count", "splice"])
def test_cuda_arm_on_cpu_tensors_raises(what):
    dispatch, _, _, (args, kw) = _calls()[what]
    with pytest.raises(ValueError, match="cannot run on a cpu tensor"):
        dispatch(*args, **kw, arm="cuda")
    with pytest.raises(ValueError, match="unknown kernel arm"):
        dispatch(*args, **kw, arm="triton")


@pytest.mark.parametrize("what", ["level", "keyed", "keyed_count", "splice"])
def test_fused_kernels_refuse_cpu_tensors(what):
    """No fallback: the fused wrappers raise before they build anything."""
    _, _, fused, (args, kw) = _calls()[what]
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        fused(*args, **kw)
    assert LAUNCHES == before


def test_unknown_join_kind_raises():
    with pytest.raises(ValueError, match="unknown join kind"):
        jops.fused_join_cuda("cross", torch.zeros((1, 1), dtype=torch.int32),
                             torch.zeros((1, 1), dtype=torch.int32),
                             a_len=1, b_len=1, out_cap=1)


def test_fused_counters_are_registered():
    assert {"level_fused", "join_fused"} <= set(ROUTE_COUNTS)
    assert {"level_fused", "join_fused"} <= set(LAUNCHES)


# ----------------------------------------------------------------------
# the packed count / overflow readback
# ----------------------------------------------------------------------

@pytest.mark.parametrize("count,overflow", [(0, False), (7, True),
                                            (2**40 + 3, False)])
def test_packed_status_views_and_one_readback(count, overflow):
    buf, state, out = jops._fused_buffers(5, (4, 3), "cpu")
    assert out.shape == (4, 3) and out.data_ptr() == state.data_ptr() + 40
    state[0], state[1] = count, int(overflow)
    n, ovf = jops.packed_status(state)
    assert n.dtype == torch.int64 and ovf.dtype == torch.bool
    assert n.dim() == ovf.dim() == 0
    assert int(n) == count and bool(ovf) == overflow
    assert read_status(n, ovf) == (count, overflow)
    state[1] = 1 - int(overflow)                    # views, not copies
    assert read_status(n, ovf) == (count, not overflow)


def test_read_status_of_separate_tensors():
    assert read_status(torch.tensor(5), torch.tensor(True)) == (5, True)
    assert read_status(torch.tensor(0, dtype=torch.int32),
                       torch.tensor(False)) == (0, False)
    # an int64 pair that is not a count and its overflow is read as two
    pair = torch.tensor([3, 1])
    assert read_status(pair[0], torch.tensor(False)) == (3, False)


def test_engine_reads_each_level_and_join_once(monkeypatch):
    """One host readback (count and overflow together) per expand level
    and per join attempt, and the same answers."""
    from repro_torch.core import (EngineConfig, PathQuery, PathSession,
                                  generators)
    g = generators.community(600, n_comm=3, avg_deg=5.0, seed=1)
    base = generators.similar_queries(g, 6, similarity=0.8, k_range=(4, 5),
                                      seed=2)
    qs = [PathQuery(s, t, k) for s, t, k in base]
    qs += [PathQuery(s, t, k, output="count") for s, t, k in base[:2]]
    want = PathSession(g, EngineConfig(plan_caps=False), device="cpu").run(qs)
    calls = {"reads": 0, "levels": 0, "joins": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(engine_mod, "read_status",
                        counting("reads", engine_mod.read_status))
    monkeypatch.setattr(enum, "expand_level_ref",
                        counting("levels", enum.expand_level_ref))
    for name in ("keyed_join_ref", "keyed_join_count_ref", "cross_join_ref"):
        monkeypatch.setattr(join, name, counting("joins", getattr(join, name)))
    got = PathSession(g, EngineConfig(plan_caps=False), device="cpu").run(qs)
    assert calls["levels"] > 0 and calls["joins"] > 0
    assert calls["reads"] == calls["levels"] + calls["joins"]
    for q, a, b in zip(qs, got, want):
        assert a.count == b.count
        if q.output.value == "paths":
            assert np.array_equal(a.paths, b.paths)
