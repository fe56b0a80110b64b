"""The port's kernel ops API against the JAX package's.

``msbfs_hop_packed``, ``path_overlap``, ``keyed_join_valid`` and
``splice_join_valid`` on the CPU (the plain versions of the port's
``msbfs_expand`` and ``path_overlap`` kernels) against the JAX ops with
their Pallas kernels under the interpreter, on the same inputs made with
numpy from fixed seeds. The tolerance is exact equality: every output is
an integer or a boolean. Also: the hop never writes the caller's tensor,
the validity sums equal the port's own join counts on engine half rows,
and an explicit ``"cuda"`` arm on CPU tensors raises. The card's
``path_overlap`` formulation (a dictionary of each 32-row A tile's ids, an
int8 count product over it, the compare loop where a dictionary
overflows), emulated in numpy, is held to the plain version and to the
JAX op at its edges.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import generators as j_gen  # noqa: E402
from repro.core.graph import DeviceGraph as JDeviceGraph  # noqa: E402
from repro.core.msbfs import msbfs_hop as j_msbfs_hop  # noqa: E402
from repro.kernels.msbfs_expand import ops as j_mops  # noqa: E402
from repro.kernels.path_join import ops as j_jops  # noqa: E402
from repro_torch.core import DeviceGraph, Graph  # noqa: E402
from repro_torch.core.enumerate import expand_level, prune_table  # noqa: E402
from repro_torch.core.join import (cross_join, keyed_join,  # noqa: E402
                                   keyed_join_count, sort_by_last)
from repro_torch.core.pathset import singleton  # noqa: E402
from repro_torch.kernels.msbfs_expand import ops as mops  # noqa: E402
from repro_torch.kernels.path_join import ops as jops  # noqa: E402

CPU = "cpu"


def _u32(words):
    """Port int32 words -> the reference's uint32 array (same bits)."""
    return jnp.asarray(np.asarray(words).view(np.uint32))


def _i32(x):
    return np.asarray(x).view(np.int32)


def _carry(jg):
    return Graph.from_arrays(jg.n, jg.indptr, jg.indices, jg.r_indptr,
                             jg.r_indices)


# ----------------------------------------------------------------------
# msbfs_hop_packed
# ----------------------------------------------------------------------

@pytest.mark.parametrize("V,D,W,seed", [(16, 2, 1, 0), (64, 5, 2, 1),
                                        (130, 8, 4, 2), (257, 3, 7, 3),
                                        (1, 1, 1, 4), (33, 1, 9, 5)])
def test_msbfs_hop_packed_matches_jax(V, D, W, seed):
    r = np.random.default_rng(seed)
    ell = r.integers(0, V + 1, (V, D)).astype(np.int32)      # pad = V
    words = r.integers(0, 2**32, (V + 1, W), dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)
    words[V] = r.integers(1, 2**31, W)                 # garbage in row V
    fw = torch.from_numpy(words.copy())
    before = fw.clone()
    got = mops.msbfs_hop_packed(torch.from_numpy(ell), fw)
    want = j_mops.msbfs_hop_packed(jnp.asarray(ell), _u32(words),
                                   backend="interpret")
    assert got.dtype == torch.int32 and got.shape == (V + 1, W)
    np.testing.assert_array_equal(got.numpy(), _i32(want))
    assert not got[V].any()
    assert torch.equal(fw, before), "the hop wrote the caller's tensor"


def test_msbfs_hop_packed_matches_segment_hop():
    """One packed hop over the reverse ELL table == one unpacked segment
    hop of the JAX package (its ``tests/test_msbfs.py`` check)."""
    jg = j_gen.powerlaw(80, 4.0, seed=9)
    jdg = JDeviceGraph.build(jg)
    dg = DeviceGraph.build(_carry(jg), CPU)
    r = np.random.default_rng(0)
    S = 37
    frontier = r.random((jg.n + 1, S)) < 0.2
    frontier[-1] = False
    dense = np.asarray(j_msbfs_hop(jnp.asarray(frontier, jnp.int8),
                                   jdg.esrc, jdg.edst, jg.n))
    words = mops.pack_bits(torch.from_numpy(frontier))
    nxt = mops.msbfs_hop_packed(dg.r_ell_idx, words)
    got = mops.unpack_bits(nxt, S).numpy()
    np.testing.assert_array_equal(got[:-1], dense[:-1].astype(bool))


# ----------------------------------------------------------------------
# path_overlap and the validity matrices
# ----------------------------------------------------------------------

def _rows(r, N, L, hi=40, pad_rows=0):
    """Random int32 rows with -1 pads: some interior, some trailing, and
    ``pad_rows`` rows all -1."""
    x = r.integers(-1, hi, (N, L)).astype(np.int32)
    lens = r.integers(0, L + 1, N)
    x[np.arange(L)[None, :] >= lens[:, None]] = -1
    x[:pad_rows] = -1
    return x


SHAPES = [(8, 8, 3, 3), (37, 23, 5, 4), (300, 70, 9, 8), (1, 5, 2, 6),
          (257, 1, 9, 9), (5, 260, 1, 1), (3, 4, 1, 9), (70, 33, 9, 1)]


@pytest.mark.parametrize("NA,NB,LA,LB", SHAPES)
def test_path_overlap_matches_jax(NA, NB, LA, LB):
    r = np.random.default_rng(NA * 1000 + NB + LA + LB)
    A = _rows(r, NA, LA, pad_rows=1)
    B = _rows(r, NB, LB, pad_rows=1)
    got = jops.path_overlap(torch.from_numpy(A), torch.from_numpy(B))
    want = j_jops.path_overlap(jnp.asarray(A), jnp.asarray(B),
                               backend="interpret")
    assert got.dtype == torch.int32 and got.shape == (NA, NB)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("NA,NB,LA,LB", SHAPES)
def test_join_validity_matches_jax(NA, NB, LA, LB):
    r = np.random.default_rng(NA + 7 * NB + LA * LB)
    A = _rows(r, NA, LA, hi=12, pad_rows=1)
    B = _rows(r, NB, LB, hi=12, pad_rows=1)
    tA, tB = torch.from_numpy(A), torch.from_numpy(B)
    jA, jB = jnp.asarray(A), jnp.asarray(B)
    for a_col in sorted({0, LA - 1}):
        for b_col in sorted({0, LB - 1}):
            got = jops.keyed_join_valid(tA, a_col, tB, b_col)
            want = j_jops.keyed_join_valid(jA, a_col, jB, b_col,
                                           backend="interpret")
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            got = jops.splice_join_valid(tA, a_col, tB, b_col)
            want = j_jops.splice_join_valid(jA, a_col, jB, b_col,
                                            backend="interpret")
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_validity_semantics_by_hand():
    """The reference's hand-made cases (``tests/test_kernels.py``)."""
    A = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    B = torch.tensor([[9, 2], [5, 2], [7, 5]], dtype=torch.int32)
    v = jops.keyed_join_valid(A, 2, B, 1)
    assert v[0, 0] and v[0, 1] and v[1, 2] and not v[1, 0]
    P = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    C = torch.tensor([[4, 5], [1, 9]], dtype=torch.int32)
    v = jops.splice_join_valid(P, 1, C, 1)
    assert v[0, 0] and not v[0, 1] and v[1, 0] and v[1, 1]


def test_path_overlap_takes_row_slices_without_copies():
    r = np.random.default_rng(3)
    A = torch.from_numpy(_rows(r, 40, 9))
    B = torch.from_numpy(_rows(r, 30, 9))
    a, b = A[:, :4], B[:, :6]
    assert not a.is_contiguous() and a.stride(-1) == 1
    np.testing.assert_array_equal(
        jops.path_overlap(a, b).numpy(),
        np.asarray(j_jops.path_overlap(jnp.asarray(A.numpy()[:, :4]),
                                       jnp.asarray(B.numpy()[:, :6]),
                                       backend="interpret")))


# ----------------------------------------------------------------------
# path_overlap's formulation on the card (csrc/path_join.cu): a dictionary
# of each 32-row A tile's ids and an int8 count product over it
# ----------------------------------------------------------------------

TILE_A, DICT_MAX, COUNT_MAX = 32, 256, 127


def _dictionary_overlap(A, B):
    """Plain emulation of the card's path_overlap: for each tile of 32 A
    rows, the dictionary of its distinct non-negative ids (sorted here; the
    card numbers them in hash order, and the product does not depend on the
    order), int8 count rows ``cnt_a`` (32, K) and ``cnt_b`` (NB, K) with K
    rounded up to 32, and ``cnt_a @ cnt_b.T`` in int32. A tile with more
    than 256 distinct ids, and every tile when a row is longer than 127,
    takes the compare loop. Returns (out, tiles that compared)."""
    NA, LA = A.shape
    NB, LB = B.shape
    out = np.zeros((NA, NB), np.int32)
    compared = 0
    for i0 in range(0, NA, TILE_A):
        tile = A[i0:i0 + TILE_A]
        ids = np.unique(tile[tile >= 0])
        if LA > COUNT_MAX or LB > COUNT_MAX or ids.size > DICT_MAX:
            compared += 1
            eq = (tile[:, None, :, None] == B[None, :, None, :]) \
                & (tile >= 0)[:, None, :, None]
            out[i0:i0 + TILE_A] = eq.sum(axis=(2, 3))
            continue
        K = -(-ids.size // 32) * 32
        cnt_a = np.zeros((tile.shape[0], K), np.int8)
        r, p = np.nonzero(tile >= 0)
        np.add.at(cnt_a, (r, np.searchsorted(ids, tile[r, p])), 1)
        cnt_b = np.zeros((NB, K), np.int8)
        if ids.size:
            pos = np.minimum(np.searchsorted(ids, B), ids.size - 1)
            j, q = np.nonzero((ids[pos] == B) & (B >= 0))
            np.add.at(cnt_b, (j, pos[j, q]), 1)
        out[i0:i0 + TILE_A] = cnt_a.astype(np.int32) \
            @ cnt_b.astype(np.int32).T
    return out, compared


def _overlap_case(case):
    """(A, B, tiles expected to compare) of one edge of the formulation."""
    r = np.random.default_rng(len(case))
    big = 2**31 - 1
    if case == "ids_near_int32_max":
        A = r.integers(big - 40, big + 1, (45, 6)).astype(np.int32)
        B = r.integers(big - 40, big + 1, (70, 5)).astype(np.int32)
        A[r.random(A.shape) < 0.3] = -7          # pads other than -1
        A[:, 0] = -big - 1
        B[r.random(B.shape) < 0.2] = -1
        return A, B, 0
    if case == "repeats":                         # [5, 5] against [5] is 2
        A = r.integers(0, 6, (64, 8)).astype(np.int32)
        B = r.integers(-2, 6, (33, 7)).astype(np.int32)
        A[0] = 5
        B[0] = 5
        return A, B, 0
    if case == "dictionary_overflow":             # 32 x 9 distinct ids
        A = r.permutation(10**6)[:40 * 9].reshape(40, 9).astype(np.int32)
        B = A[r.integers(0, 40, 50)][:, ::-1].copy()
        B[:, 3] = A[5, 2]
        return A, B, 1
    if case == "long_rows":       # LA 121, LB 40; the first tile overflows
        A = r.integers(-1, 300, (33, 121)).astype(np.int32)
        B = r.integers(-1, 300, (257, 40)).astype(np.int32)
        return A, B, 1
    if case == "rows_past_127":                   # int8 counts could wrap
        A = np.full((3, 130), 9, np.int32)
        B = np.full((4, 2), 9, np.int32)
        B[1] = -1
        return A, B, 1
    raise ValueError(case)


@pytest.mark.parametrize("case", ["ids_near_int32_max", "repeats",
                                  "dictionary_overflow", "long_rows",
                                  "rows_past_127"])
def test_dictionary_formulation_matches_plain_and_jax(case):
    A, B, want_compared = _overlap_case(case)
    got, compared = _dictionary_overlap(A, B)
    assert compared == want_compared
    plain = jops.path_overlap_ref(torch.from_numpy(A), torch.from_numpy(B))
    np.testing.assert_array_equal(got, plain.numpy())
    want = j_jops.path_overlap(jnp.asarray(A), jnp.asarray(B),
                               backend="interpret")
    np.testing.assert_array_equal(got, np.asarray(want))
    if case == "repeats":
        assert got[0, 0] == 8 * 7
    if case == "rows_past_127":
        assert got[0, 0] == 260 and got[0, 1] == 0


# ----------------------------------------------------------------------
# the validity sums against the port's own joins, on engine half rows
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def halves():
    """Forward and backward levels of one (s, t, k) query on a small
    community graph, as the engine's expand levels produce them."""
    jg = j_gen.community(300, n_comm=3, avg_deg=5.0, seed=4)
    g = _carry(jg)
    dg = DeviceGraph.build(g, CPU)
    s, t, k = j_gen.random_queries(jg, 1, k_range=(6, 6), seed=5)[0]

    def levels(reverse, src, budget):
        slack = torch.full((g.n + 1,), budget, dtype=torch.int8)
        slack[-1] = -1
        tbl = prune_table(slack, torch.full((g.n + 1,), -1,
                                            dtype=torch.int8))
        fr = singleton(src, budget + 1, CPU)
        out = [fr]
        for lvl in range(budget):
            res = expand_level(fr.verts, fr.count, dg.direction(reverse),
                               tbl, -2, level=lvl, budget=budget,
                               out_cap=1 << 14)
            assert not bool(res.frontier.overflow)
            fr = res.frontier
            out.append(fr)
        return out

    return dict(g=g, s=s, t=t, fwd=levels(False, s, 3),
                bwd=levels(True, t, 3))


@pytest.mark.parametrize("a_col,b_col", [(1, 1), (2, 2), (3, 3), (3, 1)])
def test_keyed_validity_sum_equals_join_counts(halves, a_col, b_col):
    fa, bb = halves["fwd"][a_col], halves["bwd"][b_col]
    na, nb = int(fa.count), int(bb.count)
    assert na > 0 and nb > 0
    valid = jops.keyed_join_valid(fa.verts[:na], a_col, bb.verts[:nb], b_col)
    sa = sort_by_last(fa.verts, fa.count, col=a_col)
    n, ovf = keyed_join_count(sa, bb.verts, bb.count, a_col=a_col,
                              b_col=b_col, pair_cap=na * nb + 1)
    assert not bool(ovf)
    assert int(valid.sum()) == int(n)
    joined = keyed_join(sa, bb.verts, bb.count, a_col=a_col, b_col=b_col,
                        out_cap=na * nb + 1, out_width=a_col + b_col + 1)
    assert int(joined.count) == int(n)


@pytest.mark.parametrize("p_col,c_col", [(0, 1), (1, 2), (2, 3), (1, 0)])
def test_splice_validity_sum_equals_cross_join_count(halves, p_col, c_col):
    # prefixes: forward rows of length p_col; children: forward rows of
    # another root (their spliced vertex need not follow the prefix here:
    # both functions count the vertex-disjoint pairs)
    pre, ch = halves["fwd"][p_col], halves["bwd"][c_col]
    npre, nch = int(pre.count), int(ch.count)
    assert npre > 0 and nch > 0
    valid = jops.splice_join_valid(pre.verts[:npre], p_col,
                                   ch.verts[:nch], c_col)
    out = cross_join(pre.verts, pre.count, ch.verts, ch.count, p_col=p_col,
                     c_col=c_col, out_cap=npre * nch + 1,
                     out_width=p_col + c_col + 2)
    assert not bool(out.overflow)
    assert int(valid.sum()) == int(out.count)


# ----------------------------------------------------------------------
# the device rule
# ----------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda: mops.msbfs_hop_packed(torch.zeros((2, 1), dtype=torch.int32),
                                  torch.zeros((3, 1), dtype=torch.int32),
                                  arm="cuda"),
    lambda: jops.path_overlap(torch.zeros((2, 2), dtype=torch.int32),
                              torch.zeros((2, 2), dtype=torch.int32),
                              arm="cuda"),
    lambda: jops.keyed_join_valid(torch.zeros((2, 2), dtype=torch.int32), 1,
                                  torch.zeros((2, 2), dtype=torch.int32), 1,
                                  arm="cuda"),
    lambda: jops.splice_join_valid(torch.zeros((2, 2), dtype=torch.int32), 1,
                                   torch.zeros((2, 2), dtype=torch.int32), 1,
                                   arm="cuda"),
])
def test_cuda_arm_on_cpu_tensors_raises(call):
    with pytest.raises(ValueError, match="cannot run on a cpu tensor"):
        call()


@pytest.mark.parametrize("wrapper,args", [
    (mops.msbfs_expand_cuda, ((2, 1), (3, 1))),
    (jops.path_overlap_cuda, ((2, 2), (3, 2))),
])
def test_cuda_wrappers_refuse_cpu_tensors(wrapper, args):
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        wrapper(*(torch.zeros(s, dtype=torch.int32) for s in args))
