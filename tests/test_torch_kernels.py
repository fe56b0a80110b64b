"""The port's plain kernel versions against the JAX package's kernels.

For each of the five ported kernels, the same random inputs (made with
numpy from a seed) go through the port's plain PyTorch version, the JAX
``ref.py`` and the Pallas kernel under the interpreter. The tolerance is
exact equality: the outputs are integers, or (``ell_spmm``) float32 sums
taken in the same order as the Pallas kernel's, which agree bit for bit
for any values. Also: the kernel-arm rules, and that the CUDA wrappers
refuse CPU tensors.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ell_spmm.kernel import ell_spmm_pallas  # noqa: E402
from repro.kernels.ell_spmm.ops import (  # noqa: E402
    ell_aggregate as j_ell_aggregate)
from repro.kernels.msbfs_expand.kernel import msbfs_step_pallas  # noqa: E402
from repro.kernels.msbfs_expand.ref import (  # noqa: E402
    msbfs_step_ref as j_msbfs_step_ref, pack_bits as j_pack_bits)
from repro.kernels.pairwise_popcount.kernel import (  # noqa: E402
    pairwise_popcount_pallas)
from repro.kernels.pairwise_popcount.ref import (  # noqa: E402
    intersections_bool_ref as j_intersections_bool_ref,
    pairwise_popcount_ref as j_pairwise_popcount_ref)
from repro.kernels.path_join.kernel import (  # noqa: E402
    path_member_pallas, rowwise_overlap_pallas)
from repro.kernels.path_join.ref import (  # noqa: E402
    path_member_ref as j_path_member_ref,
    rowwise_overlap_ref as j_rowwise_overlap_ref)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ell_spmm import ops as eops  # noqa: E402
from repro_torch.kernels.msbfs_expand import ops as mops  # noqa: E402
from repro_torch.kernels.pairwise_popcount import ops as pops  # noqa: E402
from repro_torch.kernels.path_join import ops as jops  # noqa: E402
from repro_torch.kernels.registry import (  # noqa: E402
    KernelArm, check_tensor, resolve_arm)


def _u32_to_i32(x):
    return torch.from_numpy(np.asarray(x).view(np.int32).copy())


def _np(t):
    return np.asarray(t)


# ----------------------------------------------------------------------
# pack / unpack
# ----------------------------------------------------------------------

@pytest.mark.parametrize("V,S", [(5, 1), (4, 31), (3, 32), (6, 33), (2, 70),
                                 (0, 9)])
def test_pack_bits_matches_jax_layout(V, S):
    r = np.random.default_rng(V * 100 + S)
    bits = r.random((V, S)) < 0.5
    got = mops.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    assert np.array_equal(_np(got), _np(j_pack_bits(jnp.asarray(bits)))
                          .view(np.int32))
    assert np.array_equal(_np(mops.unpack_bits(got, S)), bits)


def test_pack_bits_high_bit_wraps_explicitly():
    bits = torch.zeros((1, 32), dtype=torch.bool)
    bits[0, 31] = True
    assert int(mops.pack_bits(bits)[0, 0]) == -2**31
    assert bool(mops.unpack_bits(torch.tensor([[-2**31]], dtype=torch.int32),
                                 32)[0, 31])


# ----------------------------------------------------------------------
# msbfs_step
# ----------------------------------------------------------------------

def _step_inputs(V, D, W, seed, *, sentinel_rows=0, empty_frontier=False):
    r = np.random.default_rng(seed)
    ell = r.integers(0, V + 1, (V, D)).astype(np.int32)
    ell[:sentinel_rows] = V
    fr = r.integers(0, 2**32, (V + 1, W), dtype=np.uint64).astype(np.uint32)
    if empty_frontier:
        fr[:] = 0
    fr[-1] = 0
    vis = r.integers(0, 2**32, (V, W), dtype=np.uint64).astype(np.uint32)
    vis &= r.integers(0, 2**32, (V, W), dtype=np.uint64).astype(np.uint32)
    dist = r.integers(0, 9, (V, W * 32)).astype(np.int8)
    return ell, fr, vis, dist


@pytest.mark.parametrize("V,D,W,seed,kw", [
    (40, 4, 1, 0, {}),
    (90, 6, 3, 1, {}),
    (17, 1, 2, 2, {}),
    (33, 5, 2, 3, {"sentinel_rows": 33}),       # all-sentinel ELL
    (25, 3, 2, 4, {"empty_frontier": True}),
    (60, 8, 1, 5, {"sentinel_rows": 20}),
])
def test_msbfs_step_plain_matches_jax(V, D, W, seed, kw):
    ell, fr, vis, dist = _step_inputs(V, D, W, seed, **kw)
    hop = 3
    vis_t, dist_t = _u32_to_i32(vis), torch.from_numpy(dist.copy())
    out = mops.msbfs_step(torch.from_numpy(ell), _u32_to_i32(fr), vis_t,
                          dist_t, hop)
    assert out.shape == (V + 1, W) and not out[V].any()
    j_args = (jnp.asarray(ell), jnp.asarray(fr), jnp.asarray(vis),
              jnp.asarray(dist))
    for ref in (j_msbfs_step_ref(*j_args, hop),
                msbfs_step_pallas(*j_args, hop=hop, interpret=True)):
        new, nvis, ndist = (_np(x) for x in ref)
        assert np.array_equal(_np(out[:V]), new.view(np.int32))
        assert np.array_equal(_np(vis_t), nvis.view(np.int32))
        assert np.array_equal(_np(dist_t), ndist)


def test_msbfs_step_zero_vertices():
    out = mops.msbfs_step(torch.zeros((0, 3), dtype=torch.int32),
                          torch.zeros((1, 2), dtype=torch.int32),
                          torch.zeros((0, 2), dtype=torch.int32),
                          torch.zeros((0, 64), dtype=torch.int8), 1)
    assert out.shape == (1, 2) and not out.any()


# ----------------------------------------------------------------------
# pairwise_popcount
# ----------------------------------------------------------------------

@pytest.mark.parametrize("Q,W,seed", [(7, 3, 0), (12, 40, 1), (1, 1, 2),
                                      (9, 17, 3), (5, 0, 4)])
def test_pairwise_popcount_plain_matches_jax(Q, W, seed):
    r = np.random.default_rng(seed)
    words = r.integers(0, 2**32, (Q, W), dtype=np.uint64).astype(np.uint32)
    got = _np(pops.pairwise_popcount(_u32_to_i32(words)))
    assert got.dtype == np.int32 and got.shape == (Q, Q)
    assert np.array_equal(got, _np(j_pairwise_popcount_ref(jnp.asarray(words))))
    if W:
        assert np.array_equal(got, _np(pairwise_popcount_pallas(
            jnp.asarray(words), interpret=True)))


def test_pairwise_popcount_chunks_exactly(monkeypatch):
    # many row and word chunks: the chunked sum must stay exact
    monkeypatch.setattr(pops, "_CHUNK", 64)
    r = np.random.default_rng(9)
    words = r.integers(0, 2**32, (11, 4100), dtype=np.uint64).astype(np.uint32)
    got = _np(pops.intersections(_u32_to_i32(words)))
    assert np.array_equal(got, _np(j_pairwise_popcount_ref(jnp.asarray(words))))


@pytest.mark.parametrize("Q,V", [(6, 100), (10, 64), (3, 1)])
def test_pairwise_intersections_of_bits_matches_jax(Q, V):
    r = np.random.default_rng(Q + V)
    bits = r.random((Q, V)) < 0.4
    got = _np(pops.pairwise_intersections(torch.from_numpy(bits)))
    assert np.array_equal(got, _np(j_intersections_bool_ref(jnp.asarray(bits))))


# ----------------------------------------------------------------------
# path_member / rowwise_overlap
# ----------------------------------------------------------------------

@pytest.mark.parametrize("N,L,D,seed", [(40, 5, 6, 0), (1, 1, 1, 1),
                                        (33, 4, 32, 2), (0, 3, 4, 3)])
def test_path_member_plain_matches_jax(N, L, D, seed):
    r = np.random.default_rng(seed)
    verts = r.integers(-1, 15, (N, L)).astype(np.int32)
    cand = r.integers(0, 16, (N, D)).astype(np.int32)
    got = _np(jops.path_member(torch.from_numpy(verts),
                               torch.from_numpy(cand)))
    assert got.shape == (N, D)
    assert np.array_equal(got, _np(j_path_member_ref(jnp.asarray(verts),
                                                     jnp.asarray(cand))))
    if N:
        assert np.array_equal(got, _np(path_member_pallas(
            jnp.asarray(verts), jnp.asarray(cand), interpret=True)))


@pytest.mark.parametrize("N,LA,LB,seed", [(50, 4, 5, 0), (1, 1, 1, 1),
                                          (20, 7, 2, 2), (0, 2, 3, 3)])
def test_rowwise_overlap_plain_matches_jax(N, LA, LB, seed):
    r = np.random.default_rng(seed)
    A = r.integers(-1, 12, (N, LA)).astype(np.int32)
    B = r.integers(-1, 12, (N, LB)).astype(np.int32)
    got = _np(jops.rowwise_overlap(torch.from_numpy(A), torch.from_numpy(B)))
    assert got.shape == (N,)
    assert np.array_equal(got, _np(j_rowwise_overlap_ref(jnp.asarray(A),
                                                         jnp.asarray(B))))
    if N:
        assert np.array_equal(got, _np(rowwise_overlap_pallas(
            jnp.asarray(A), jnp.asarray(B), interpret=True))[:, 0])


def test_strided_rows_match_contiguous():
    r = np.random.default_rng(5)
    wide = torch.from_numpy(r.integers(-1, 9, (30, 8)).astype(np.int32))
    cand = torch.from_numpy(r.integers(0, 9, (30, 4)).astype(np.int32))
    assert torch.equal(jops.path_member(wide[:, :3], cand),
                       jops.path_member(wide[:, :3].contiguous(), cand))
    assert torch.equal(jops.rowwise_overlap(wide[:, :3], wide[:, 5:]),
                       jops.rowwise_overlap(wide[:, :3].contiguous(),
                                            wide[:, 5:].contiguous()))


# ----------------------------------------------------------------------
# ell_spmm
# ----------------------------------------------------------------------

def _spmm_inputs(V, D, F, seed, *, pad_frac=0.3, pad_rows=0, floats=False):
    r = np.random.default_rng(seed)
    ell = r.integers(0, V, (V, D)).astype(np.int32) if V else \
        np.zeros((0, D), np.int32)
    ell[r.random((V, D)) < pad_frac] = V
    ell[:pad_rows] = V                               # all-pad rows
    if floats:      # arbitrary float32s: equal only by order of summation
        x = (r.standard_normal((V, F)) * 10.0 ** r.integers(
            -3, 4, (V, F))).astype(np.float32)
    else:           # integer-valued, as the walk-count DP's
        x = r.integers(-50, 50, (V, F)).astype(np.float32)
    return ell, x


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("V,D,F,seed,kw", [
    (40, 4, 1, 0, {}),
    (300, 8, 3, 1, {}),
    (33, 5, 1, 2, {"pad_rows": 33}),                # every row all-pad
    (70, 6, 3, 3, {"pad_rows": 10, "pad_frac": 0.6}),
])
def test_ell_aggregate_matches_jax(op, V, D, F, seed, kw):
    ell, x = _spmm_inputs(V, D, F, seed, **kw)
    got = eops.ell_aggregate(torch.from_numpy(ell), torch.from_numpy(x), op)
    assert got.dtype == torch.float32 and got.shape == (V, F)
    for backend in ("jnp", "interpret"):
        ref = j_ell_aggregate(jnp.asarray(ell), jnp.asarray(x), op=op,
                              backend=backend)
        assert np.array_equal(_np(got), np.asarray(ref)), backend
    if kw.get("pad_rows") == V:
        assert not got.any()            # neutral everywhere (max: -inf -> 0)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("V,D,F,seed", [(257, 16, 3, 5), (100, 32, 1, 6)])
def test_ell_spmm_plain_bit_equal_to_pallas_for_any_floats(op, V, D, F, seed):
    ell, x = _spmm_inputs(V, D, F, seed, floats=True)
    fill = 0.0 if op == "sum" else -np.inf
    xs = np.concatenate([x, np.full((1, F), fill, np.float32)])
    got = eops.ell_spmm_ref(torch.from_numpy(ell), torch.from_numpy(xs), op)
    ref = np.asarray(ell_spmm_pallas(jnp.asarray(ell), jnp.asarray(xs), op=op,
                                     interpret=True))
    # bit for bit, not merely close: the same order of float adds
    assert np.array_equal(_np(got).view(np.int32), ref.view(np.int32))


def _skip_pads(ell, xs, op):
    """The arithmetic of ``ell_gather_f1_kernel``: the ascending-d order of
    ``ell_spmm_ref``, but a pad entry (== V) adds nothing where row V is
    neutral (no gather is issued for it)."""
    V, D = ell.shape
    fill = 0.0 if op == "sum" else float("-inf")
    pad = float(xs[V, 0])
    skip = pad == 0.0 if op == "sum" else pad == float("-inf")
    acc = torch.full((V, 1), fill, dtype=xs.dtype)
    for d in range(D):
        g = xs[ell[:, d]]
        nxt = acc + g if op == "sum" else torch.maximum(acc, g)
        acc = torch.where((ell[:, d] == V)[:, None] & skip, acc, nxt)
    return acc


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("pad_value", ["neutral", "negative zero"])
@pytest.mark.parametrize("V,D,seed", [(300, 32, 11), (77, 8, 12),
                                      (50, 4, 13)])
def test_skipping_pad_gathers_is_bit_identical(op, pad_value, V, D, seed):
    r = np.random.default_rng(seed)
    ell = r.integers(0, V, (V, D)).astype(np.int32)
    ell[r.random((V, D)) < 0.5] = V          # pads in the middle of rows
    ell[:3] = V                              # all-pad rows
    x = (r.standard_normal((V, 1)) * 10.0 ** r.integers(-3, 4, (V, 1))) \
        .astype(np.float32)
    for i, special in enumerate((-0.0, 0.0, np.inf, -np.inf, np.nan)):
        x[i::7] = special
    fill = 0.0 if op == "sum" else -np.inf
    if pad_value == "negative zero" and op == "sum":
        fill = -0.0
    xs = torch.from_numpy(np.concatenate([x, np.full((1, 1), fill,
                                                     np.float32)]))
    ell_t = torch.from_numpy(ell)
    got = _skip_pads(ell_t, xs, op)
    want = eops.ell_spmm_ref(ell_t, xs, op)
    assert np.array_equal(_np(got).view(np.int32), _np(want).view(np.int32))
    assert torch.isnan(want).any() and (want == float("inf")).any()


@pytest.mark.parametrize("D,F,aligned,want", [
    (32, 1, True, True), (4, 1, True, True), (128, 1, True, True),
    (12, 1, True, True), (30, 1, True, False), (132, 1, True, False),
    (0, 1, True, False), (32, 2, True, False), (32, 1, False, False)])
def test_f1_route(D, F, aligned, want):
    assert eops.f1_route(D, F, aligned) is want


def test_ell_aggregate_zero_vertices_and_width():
    for op in ("sum", "max"):
        out = eops.ell_aggregate(torch.zeros((0, 4), dtype=torch.int32),
                                 torch.zeros((0, 2)), op)
        ref = j_ell_aggregate(jnp.zeros((0, 4), jnp.int32),
                              jnp.zeros((0, 2), jnp.float32), op=op,
                              backend="jnp")
        assert out.shape == (0, 2) == ref.shape
    ell, x = _spmm_inputs(20, 3, 0, 7)
    assert eops.ell_aggregate(torch.from_numpy(ell),
                              torch.from_numpy(x)).shape == (20, 0)


def test_ell_aggregate_unknown_op_raises():
    ell, x = _spmm_inputs(10, 2, 1, 8)
    with pytest.raises(ValueError, match="sum | max"):
        eops.ell_aggregate(torch.from_numpy(ell), torch.from_numpy(x), "mean")


# ----------------------------------------------------------------------
# arm rules, wrappers on the wrong device, builds without nvcc
# ----------------------------------------------------------------------

def test_arm_follows_device():
    assert resolve_arm("cpu") is KernelArm.TORCH
    assert resolve_arm(torch.device("cuda")) is KernelArm.CUDA
    assert resolve_arm("cpu", "torch") is KernelArm.TORCH
    assert resolve_arm("cuda:0", KernelArm.CUDA) is KernelArm.CUDA
    assert KernelArm.TORCH == "torch" and str(KernelArm.CUDA) == "cuda"


@pytest.mark.parametrize("device,arm", [("cpu", "cuda"), ("cuda", "torch")])
def test_arm_contradicting_device_raises(device, arm):
    with pytest.raises(ValueError, match="cannot run on"):
        resolve_arm(device, arm)


def test_unknown_arm_raises_listing_valid():
    with pytest.raises(ValueError, match="torch | cuda"):
        resolve_arm("cpu", "triton")


def test_arm_env_variable_is_ignored(monkeypatch):
    for var in ("REPRO_KERNEL_BACKEND", "REPRO_TORCH_KERNEL_ARM"):
        monkeypatch.setenv(var, "torch")
    assert resolve_arm("cuda") is KernelArm.CUDA


def test_explicit_cuda_arm_on_cpu_tensor_raises():
    x = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        jops.path_member(x, x, arm="cuda")
    with pytest.raises(ValueError):
        pops.pairwise_popcount(x, arm="cuda")
    with pytest.raises(ValueError):
        eops.ell_aggregate(x, torch.zeros((2, 1)), arm="cuda")


@pytest.mark.parametrize("call", [
    lambda x: mops.msbfs_step_cuda(x[:2], torch.zeros((3, 2), dtype=torch.int32),
                                   x[:2], torch.zeros((2, 64),
                                                      dtype=torch.int8), 1),
    lambda x: pops.pairwise_popcount_cuda(x),
    lambda x: pops.gamma_pack_cuda(x.to(torch.int8), x[0],
                                   x[0].to(torch.int8), 2),
    lambda x: jops.path_member_cuda(x, x),
    lambda x: jops.rowwise_overlap_cuda(x, x),
    lambda x: eops.ell_spmm_cuda(x, torch.zeros((3, 1))),
])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    from repro_torch.kernels import LAUNCHES
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(torch.zeros((2, 2), dtype=torch.int32))
    assert LAUNCHES == before


def test_check_tensor_rejects_bad_dtype_and_layout():
    with pytest.raises(TypeError):
        check_tensor("x", torch.zeros((2, 2), dtype=torch.int64), torch.int32, 2)
    with pytest.raises(ValueError, match="2-D"):
        check_tensor("x", torch.zeros((2,), dtype=torch.int32), torch.int32, 2)


def test_build_needs_nvcc_and_names_sources(monkeypatch):
    # nothing was compiled at import; each source hashes to its own library
    paths = {build.library_path(n) for n in build.SOURCES}
    assert len(paths) == len(build.SOURCES)
    assert all((build.CSRC_DIR / f"{n}.cu").exists() for n in build.SOURCES)
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build, "TOOLKIT_NVCC",
                        build.CSRC_DIR / "no-such-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
