"""The port's dry-run launchers on the CPU: layouts, logical-axis rules,
the kernels' meta arm, the op census, the dry run and the roofline.

* ``models/sharding.Rules``: ``spec`` and ``size`` of every logical axis
  equal the JAX ``Rules``' on the host mesh (and on stand-ins of the two
  production meshes, which the JAX class reads only for axis names and
  sizes);
* the meta arm: ``msbfs_step``, ``expand_level``, ``gqa_attention`` (with
  and without a gradient) and ``flash_attention_bwd`` on ``meta`` tensors
  return the kernels' shapes and types, launch nothing, and report one
  call each with its analytic work to ``meta_launch``'s listeners;
* ``dryrun_cell`` on one ``REDUCED`` cell of each family (lm, gnn, recsys,
  engine): argument bytes equal the inputs' storages, no collectives on
  ``host``, the kernels counted, ``pod`` and ``multipod`` refused;
* ``roofline.analyze_cell`` on a hand-made record: terms and verdicts.
"""
import contextlib
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.launch.mesh import make_host_mesh as j_host_mesh  # noqa: E402
from repro.models.sharding import Rules as JRules  # noqa: E402
from repro_torch.core.enumerate import expand_level  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.msbfs_expand.ops import msbfs_step  # noqa: E402
from repro_torch.launch import dryrun, mesh, roofline  # noqa: E402
from repro_torch.launch.op_analysis import analyze_step  # noqa: E402
from repro_torch.launch.steps import build_bundle  # noqa: E402
from repro_torch.models.sharding import Rules  # noqa: E402

META = torch.device("meta")
LOGICAL = ("batch", "fsdp", "tensor", "expert", "cells", "seq", "seq_kv",
           "seq_kv_wide", None)


# ----------------------------------------------------------------------
# layouts and rules
# ----------------------------------------------------------------------

def _standin(layout):
    """What the JAX ``Rules`` reads of a mesh: axis names, device shape."""
    return types.SimpleNamespace(axis_names=layout.axis_names,
                                 devices=np.empty(layout.shape))


@pytest.mark.parametrize("name", ["host", "pod", "multipod"])
def test_rules_equal_jax(name):
    layout = mesh.mesh_by_name(name)
    want = JRules(j_host_mesh() if name == "host" else _standin(layout))
    got = Rules(layout)
    for ax in LOGICAL:
        assert got.size(ax) == want.size(ax), ax
        assert got.spec(ax) == tuple(want.spec(ax)), ax
    assert got.spec(*LOGICAL) == tuple(want.spec(*LOGICAL))
    assert got.local_shape((512, 64), "batch", "tensor") == (
        512 // want.size("batch"), 64 // want.size("tensor"))


def test_layouts():
    host = mesh.mesh_by_name("host")
    jhost = j_host_mesh()
    assert host.axis_names == tuple(jhost.axis_names)
    assert host.shape == tuple(jhost.devices.shape) and host.size == 1
    pod, multi = mesh.mesh_by_name("pod"), mesh.mesh_by_name("multipod")
    assert (pod.axis_names, pod.shape, pod.devices) == (
        ("data", "model"), (16, 16), None)
    assert (multi.axis_names, multi.shape, multi.size) == (
        ("pod", "data", "model"), (2, 16, 16), 512)
    with pytest.raises(KeyError):
        mesh.mesh_by_name("ring")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA devices"):
            mesh.make_cells_mesh()
    with pytest.raises(ValueError, match="split"):
        Rules(pod).local_shape((100,), "batch")


# ----------------------------------------------------------------------
# the meta arm
# ----------------------------------------------------------------------

@pytest.fixture
def calls():
    got = []

    def listener(name, ops, nbytes):
        got.append((name, ops, nbytes))
        return contextlib.nullcontext()

    registry.add_meta_listener(listener)
    registry.reset_launches()
    yield got
    registry.remove_meta_listener(listener)
    assert not any(registry.LAUNCHES.values())      # nothing launched


def test_meta_arm_resolves_and_refuses_other_arms():
    assert registry.resolve_arm("meta") is registry.KernelArm.META
    with pytest.raises(ValueError, match="cannot run on"):
        registry.resolve_arm("meta", "cuda")


def test_msbfs_step_meta(calls):
    V, D, W = 1000, 16, 3
    out = msbfs_step(torch.empty((V, D), dtype=torch.int32, device=META),
                     torch.empty((V + 1, W), dtype=torch.int32, device=META),
                     torch.empty((V, W), dtype=torch.int32, device=META),
                     torch.empty((V, 32 * W), dtype=torch.int8, device=META),
                     3)
    assert out.device == META and out.shape == (V + 1, W)
    assert out.dtype == torch.int32
    assert calls == [("msbfs_step", V * W * D,
                      V * D * 4 + (V + 1) * W * 8 + V * W * 8)]


def test_expand_level_meta(calls):
    cap, L, D, n = 64, 4, 8, 100
    out = expand_level(
        torch.empty((cap, L), dtype=torch.int32, device=META),
        torch.empty((), dtype=torch.int64, device=META),
        torch.empty((n, D), dtype=torch.int32, device=META),
        torch.empty((n + 1, 2), dtype=torch.int8, device=META), -2,
        level=1, budget=3, out_cap=256)
    assert out.frontier.verts.shape == (256, L)
    assert out.frontier.count.shape == () and out.nbrs.shape == (cap, D)
    assert out.splice_hit.dtype == torch.bool
    assert [c[0] for c in calls] == ["expand_level"]


@pytest.mark.parametrize("grad", [False, True])
def test_attention_meta(calls, grad):
    B, S, Hq, Hkv, hd = 2, 64, 8, 2, 32
    q = torch.empty((B, S, Hq, hd), dtype=torch.bfloat16, device=META,
                    requires_grad=grad)
    k = torch.empty((B, S, Hkv, hd), dtype=torch.bfloat16, device=META,
                    requires_grad=grad)
    v = torch.empty_like(k, requires_grad=grad)
    out = fops.gqa_attention(q, k, v)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    pairs = S * (S + 1) // 2
    assert calls[0][:2] == ("flash_attention", 4 * hd * pairs * B * Hq)
    if grad:
        dq, dk, dv = torch.autograd.grad(out.float().sum(), (q, k, v))
        assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
        assert calls[1][:2] == ("flash_attention_bwd",
                                10 * hd * pairs * B * Hq)
    assert len(calls) == 1 + grad


@pytest.mark.parametrize("Sq,q_offset,valid,causal", [
    (7, 0, 7, True), (1, 543, 544, True), (8, 292, 300, True),
    (512, 32256, 32768, True), (16, 0, 9, False), (5, 10, 3, True)])
def test_visible_pairs(Sq, q_offset, valid, causal):
    want = sum(min(valid, q_offset + i + 1) if causal else valid
               for i in range(Sq))
    assert fops.visible_pairs(Sq, q_offset, valid, causal) == want


def test_census_counts_a_kernel_as_one_op():
    V, D, W = 64, 4, 1
    args = (torch.empty((V, D), dtype=torch.int32, device=META),
            torch.empty((V + 1, W), dtype=torch.int32, device=META),
            torch.empty((V, W), dtype=torch.int32, device=META),
            torch.empty((V, 32), dtype=torch.int8, device=META), 1)
    rec, out = analyze_step(msbfs_step, args)
    assert rec["kernels"] == {"msbfs_step": {
        "calls": 1, "ops": float(V * W * D),
        "bytes": float(V * D * 4 + (V + 1) * W * 8 + V * W * 8)}}
    assert rec["ops"] == 1 and rec["aten_ops"] == 0 and rec["flops"] == 0
    mem = rec["memory"]
    assert mem["argument_bytes"] == V * D * 4 + (V + 1) * 4 + V * 4 + V * 32
    assert mem["output_bytes"] == (V + 1) * W * 4
    assert mem["peak_live_bytes"] == mem["argument_bytes"] + (V + 1) * 4


# ----------------------------------------------------------------------
# the dry run and the roofline
# ----------------------------------------------------------------------

CELLS = {
    "lm": ("granite-8b", "train_4k", {"seq_len": 32, "global_batch": 4}),
    "gnn": ("meshgraphnet", "full_graph_sm", None),
    "recsys": ("two-tower-retrieval", "train_batch", {"batch": 64}),
    "engine": ("path-engine", "batch_1b", {"n_vertices": 4096,
                                          "n_queries": 16, "k": 4}),
}


def _storage_bytes(args) -> int:
    from repro_torch.launch.op_analysis import tensors_of
    return sum({id(t.untyped_storage()): t.untyped_storage().nbytes()
                for t in tensors_of(args)}.values())


@pytest.mark.parametrize("family", sorted(CELLS))
def test_dryrun_cell_per_family(family):
    arch, shape, over = CELLS[family]
    rec = dryrun.dryrun_cell(arch, shape, reduced=True, overrides=over)
    assert rec["ok"] and rec["mesh"] == "host" and rec["n_devices"] == 1
    assert rec["meta"]["family"] == family
    bundle = build_bundle(arch, shape, reduced=True, overrides=over)
    args = dryrun.step_args(bundle)
    assert rec["memory"]["argument_bytes"] == _storage_bytes(args)
    assert rec["census"]["collectives"] == {}
    mem = rec["memory"]
    assert mem["peak_device_bytes"] >= mem["argument_bytes"] + \
        mem["output_bytes"] + mem["state_bytes"]
    kernels = rec["census"]["kernels"]
    if family == "lm":
        L = bundle.cfg.n_layers
        # forward and remat recompute, one backward, a layer
        assert kernels["flash_attention"]["calls"] == 2 * L
        assert kernels["flash_attention_bwd"]["calls"] == L
        assert rec["census"]["flops"] > rec["meta"]["model_flops"] / 2
    elif family == "engine":
        assert {k: v["calls"] for k, v in kernels.items()} == {
            "msbfs_step": 1, "expand_level": 1}
        assert mem["state_bytes"] == 4096 * 4          # visited words
    else:
        assert kernels == {} and rec["census"]["flops"] > 0
    json.dumps(rec)                                    # one JSON record


@pytest.mark.parametrize("name", ["pod", "multipod"])
def test_dryrun_refuses_production_meshes(name):
    # the next slices: the sharded train step and the GNN / recsys splits
    want = "sharded train step.*GNN and recsys.*meta"
    with pytest.raises(NotImplementedError, match=want):
        dryrun.dryrun_cell("path-engine", "batch_1b", name)
    with pytest.raises(NotImplementedError, match=want):
        dryrun.main(["--all", "--mesh", name])


def test_dryrun_cli_and_roofline(tmp_path, capsys):
    out = tmp_path / "dryrun"
    assert dryrun.main(["--arch", "two-tower-retrieval", "--shape",
                        "serve_p99", "--out", str(out)]) == 0
    rec = json.loads(
        (out / "two-tower-retrieval__serve_p99__host.json").read_text())
    assert rec["ok"] and rec["census"]["aten_ops"] > 0
    assert roofline.main(["--dryrun-dir", str(out), "--out",
                          str(tmp_path / "roofline.json")]) == 0
    rows = json.loads((tmp_path / "roofline.json").read_text())
    assert [r["shape"] for r in rows] == ["serve_p99"]
    assert "two-tower-retrieval" in capsys.readouterr().out


def _record(flops, kernel_ops, nbytes, coll, peak):
    return {"arch": "a", "shape": "s", "mesh": "host", "n_devices": 1,
            "meta": {"family": "engine", "model_flops": 1e12,
                     "weight_bytes": 0},
            "census": {"flops": flops, "kernel_ops": kernel_ops,
                       "bytes_accessed": nbytes,
                       "collectives": {"c10d.all_reduce": {
                           "calls": 1, "bytes": coll}} if coll else {}},
            "memory": {"peak_device_bytes": peak}}


def test_roofline_terms_and_verdicts():
    hw = roofline.HW
    r = roofline.analyze_cell(_record(989e12, 989e12, 3.35e12, 0, 10e9),
                              hbm_cap=80e9)
    assert r["compute_s"] == pytest.approx(2.0)
    assert r["memory_s"] == pytest.approx(1.0)
    assert r["collective_s"] == 0.0 and r["dominant"] == "compute"
    assert r["bound_fraction"] == pytest.approx(2 / 3, abs=1e-4)
    assert r["useful_ratio"] == round(1e12 / (2 * 989e12), 4)
    assert r["fits_hbm"] and r["roofline_step_s"] == pytest.approx(2.0)
    r = roofline.analyze_cell(_record(0, 0, 1e9, 3 * hw["link_bw"], 90e9),
                              hbm_cap=80e9)
    assert r["dominant"] == "collective" and not r["fits_hbm"]
    assert r["collective_s"] == pytest.approx(3.0)
    r = roofline.analyze_cell(_record(1e9, 0, 2 * hw["hbm_bw"], 0, 1),
                              hbm_cap=80e9)
    assert r["dominant"] == "memory" and r["memory_s"] == pytest.approx(2.0)


@pytest.mark.parametrize("arch", ["graphcast", "meshgraphnet"])
def test_roofline_gnn_traffic_reads_the_hidden_width(arch):
    from repro_torch import configs
    mod = configs.get(arch)
    shape = sorted(mod.SHAPES)[0]
    meta = build_bundle(arch, shape).meta
    assert meta["d_hidden"] == mod.CONFIG.d_hidden
    want = meta["n_layers"] * (meta["edges"] + meta["nodes"]) \
        * mod.CONFIG.d_hidden * 4 * 6
    assert roofline._analytic_hbm(meta) == want
