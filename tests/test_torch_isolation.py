"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor ``repro``, and the entry points (the engine, the
session, the streaming server and its CLI, the model, training and its
CLI) never run on the CPU unless asked to."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    return sorted(".".join(("repro_torch",) + p.relative_to(PKG)
                           .with_suffix("").parts).removesuffix(".__init__")
                  for p in PKG.rglob("*.py"))


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


def test_every_kernel_module_imports_without_nvcc():
    import importlib
    for name in ("msbfs_expand", "pairwise_popcount", "path_join",
                 "ell_spmm", "flash_attention"):
        importlib.import_module(f"repro_torch.kernels.{name}.ops")
    from repro_torch.kernels import build
    assert not any(build.BUILD_DIR.glob("*.tmp"))


def test_entry_points_need_cuda_unless_asked_for_cpu():
    from repro_torch.core import (BatchPathEngine, EngineConfig,
                                  PathSession, generators)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    g = generators.grid(4)
    cfg = EngineConfig(plan_caps=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchPathEngine(g, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PathSession(g, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchPathEngine(g, cfg, device="cuda")
    assert BatchPathEngine(g, cfg, device="cpu").device.type == "cpu"


def test_streaming_needs_cuda_unless_asked_for_cpu():
    from repro_torch.core import (BatchPathEngine, EngineConfig,
                                  PathSession, generators)
    from repro_torch.launch.serve import StreamingServer
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    g = generators.grid(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingServer(BatchPathEngine(g, EngineConfig()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PathSession(g, n_groups=1).submit((0, 5, 3))
    srv = StreamingServer(BatchPathEngine(g, EngineConfig(), device="cpu"))
    qid = srv.submit((0, 5, 3))
    srv.drain()
    assert srv.results[qid].ok


def test_serve_cli_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = [sys.executable, "-m", "repro_torch.launch.serve", "--n", "400",
            "--queries", "4", "--k-min", "3", "--k-max", "3",
            "--validate", "1"]
    out = subprocess.run(args, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
    out = subprocess.run(args + ["--devices", "2", "--device", "cpu"],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and "ValueError: n_devices=2 but only 1 " \
        "local cpu devices are visible" in out.stderr
    out = subprocess.run(args + ["--device", "cpu"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "on cpu (torch kernels)" in out.stdout and "OK" in out.stdout


def test_the_model_needs_cuda_unless_asked_for_cpu():
    from repro_torch.configs import get
    from repro_torch.models.transformer import LM, init_cache
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = get("granite-8b").REDUCED
    gen = torch.Generator().manual_seed(0)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LM(cfg, generator=gen, **kw)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_cache(cfg, 1, 8, **kw)
    assert LM(cfg, generator=gen, device="cpu").embed.device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = ROOT / "chip_smoke.py"
    for cwd, path in ((ROOT, script), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:          # alone in a directory, no repo around
            path.write_text(script.read_text())
        out = subprocess.run([sys.executable, str(path)], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_train_cli_needs_cuda_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.checkpoint import latest_step
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "olmoe-1b-7b", "--reduced", "--steps", "2", "--seq-len", "16",
            "--batch", "2", "--ckpt-dir", str(tmp_path / "c")]
    out = subprocess.run(args, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
    assert not (tmp_path / "c").exists()
    out = subprocess.run(args + ["--device", "cpu"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("steps: 2; loss ")
    assert latest_step(tmp_path / "c") == 1


def test_training_needs_cuda_unless_asked_for_cpu(tmp_path):
    from repro_torch.configs import get
    from repro_torch.launch.train import run_training
    from repro_torch.models.transformer import train_params
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = get("olmoe-1b-7b").REDUCED
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_params(cfg, generator=gen)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_training("olmoe-1b-7b", "train_4k", 1, tmp_path / "c",
                     overrides={"seq_len": 8, "global_batch": 2})
    assert not (tmp_path / "c").exists()
    assert train_params(cfg, generator=gen, device="cpu")["embed"] \
        .device.type == "cpu"
