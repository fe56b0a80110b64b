"""Dry run: trace every (architecture x input shape) once on ``meta``
tensors and record its memory, FLOPs and op census for the roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch path-engine \\
        --shape batch_1b --mesh host
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh host \\
        --out build/dryrun

The counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
each cell for a 256- or 512-chip TPU mesh and reads XLA's memory and cost
analyses. Here a cell's step bundle (``launch/steps.py``) gets parameters
and inputs on ``meta`` (random inits draw nothing there) and runs one
step under ``launch/op_analysis.py``'s census; the hand-written kernels
run their meta versions (``kernels/registry.py``), so nothing is
computed or launched and no device is needed. One JSON record per cell
(``<arch>__<shape>__<mesh>.json``): argument, output and temporary bytes
and the peak of live bytes, the census (ATen ops, kernel calls with their
analytic operations and bytes, matmul FLOPs, collectives), ``t_trace_s``
and the bundle's analytic ``meta``.

Only the ``host`` layout (one device) runs. ``pod`` and ``multipod``
raise ``NotImplementedError``: a cell there traces the sharded train
step (FSDP gradients) and the GNN and recsys parameter splits, which
the port does not have yet (the LM serving splits it has), and the
per-slot memory on ``meta``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from .. import configs as config_registry
from ..config import RunOptions
from ..models import gnn, recsys, transformer
from ..optim import adamw_init
from .mesh import mesh_by_name
from .op_analysis import analyze_step
from .steps import StepBundle, build_bundle, gnn_dims

__all__ = ["dryrun_cell", "step_args", "CELL_OPTS", "main"]

META = torch.device("meta")

# per-cell launch options (the JAX dry run's memory plans)
CELL_OPTS: dict[tuple, dict] = {
    ("qwen1.5-110b", "train_4k"): {"grad_accum": 4},
    ("qwen2.5-14b", "train_4k"): {"grad_accum": 2},
    ("moonshot-v1-16b-a3b", "train_4k"): {"grad_accum": 2},
    ("olmoe-1b-7b", "train_4k"): {"grad_accum": 2},
}


def _empty(spec: tuple) -> torch.Tensor:
    shape, dtype = spec
    return torch.empty(shape, dtype=dtype, device=META)


def step_args(bundle: StepBundle) -> tuple:
    """The step's positional arguments on ``meta``: parameters (and the
    AdamW state of a train step) and the inputs at the bundle's shapes.
    A decode step's cache is full up to its last position; the engine's
    superstep has its frontier buffer and visited words made
    (``EngineSuperstep.prime``), as every superstep but the first."""
    cfg, gen = bundle.cfg, torch.Generator()
    fam = bundle.meta["family"]
    if fam == "engine":     # a superstep past the first: its state made
        x = {name: _empty(spec) for name, spec in bundle.inputs.items()}
        frontier, dist = bundle.step_fn.prime(x["frontier"], x["dist"])
        return (x["ell_idx"], frontier, dist, 1, x["pruned_ell"],
                x["prune_tbl"], x["paths"], x["count"])
    if fam == "lm":
        B, S = bundle.dims["global_batch"], bundle.dims["seq_len"]
        if bundle.kind == "train":
            params = transformer.train_params(cfg, generator=gen,
                                              device=META)
            tokens = torch.empty((B, S), dtype=torch.long, device=META)
            return params, adamw_init(params), tokens, torch.empty_like(
                tokens)
        model = transformer.LM(cfg, generator=gen, opts=bundle.opts,
                               device=META)
        if bundle.kind == "prefill":
            return model, torch.empty((B, S), dtype=torch.long, device=META)
        cache = model.init_cache(B, S)
        cache["pos"] = S - 1
        return model, torch.empty((B, 1), dtype=torch.long, device=META), \
            cache
    batch = {name: _empty(spec) for name, spec in bundle.inputs.items()}
    if fam == "gnn":
        params = gnn.init_gnn_params(cfg, *gnn_dims(cfg, bundle.spec),
                                     generator=gen, device=META)
    else:
        params = recsys.init_recsys_params(cfg, generator=gen, device=META)
    if bundle.kind in ("recsys_serve", "recsys_retrieval"):
        return (params, *batch.values())
    return params, adamw_init(params), batch


def dryrun_cell(arch: str, shape: str, mesh_name: str = "host",
                opts: RunOptions | None = None, *, reduced: bool = False,
                overrides: dict | None = None) -> dict:
    """Trace one cell on ``meta``; returns its record."""
    layout = mesh_by_name(mesh_name)
    if mesh_name != "host":
        raise NotImplementedError(
            f"the dry run on {mesh_name!r} ({layout.size} devices) needs "
            f"the sharded train step (FSDP gradients) and the GNN and "
            f"recsys parameter splits, the next slices of the sharded model "
            f"code, then per-slot memory on meta (ROADMAP.md queue 1, "
            f"item 7)")
    if opts is None:
        opts = RunOptions(**CELL_OPTS.get((arch, shape), {}))
    t0 = time.perf_counter()
    bundle = build_bundle(arch, shape, opts, reduced=reduced,
                          overrides=overrides)
    args = step_args(bundle)
    t_build = time.perf_counter() - t0
    held = (bundle.step_fn.visited,) if bundle.kind == "engine_batch" \
        else ()
    census, _ = analyze_step(bundle.step_fn, args, held)
    mem = dict(census.pop("memory"))
    mem["peak_device_bytes"] = mem["peak_live_bytes"]
    return {"arch": arch, "shape": shape, "mesh": mesh_name,
            "n_devices": layout.size, "reduced": reduced,
            "overrides": overrides or {}, "opts": dataclasses.asdict(opts),
            "t_build_s": t_build, "t_trace_s": census.pop("t_trace_s"),
            "memory": mem, "census": census, "meta": bundle.meta,
            "ok": True}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "pod", "multipod"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    if args.mesh != "host":
        dryrun_cell("path-engine", "batch_1b", args.mesh)   # raises
    cells: list[tuple[str, str]] = []
    if args.all:
        for arch in config_registry.ARCHS:
            for shape in config_registry.shapes_for(arch):
                cells.append((arch, shape))
    elif args.arch and args.shape:
        cells.append((args.arch, args.shape))
    else:
        ap.error("--arch and --shape, or --all")
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    n_fail = 0
    for arch, shape in cells:
        tag = f"{arch}__{shape}__{args.mesh}"
        try:
            rec = dryrun_cell(arch, shape, args.mesh)
            print(f"[OK]   {tag}: trace {rec['t_trace_s']:.2f}s, peak "
                  f"{rec['memory']['peak_device_bytes'] / 2**30:.2f} GiB, "
                  f"flops {rec['census']['flops']:.3g}, "
                  f"ops {rec['census']['ops']}", flush=True)
        except Exception as e:  # noqa: BLE001 -- recorded, and fails the run
            rec = {"arch": arch, "shape": shape, "mesh": args.mesh,
                   "ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            n_fail += 1
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
        (outdir / f"{tag}.json").write_text(
            json.dumps(rec, indent=1, default=str))
    print(f"\n{len(cells) - n_fail}/{len(cells)} cells traced")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
