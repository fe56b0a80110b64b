"""Training driver CLI for any assigned arch: the fault-tolerant loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
        --reduced --steps 200 --ckpt-dir build/train_ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch meshgraphnet \
        --reduced --steps 20 --device cpu

A port of ``repro/launch/train.py``. It runs on the card unless
``--device cpu`` (the kernels' plain versions). ``--reduced`` takes the
arch's small same-family config, cut to a CPU size as the JAX CLI cuts it
(an LM at ``--seq-len`` x ``--batch``; recsys at a batch of
``max(--batch, 8)``; graphsage's ``minibatch_lg`` on a 2,000-node graph);
without it the published config at the shape's full size. One device: a
mesh other than ``host`` is refused, since training over one needs the
sharded train step (FSDP gradient reduce-scatters, the optimizer state
cut as the parameters) and the GNN and recsys parameter splits, the next
slice of the sharded model code (ROADMAP.md queue 1, item 7).
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from .. import configs as config_registry
from ..config import RunOptions
from ..core import generators
from ..data import gnn_data
from ..data.lm_data import TokenStream
from ..data.recsys_data import InteractionStream
from ..ft import DriverConfig, FailureInjector, TrainDriver
from ..kernels import build
from ..kernels.registry import resolve_device
from ..models import gnn, recsys, transformer
from ..optim import adamw_init
from .steps import TRAIN_KINDS, build_bundle, gnn_dims

__all__ = ["run_training", "make_init_and_batches", "DEFAULT_CKPT_DIR"]

# under the checkout's build/ (which git ignores)
DEFAULT_CKPT_DIR = build.BUILD_DIR.parent / "train_ckpt"


def make_init_and_batches(bundle, device, params: Optional[dict] = None):
    """``(init_state, batch_fn)`` of a train bundle: float32 masters
    (copied from ``params``, a tree in the JAX layout, else drawn from a
    generator seeded with ``opts.seed``) and their AdamW state; the
    family's synthetic batch at a step, on ``device``. LM: the token
    stream. GNN: molecules, a sampled block (roots from
    ``default_rng(step)``) or the full graph, padded to the bundle's
    sizes, over ``generators.powerlaw(n_nodes, 4.0, seed)`` as the JAX
    launcher builds it. Recsys: the interaction stream."""
    cfg, opts, fam = bundle.cfg, bundle.opts, bundle.meta["family"]
    dev = resolve_device(device)

    def generator():
        return torch.Generator(device=dev).manual_seed(opts.seed)

    def on_device(b: dict) -> tuple:
        return ({k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in b.items()},)

    if fam == "lm":
        meta = bundle.meta
        stream = TokenStream(cfg.vocab, meta["global_batch"],
                             meta["seq_len"], seed=opts.seed)

        def init_state():
            p = transformer.train_params(
                cfg, params, generator=None if params is not None
                else generator(), device=dev)
            return p, adamw_init(p)

        def batch_fn(step):
            tok, tgt = stream.batch_at(step)
            return (torch.from_numpy(tok).to(dev, torch.long),
                    torch.from_numpy(tgt).to(dev, torch.long))

        return init_state, batch_fn

    dims = bundle.dims
    if fam == "recsys":
        stream = InteractionStream(cfg, dims["batch"], seed=opts.seed)

        def init_state():
            p = (recsys.recsys_params_from_jax(params, cfg, device=dev)
                 if params is not None else
                 recsys.init_recsys_params(cfg, generator=generator(),
                                           device=dev))
            return p, adamw_init(p)

        return init_state, lambda step: on_device(stream.batch_at(step))

    d_in, d_out = gnn_dims(cfg, bundle.spec)
    n_pad = bundle.inputs["nodes"][0][0]
    e_pad = bundle.inputs["edge_src"][0][0]
    graph = None if bundle.kind == "gnn_mol" else generators.powerlaw(
        dims.get("n_nodes", 2000), 4.0, seed=opts.seed)

    def init_state():
        p = (gnn.gnn_params_from_jax(params, cfg, device=dev)
             if params is not None else
             gnn.init_gnn_params(cfg, d_in, d_out, generator=generator(),
                                 device=dev))
        return p, adamw_init(p)

    def batch_fn(step):
        if bundle.kind == "gnn_mol":
            b = gnn_data.molecule_batch(cfg, dims["batch"], dims["n_nodes"],
                                        dims["n_edges"], d_in, d_out,
                                        seed=step)
        elif bundle.kind == "gnn_mini":
            roots = np.random.default_rng(step).integers(
                0, graph.n, dims["batch_nodes"])
            b = gnn_data.sampled_batch(cfg, graph, roots, dims["fanout"],
                                       d_in, d_out, seed=step, n_pad=n_pad,
                                       e_pad=e_pad)
        else:
            b = gnn_data.flat_batch(cfg, bundle.spec, graph, d_in, d_out,
                                    seed=step, n_pad=n_pad, e_pad=e_pad)
        return on_device(b)

    return init_state, batch_fn


def run_training(arch: str, shape_name: str, steps: int,
                 ckpt_dir=DEFAULT_CKPT_DIR, reduced: bool = True,
                 mesh_name: str = "host", overrides: dict | None = None,
                 fail_at: int | None = None, ckpt_every: int = 50,
                 opts: RunOptions | None = None, device=None,
                 params: Optional[dict] = None) -> dict:
    """Train ``arch`` for ``steps`` steps through :class:`TrainDriver`
    (resuming from ``ckpt_dir``'s latest checkpoint), on ``device``
    (default ``"cuda"``). ``params``: starting weights in the JAX layout
    (default: random from ``opts.seed``). ``opts`` reaches the step
    bundle whole, its ``remat_policy`` (``"nothing"`` or ``"dots"``)
    included. Returns the driver's result: params, opt_state, history,
    stragglers."""
    if mesh_name != "host":
        raise NotImplementedError(
            f"mesh {mesh_name!r}: training over a mesh needs the sharded "
            f"train step (FSDP gradient reduce-scatters, the optimizer state "
            f"cut as the parameters) and the GNN and recsys parameter "
            f"splits, the next slice of the sharded model code (ROADMAP.md "
            f"queue 1, item 7); the port trains on one device")
    dev = resolve_device(device)
    opts = opts or RunOptions(seq_parallel=False, loss_chunk=64,
                              attn_chunk=256, moe_groups=4)
    bundle = build_bundle(arch, shape_name, opts, reduced=reduced,
                          overrides=overrides)
    if bundle.kind not in TRAIN_KINDS:
        raise ValueError(f"{shape_name!r} is a {bundle.kind} shape, not a "
                         f"train shape")
    init_state, batch_fn = make_init_and_batches(bundle, dev, params)
    driver = TrainDriver(
        DriverConfig(total_steps=steps, ckpt_dir=str(ckpt_dir),
                     ckpt_every=ckpt_every),
        bundle.step_fn, init_state, batch_fn,
        injector=FailureInjector(fail_at))
    return driver.run()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="host")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    mod = config_registry.get(args.arch)
    shape = args.shape or list(mod.SHAPES)[0]
    over = None
    if mod.FAMILY == "lm" and args.reduced:
        over = {"seq_len": args.seq_len, "global_batch": args.batch}
    elif mod.FAMILY == "recsys" and args.reduced:
        over = {"batch": max(args.batch, 8)}  # full shape is 65k; CPU-size it
    elif mod.FAMILY == "gnn" and args.reduced and shape == "minibatch_lg":
        over = {"n_nodes": 2000, "batch_nodes": 16, "fanout": (4, 3),
                "d_feat": 16}
    out = run_training(args.arch, shape, args.steps, args.ckpt_dir,
                       reduced=args.reduced, mesh_name=args.mesh,
                       overrides=over, fail_at=args.fail_at,
                       device=args.device)
    hist = out["history"]
    print(f"steps: {len(hist)}; loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f}; stragglers: {out['stragglers']}")


if __name__ == "__main__":
    main()
