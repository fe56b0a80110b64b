#!/usr/bin/env python3
"""Where a GNN or recsys step's time goes on one GPU.

    python3 probes/gnn_recsys_steps.py      # from the root of a checkout

Needs one CUDA card. For each of ``chip_smoke.py``'s phase ``gnn`` cases
(graphcast and meshgraphnet on ``full_graph_sm``, schnet on ``molecule``,
graphsage-reddit on ``minibatch_lg``, each arch's published ``CONFIG``)
and for two-tower-retrieval's train step (``train_batch`` cut to 32,768),
serve step (``serve_bulk``) and retrieval step (``retrieval_cand``): the
host's batch build, the median of 5 warm steps on the host clock (each
ending in a synchronisation), and one step under ``torch.profiler``
tracing the card only: its device time summed over the kernels, that
time's share of the profiled wall (the device's busy share), the number
of kernels, and the six kernels that take the most time. Prints one JSON
object a case and writes all of them to ``build/gnn_recsys_steps.json``.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

WARM = 5
TOP = 6


def profile_step(torch, fn) -> dict:
    """``fn()`` once under a card-only ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, n = {}, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n += 1
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    device = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"profiled_wall_ms": wall * 1e3, "device_ms": device,
            "busy_share": device / (wall * 1e3), "kernels": n,
            "top_ms": {k[:90]: v for k, v in top}}


def warm_ms(torch, fn) -> float:
    times = []
    for _ in range(WARM):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gnn_recsys_steps: no CUDA device", file=sys.stderr)
        return 2
    root = os.getcwd()
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke as cs
    from repro_torch.configs import get
    from repro_torch.data.recsys_data import InteractionStream
    from repro_torch.launch import steps
    from repro_torch.launch.train import make_init_and_batches
    from repro_torch.models import recsys

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"device": cs.smi("name,power.limit"), "cases": {}}

    def report(name, rec):
        out["cases"][name] = rec
        print(json.dumps({"case": name, **rec}), flush=True)

    for arch, shape in cs.GNN_CASES:
        bundle = steps.build_bundle(arch, shape)
        init_state, batch_fn = make_init_and_batches(bundle, "cuda")
        t0 = time.perf_counter()
        (batch,) = batch_fn(0)
        torch.cuda.synchronize()
        t_batch = time.perf_counter() - t0
        state = list(init_state())

        def step():
            state[0], state[1], _ = bundle.step_fn(state[0], state[1],
                                                   batch)

        step()                                           # cold
        report(f"{arch}:{shape}", {"t_batch_ms": t_batch * 1e3,
                                   "step_ms": warm_ms(torch, step),
                                   "profile": profile_step(torch, step)})
        del state, batch

    cfg = get(cs.RECSYS_ARCH).CONFIG
    params = recsys.init_recsys_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")

    def on_card(b):
        return {k: torch.from_numpy(v).cuda() for k, v in b.items()}

    bundle = steps.build_bundle(cs.RECSYS_ARCH, "serve_bulk")
    b = on_card(InteractionStream(cfg, bundle.dims["batch"],
                                  seed=0).batch_at(0))

    def serve():
        bundle.step_fn(params, b["hist_ids"], b["item_ids"])

    serve()
    report("two-tower:serve_bulk", {"step_ms": warm_ms(torch, serve),
                                    "profile": profile_step(torch, serve)})
    bundle = steps.build_bundle(cs.RECSYS_ARCH, "retrieval_cand")
    (Np,), _ = bundle.inputs["cand_ids"]
    Nc = bundle.dims["n_candidates"]
    cands = torch.full((Np,), -1, dtype=torch.int32, device="cuda")
    cands[:Nc] = torch.arange(Nc, dtype=torch.int32, device="cuda")
    hist = torch.from_numpy(
        InteractionStream(cfg, 1, seed=0).batch_at(0)["hist_ids"]).cuda()

    def retrieve():
        bundle.step_fn(params, hist, cands)

    retrieve()
    report("two-tower:retrieval_cand",
           {"step_ms": warm_ms(torch, retrieve),
            "profile": profile_step(torch, retrieve)})
    del b, cands
    bundle = steps.build_bundle(cs.RECSYS_ARCH, "train_batch",
                                overrides={"batch": cs.RECSYS_TRAIN_BATCH})
    b = on_card(InteractionStream(cfg, cs.RECSYS_TRAIN_BATCH,
                                  seed=0).batch_at(0))
    from repro_torch.optim import adamw_init
    state = [params, adamw_init(params)]
    del params

    def train():
        state[0], state[1], _ = bundle.step_fn(state[0], state[1], b)

    train()
    report(f"two-tower:train_batch@{cs.RECSYS_TRAIN_BATCH}",
           {"step_ms": warm_ms(torch, train),
            "profile": profile_step(torch, train)})
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    with open(os.path.join(root, "build", "gnn_recsys_steps.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(out["device"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
