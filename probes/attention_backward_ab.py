#!/usr/bin/env python3
"""Time the attention backward and the LM train steps in the checkout it
is run from.

    python3 probes/attention_backward_ab.py NAME        # one card

Imports ``repro_torch`` from ``./src`` of the current directory, so that
two trees can be compared on one card in one call: unpack both with
``git archive``, run this file from each root in turns (parent, change,
change, parent). From ``chip_smoke.py`` (of the checkout this file lies
in) it takes phase ``train``'s shapes and bundles (granite-8b at full
width cut to 4 layers, olmoe-1b-7b cut to 2, both at 2 x 4096 tokens,
remat, float32 masters) and its timing helpers. It prints one JSON line:

* ``bwd``: ``flash_attention_bwd_cuda`` at the granite-8b step's
  attention shape (B 2, S 4096, Hq 32, Hkv 8, hd 128, causal, bf16, the
  seed of phase ``train``'s check (a)): the route the checkout takes, its
  ``device_ms`` (10 launches in one CUDA graph), the device time of each
  of its kernels under a card-only profiler, and SDPA's backward on the
  same inputs (CUDA events, median of 5; and its kernels' device time);
* ``granite`` and ``olmoe``: the wall of each train step (host clock
  around a step that ends in a device sync), the first one cold;
* ``sass``: per kernel of the built ``flash_attention_bwd`` library that
  issues any, its count of ``HGMMA`` (wgmma), ``UTMALDG`` (TMA tile
  loads) and ``UBLKCP`` (bulk copies) instructions (``cuobjdump -sass``).

Nothing is checked here: phase ``train`` holds the kernel to its plain
version.
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

GRANITE_STEPS, OLMOE_STEPS = 4, 3


def step_walls(torch, bundle, steps: int) -> list:
    from repro_torch.launch.train import make_init_and_batches
    init_state, batch_fn = make_init_and_batches(bundle, "cuda")
    params, opt = init_state()
    walls = []
    for step in range(steps):
        batch = batch_fn(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = bundle.step_fn(params, opt, *batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    del params, opt, m
    torch.cuda.empty_cache()
    return walls


def kernel_ms(torch, fn, calls: int = 5) -> dict:
    """Device ms per call of each kernel ``fn`` launches (profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if t:
            key = e.key.replace("(anonymous namespace)::", "")
            key = key.replace("void ", "").split("(")[0][:60]
            out[key] = out.get(key, 0.0) + t / calls / 1e3
    return out


SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP")


def sass_counts(path) -> dict:
    """The Hopper instructions of each kernel in the library at ``path``."""
    tool = "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {"error": f"{tool} not found"}
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
        elif cur is not None:
            for op in SASS_OPS:
                if op in line:
                    counts = out.setdefault(cur, dict.fromkeys(SASS_OPS, 0))
                    counts[op] += 1
    return out


def main() -> int:
    name = sys.argv[1] if len(sys.argv) > 1 else os.path.basename(os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("attention_backward_ab: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.getcwd(), "src"))
    from repro_torch.config import RunOptions
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fops
    build.build(["flash_attention", "flash_attention_bwd"])
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"name": name, "root": os.getcwd(), "nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
        .stdout.strip()}

    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, dout = chip_smoke.bwd_inputs(
        torch, gen, chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ, 32, 8, 128,
        torch.bfloat16)
    o, lse = fops.flash_attention_cuda(q, k, v, True, return_lse=True)
    args = (q, k, v, o, lse, dout)
    route = getattr(fops, "bwd_plan", None)
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    sd = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=True, enable_gqa=True)
    g_sd = dout.transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(sd, leaves, g_sd, retain_graph=True)

    out["bwd"] = {
        "route": route(*args[:4], dout) if route else "mma",
        "device_ms": chip_smoke.graph_ms(
            torch, lambda: fops.flash_attention_bwd_cuda(*args), n=10),
        "kernels_ms": kernel_ms(
            torch, lambda: fops.flash_attention_bwd_cuda(*args)),
        "sdpa_bwd_ms": chip_smoke.cuda_ms(torch, sdpa_bwd, reps=5),
        "sdpa_bwd_kernels_ms": kernel_ms(torch, sdpa_bwd)}
    del q, k, v, dout, o, lse, args, leaves, sd, g_sd
    torch.cuda.empty_cache()

    opts = RunOptions(remat=True, seq_parallel=False)
    out["granite"] = step_walls(torch, chip_smoke.train_bundle(
        chip_smoke.TRAIN_ARCH, chip_smoke.TRAIN_LAYERS, opts), GRANITE_STEPS)
    mopts = RunOptions(remat=True, seq_parallel=False, moe_groups=4)
    out["olmoe"] = step_walls(torch, chip_smoke.train_bundle(
        chip_smoke.MOE_ARCH, chip_smoke.MOE_TRAIN_LAYERS, mopts), OLMOE_STEPS)
    out["sass"] = sass_counts(build.library_path("flash_attention_bwd"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
