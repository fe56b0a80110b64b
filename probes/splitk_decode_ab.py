#!/usr/bin/env python3
"""Time the decode attention routes (``attn_splitk``, ``attn_splitk_f8``)
in the checkout it is run from.

    python3 probes/splitk_decode_ab.py NAME [--check]      # one card

Imports ``repro_torch`` from ``./src`` of the current directory, so that
two trees can be compared on one card in one call: unpack both with
``git archive``, run this file from each root in turns (parent, change,
change, parent). The shapes are ``chip_smoke.py``'s row 8' shapes
(``ATTN_F8_SHAPES``: granite-8b's decode over 544 and 32,768 keys,
moonshot's over 160) and qwen2.5-14b's G 5 over 544 keys, on a float8
cache quantised from seeded normals (layer 1 of a two-layer cache, NaN
past the valid length) and on its bf16 copy. For each: the float8
route's and the bf16 route's ``device_ms`` (``chip_smoke.graph_ms``: 50
launches in one CUDA graph, median of 5 replays), SDPA's on the bf16
copy, and each kernel's device time by the profiler over 20 launches
(the split kernel and the merge apart). It prints one JSON line.
``--check`` first holds the float8 route to its plain version at the
kernels row's bf16 tolerance and to the bf16 route bit for bit.
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

SHAPES = chip_smoke.ATTN_F8_SHAPES + (
    ("decode_g5", 4, 1, 544, 40, 8, 128, 543, 544),)


def kernel_us(torch, fn, calls: int = 20) -> dict:
    """Device microseconds a call of each CUDA kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t > 0 and ev.count >= calls:
            out[ev.key[:60]] = t / calls
    return out


def main() -> int:
    name = sys.argv[1] if len(sys.argv) > 1 else os.path.basename(os.getcwd())
    check = "--check" in sys.argv
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("splitk_decode_ab: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.getcwd(), "src"))
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models.transformer import quantize_f8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(8)
    out = {"name": name, "root": os.getcwd(), "nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
        .stdout.strip(), "shapes": {}}
    for label, B, Sq, Skv, Hq, Hkv, hd, q_offset, valid in SHAPES:
        q = torch.randn((B, Sq, Hq, hd), generator=gen, device="cuda") \
            .bfloat16()
        cache = [quantize_f8(torch.randn((2, B, Skv, Hkv, hd),
                                         generator=gen, device="cuda"))
                 for _ in range(2)]
        nan = quantize_f8(torch.full((1,), float("nan"), device="cuda"))
        for c in cache:
            c[:, :, valid:] = nan
        k, v = cache[0][1], cache[1][1]
        kb, vb = k.bfloat16(), v.bfloat16()
        kw = {"q_offset": q_offset, "kv_valid_len": valid}

        def f8():
            return fops.flash_attention_cuda(q, k, v, True, **kw)

        def bf16():
            return fops.flash_attention_cuda(q, kb, vb, True, **kw)

        qt, kt, vt = (q.transpose(1, 2), kb[:, :valid].transpose(1, 2),
                      vb[:, :valid].transpose(1, 2))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  enable_gqa=True)

        rec = {"plan": list(fops.attention_plan(q, k, v, True, **kw,
                                                 sms=sms))}
        if check:
            got = f8()
            chip_smoke.check_bf16_attention(
                torch, got, fops.flash_attention_ref(q, k, v, True, **kw),
                label)
            chip_smoke.require(
                torch.equal(got.view(torch.int16), bf16().view(torch.int16)),
                f"{label}: the float8 route differs from the bf16 route")
        rec.update(f8_device_ms=chip_smoke.graph_ms(torch, f8),
                   bf16_device_ms=chip_smoke.graph_ms(torch, bf16),
                   sdpa_device_ms=chip_smoke.graph_ms(torch, sdpa),
                   f8_kernels_us=kernel_us(torch, f8),
                   bf16_kernels_us=kernel_us(torch, bf16))
        out["shapes"][label] = rec
        del q, k, v, kb, vb, cache, qt, kt, vt
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
