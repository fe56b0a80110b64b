#!/usr/bin/env python3
"""Time ``flash_attention``'s forward routes in the checkout it is run from.

    python3 probes/attention_forward_ab.py NAME        # one card

Imports ``repro_torch`` from ``./src`` of the current directory, so that
two trees can be compared on one card in one call: unpack both with
``git archive``, run this file from each root in turns (parent, change,
change, parent). The shapes (``ATTN_SHAPES``), the seeded inputs
(``attention_inputs``) and the timing (``graph_ms``: 50 launches captured
in one CUDA graph, replayed between CUDA events, median of 5) are
``chip_smoke.py``'s, from the checkout this file lies in, so that the
numbers are its kernels row's ``device_ms``. The output is never compared
here; ``--check`` holds it to the plain version at the kernels row's bf16
tolerance first.
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def main() -> int:
    name = sys.argv[1] if len(sys.argv) > 1 else os.path.basename(os.getcwd())
    check = "--check" in sys.argv
    import torch
    if not torch.cuda.is_available():
        print("attention_forward_ab: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.getcwd(), "src"))
    from repro_torch.kernels.flash_attention import ops as fops
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {"name": name, "root": os.getcwd(), "nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
        .stdout.strip(), "device_ms": {}}
    for label, B, Sq, Skv, Hq, Hkv, hd, q_offset, valid in \
            chip_smoke.ATTN_SHAPES:
        q, k, v = chip_smoke.attention_inputs(torch, gen, B, Sq, Skv, Hq,
                                              Hkv, hd, valid)
        kw = {"q_offset": q_offset, "kv_valid_len": valid}
        if check:
            chip_smoke.check_bf16_attention(
                torch, fops.flash_attention_cuda(q, k, v, True, **kw),
                fops.flash_attention_ref(q, k, v, True, **kw), label)
        out["device_ms"][label] = chip_smoke.graph_ms(
            torch, lambda: fops.flash_attention_cuda(q, k, v, True, **kw))
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
