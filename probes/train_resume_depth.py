#!/usr/bin/env python3
"""Phase ``train``'s crash, resume and repeated-batch check at a given depth.

    python3 probes/train_resume_depth.py [--layers 2]   # from a checkout

Needs one CUDA card. granite-8b at full width cut to ``--layers`` layers,
with ``chip_smoke.py``'s train batch, steps, checkpoint interval and
options: the uninterrupted steps (``chip_smoke.run_steps``), then a
``TrainDriver`` run that checkpoints after two steps and crashes at the
third and a resume from that checkpoint (``chip_smoke.run_driver``). It
reports whether the resumed history equals the uninterrupted one and
whether the resumed parameters and AdamW state equal the uninterrupted
run's bit for bit (``chip_smoke.same_bits``), then runs phase train's
check (b) (``TRAIN_REPEATS`` more steps on batch 0, the schedule
continued, and the loss after them) from the resumed state and from the
uninterrupted state, and prints both loss lists. Equal lists from equal
states put a rise in the check on the model at that depth, not on the
restore. Prints one JSON object.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402


def repeated_batch(torch, bundle, params, opt, batch_fn) -> list:
    """Check (b)'s losses: each repeated step's, then the loss after."""
    from repro_torch.models import transformer
    tok, tgt = batch_fn(0)
    losses = []
    for _ in range(chip_smoke.TRAIN_REPEATS):
        params, opt, m = bundle.step_fn(params, opt, tok, tgt)
        losses.append(float(m["loss"]))
    with torch.no_grad():
        losses.append(float(transformer.lm_loss(params, tok, tgt,
                                                bundle.cfg, bundle.opts)))
    return losses


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_resume_depth: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.config import RunOptions
    from repro_torch.kernels import build
    build.build(["flash_attention", "flash_attention_bwd"])
    torch.backends.cuda.matmul.allow_tf32 = False
    opts = RunOptions(remat=True, seq_parallel=False)
    bundle = chip_smoke.train_bundle(chip_smoke.TRAIN_ARCH, args.layers,
                                     opts)
    params, opt, history, walls, mem, batch_fn = chip_smoke.run_steps(
        torch, bundle)
    crash_dir = os.path.join(ROOT, "build", "probe_train_resume")
    shutil.rmtree(crash_dir, ignore_errors=True)
    first, _, err = chip_smoke.run_driver(
        torch, bundle, crash_dir, chip_smoke.TRAIN_STEPS,
        fail_at=chip_smoke.TRAIN_CKPT_EVERY)
    crashed = first is None and err is not None and "injected" in err
    resumed, _, err = chip_smoke.run_driver(torch, bundle, crash_dir,
                                            chip_smoke.TRAIN_STEPS)
    shutil.rmtree(crash_dir, ignore_errors=True)
    out = {"arch": chip_smoke.TRAIN_ARCH, "layers": args.layers,
           "tokens": [chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ],
           "history": history, "step_wall_s": walls,
           **mem, "crashed": crashed,
           "resume_error": err}
    if resumed is not None:
        out["resumed_history"] = resumed["history"]
        out["history_equal"] = \
            resumed["history"] == history[chip_smoke.TRAIN_CKPT_EVERY:]
        out["params_equal_bitwise"] = chip_smoke.same_bits(
            torch, resumed["params"], params)
        out["opt_state_equal_bitwise"] = chip_smoke.same_bits(
            torch, resumed["opt_state"], opt)
        out["repeated_from_resumed"] = repeated_batch(
            torch, bundle, resumed["params"], resumed["opt_state"],
            batch_fn)
        del resumed
        gc.collect()
    out["repeated_from_uninterrupted"] = repeated_batch(
        torch, bundle, params, opt, batch_fn)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
