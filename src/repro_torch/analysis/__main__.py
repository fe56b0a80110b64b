"""CLI entry point: ``python -m repro_torch.analysis``.

Modes (default ``--all``):
  --lint            layer 1 only (AST lint; imports nothing it lints)
  --audit           layer 2 only (launch audit, on the CUDA arm where there
                    is a card, else on the plain arm)
  --all             both layers, one merged report
  --write-budgets   measure the manifest on this machine's arm and rewrite
                    the committed LAUNCH_BUDGETS.json (the other arm's
                    entries are kept), then exit 0

Exit status: 0 iff no unwaived finding.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

_COMMENT = ("Committed per-arm dispatch budgets of the hot-function "
            "manifest (repro_torch/analysis/launch_audit.py): the plain "
            "arm's aten ops and host syncs (written on the CPU), the CUDA "
            "arm's device launches, copies to the host and the port's "
            "kernels by name (written on a card); _written says where. "
            "Regenerate each arm with `python -m repro_torch.analysis "
            "--write-budgets` where it runs, and justify any increase.")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--all", action="store_true",
                      help="run both layers (default)")
    mode.add_argument("--lint", action="store_true",
                      help="layer 1 AST lint only")
    mode.add_argument("--audit", action="store_true",
                      help="layer 2 launch audit only")
    mode.add_argument("--write-budgets", action="store_true",
                      help="measure and rewrite the launch-budget baseline")
    ap.add_argument("--root", type=Path, default=None,
                    help="source tree to lint (default: the repro_torch "
                         "package)")
    ap.add_argument("--budgets", type=Path, default=None,
                    help="LAUNCH_BUDGETS.json path (default: the one in "
                         "the repro_torch.analysis package)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of text")
    args = ap.parse_args(argv)

    if args.write_budgets:
        import torch

        from .launch_audit import (DEFAULT_BUDGETS_PATH, default_arm,
                                   load_budgets, measure_budgets,
                                   merge_budgets)
        path = args.budgets or DEFAULT_BUDGETS_PATH
        base = load_budgets(path) or load_budgets() or {}
        arm = default_arm()
        budgets = merge_budgets(base, measure_budgets((arm,)))
        budgets["_comment"] = _COMMENT
        where = torch.cuda.get_device_name(0) if arm == "cuda" else "CPU"
        budgets["_written"] = dict(base.get("_written", {}), **{
            arm: f"{where}, torch {torch.__version__.split('+')[0]}"})
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(budgets, indent=1, sort_keys=True) + "\n")
        print(f"wrote {path}")
        return 0

    if args.lint:
        from .astlint import lint_tree
        root = args.root or Path(__file__).resolve().parents[1]
        report = lint_tree(root)
    elif args.audit:
        from .launch_audit import run_audit
        report = run_audit(args.budgets)
    else:
        from . import run_all
        report = run_all(args.root, args.budgets)

    print(report.to_json() if args.json else report.render())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
