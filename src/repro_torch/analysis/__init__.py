"""Two-layer static analysis of the port's hot query path.

Counterpart of ``repro/analysis``. Layer 1 (:mod:`.astlint`) lints the
source tree for the hot-path contracts (RPL001-RPL006: host syncs in the
hot modules, kernel arms called outside arm selection, Python loops over
device tensors, raw pow2 shape math, hand-rolled stage timing; RPL003 has
no counterpart, the port having no ``jit``). Layer 2
(:mod:`.launch_audit`) runs the hot-function manifest per kernel arm and
checks what it dispatches: per-level aten ops (the plain arm, on the
CPU) or device launches (the CUDA arm, on a card) and host syncs within
the committed budgets (``LAUNCH_BUDGETS.json`` beside this file), the
int8 bound raising, no compile on a same-shape re-run, and full kernel
coverage.

CLI: ``python -m repro_torch.analysis --all``; exits nonzero iff any
unwaived finding remains.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

from .astlint import lint_source, lint_tree
from .launch_audit import measure_budgets, run_audit
from .report import AnalysisReport, Finding

__all__ = ["AnalysisReport", "Finding", "lint_source", "lint_tree",
           "run_audit", "run_all", "measure_budgets"]


def run_all(root: Optional[Path] = None,
            budgets_path: Optional[Path] = None) -> AnalysisReport:
    """Run both layers over ``root`` (default: the installed
    ``repro_torch`` package tree) and merge into one report."""
    if root is None:
        root = Path(__file__).resolve().parents[1]
    report = lint_tree(Path(root))
    report.extend(run_audit(budgets_path))
    return report
