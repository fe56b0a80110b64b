"""Findings + waivers container shared by both analyzer layers.

A copy of ``repro/analysis/report.py``: the same :class:`Finding` and
:class:`AnalysisReport`, the same text and JSON. One :class:`Finding` is
one violation of a named rule at a source location (AST lint) or in a
measured hot function (launch audit). A finding can be *waived* by an
in-line ``# repro-lint: waive[RULE] reason`` comment (layer 1); waived
findings stay in the report -- every exception is documented, none is
silent -- but do not fail the run.

The CLI (``python -m repro_torch.analysis``) consumes the same
:class:`AnalysisReport`: exit nonzero iff ``report.violations`` is
non-empty.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Optional

__all__ = ["Finding", "AnalysisReport"]


@dataclasses.dataclass
class Finding:
    rule: str                     # "RPL001" ... or an audit check id
    path: str                     # file (lint) or hot-fn "name[arm]" (audit)
    line: int                     # 1-based source line; 0 for audit findings
    message: str
    waived: bool = False
    waiver_reason: Optional[str] = None

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}" if self.line else self.path

    def render(self) -> str:
        tag = f"waived: {self.waiver_reason}" if self.waived else "VIOLATION"
        return f"{self.location}: {self.rule} [{tag}] {self.message}"


@dataclasses.dataclass
class AnalysisReport:
    findings: list[Finding] = dataclasses.field(default_factory=list)
    n_files: int = 0              # lint: files scanned
    n_functions: int = 0          # audit: hot functions traced
    meta: dict = dataclasses.field(default_factory=dict)

    def extend(self, other: "AnalysisReport") -> "AnalysisReport":
        self.findings.extend(other.findings)
        self.n_files += other.n_files
        self.n_functions += other.n_functions
        self.meta.update(other.meta)
        return self

    @property
    def violations(self) -> list[Finding]:
        return [f for f in self.findings if not f.waived]

    @property
    def waived(self) -> list[Finding]:
        return [f for f in self.findings if f.waived]

    @property
    def ok(self) -> bool:
        return not self.violations

    def add(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def render(self) -> str:
        lines = [f.render() for f in sorted(
            self.findings, key=lambda f: (f.path, f.line, f.rule))]
        lines.append(
            f"{len(self.violations)} violation(s), {len(self.waived)} "
            f"waived, {self.n_files} file(s) linted, "
            f"{self.n_functions} hot function(s) audited")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({
            "ok": self.ok,
            "n_files": self.n_files,
            "n_functions": self.n_functions,
            "meta": self.meta,
            "findings": [dataclasses.asdict(f) for f in self.findings],
        }, indent=1)
