"""Rule catalog and waiver parsing of the port's static analyzer.

Counterpart of ``repro/analysis/rules.py``: the same waiver syntax and
the same RPL ids, each read in the port's idiom (no ``jit``; kernel arms
picked by ``kernels.registry.resolve_arm``)::

  RPL001  host syncs in the hot modules: ``.item()``, ``.tolist()``,
          ``.cpu()`` / ``.numpy()``, and ``int()`` / ``float()`` /
          ``bool()`` on a tensor
  RPL002  a plain (``*_ref``) or CUDA (``*_cuda``) kernel arm called
          outside a function that picks the arm through ``resolve_arm``
          and outside the arm's own kind
  RPL003  (no counterpart: the port has no ``jit`` and so no
          ``static_argnames``; the id is kept, and never reported)
  RPL004  a Python loop over a device tensor in a hot module
  RPL005  raw pow2 / parity shape math outside ``graph.pow2_ceil``
  RPL006  hand-rolled ``time.perf_counter()`` timing in a timed module
          instead of ``repro_torch.obs.trace`` spans

Waiver syntax (same line, or the line directly above the finding)::

    n = int(count)  # repro-lint: waive[RPL001] one read per level, sizes the next

Multiple rules: ``waive[RPL001,RPL004] reason``. The reason is
mandatory -- a waiver without one is itself a violation (RPL000).
"""
from __future__ import annotations

import io
import re
import tokenize
from fnmatch import fnmatch
from typing import Dict, List, Tuple

__all__ = [
    "RULES", "HOT_MODULE_PATTERNS", "TIMED_MODULE_PATTERNS",
    "UNTIMED_MODULES", "WAIVER_RE", "parse_waivers", "is_hot_module",
    "is_timed_module",
]

RULES: Dict[str, str] = {
    "RPL000": "malformed waiver (missing reason or unknown rule id)",
    "RPL001": "host sync in a hot module (.item(), .tolist(), .cpu(), "
              ".numpy(), int()/float()/bool() on a tensor)",
    "RPL002": "kernel arm called outside arm selection (a *_ref or *_cuda "
              "function called outside a function that picks the arm "
              "through registry.resolve_arm and outside arms of its kind)",
    "RPL003": "no counterpart in the port: it has no jit, so no "
              "static_argnames to declare (the id is kept, never reported)",
    "RPL004": "Python loop over a device tensor in a hot module (one host "
              "sync and one tiny launch per element)",
    "RPL005": "raw pow2/parity shape math (2**x, 1<<x, x%2) outside "
              "graph.pow2_ceil (breaks the stable-shape bucket contract)",
    "RPL006": "hand-rolled time.perf_counter() timing in an engine/serving "
              "module -- stage timing must go through repro_torch.obs.trace "
              "spans so every wall lands in one trace/metrics pipeline",
}

# Modules whose per-level work runs on the device (relative to the lint
# root, i.e. src/repro_torch/): RPL001 and RPL004 apply to every function
# in them (the port has no jit, so there is no reachability to compute).
# The reference's list, plus core/pathset.py, where the engine's one
# readback per level and per join (read_status) lives.
HOT_MODULE_PATTERNS: Tuple[str, ...] = (
    "core/msbfs.py",
    "core/join.py",
    "core/enumerate.py",
    "core/index.py",
    "core/pathset.py",
    "kernels/*.py",
    "kernels/*/*.py",
)

# Modules whose stage timing must go through spans (RPL006): the hot
# modules plus the host-side engine / serving layer that owns the
# per-stage walls. obs/ itself is exempt (it is the definition site).
TIMED_MODULE_PATTERNS: Tuple[str, ...] = HOT_MODULE_PATTERNS + (
    "core/engine.py",
    "core/distributed.py",
    "core/delta.py",
    "core/cache.py",
    "core/planner.py",
    "core/session.py",
    "launch/serve.py",
)

# Off the timed list on purpose, as the reference leaves off ft/driver.py:
# its walls time an external process (nvcc), not a pipeline stage.
UNTIMED_MODULES: Tuple[str, ...] = ("kernels/build.py",)

WAIVER_RE = re.compile(
    r"#\s*repro-lint:\s*waive\[(?P<rules>[A-Z0-9,\s]+)\]\s*(?P<reason>.*)$")


def _rel(relpath: str) -> str:
    return relpath.replace("\\", "/")


def is_hot_module(relpath: str) -> bool:
    """True if ``relpath`` (posix, relative to the lint root) is one of
    the hot modules RPL001/RPL004 apply to."""
    rel = _rel(relpath)
    return any(fnmatch(rel, pat) for pat in HOT_MODULE_PATTERNS)


def is_timed_module(relpath: str) -> bool:
    """True if ``relpath`` must route stage timing through obs spans
    (RPL006). Anything under ``obs/`` is exempt -- the span and metrics
    implementation necessarily reads the clock."""
    rel = _rel(relpath)
    if rel.split("/")[0] == "obs" or rel in UNTIMED_MODULES:
        return False
    return any(fnmatch(rel, pat) for pat in TIMED_MODULE_PATTERNS)


def parse_waivers(source: str) -> Tuple[Dict[int, Tuple[frozenset, str]],
                                        List[Tuple[int, str]]]:
    """Scan ``source`` for waiver comments.

    Returns ``(waivers, malformed)``:
      * ``waivers`` maps *covered* line numbers (the comment's own line
        and, for a comment on a line of its own, the one below it, so a
        waiver can sit above a long call) to ``(rule_ids, reason)``.
      * ``malformed`` lists ``(line, message)`` pairs for waivers with an
        empty reason or an unknown rule id -- surfaced as RPL000.
    """
    waivers: Dict[int, Tuple[frozenset, str]] = {}
    malformed: List[Tuple[int, str]] = []
    # only genuine COMMENT tokens count -- a waiver example quoted in a
    # docstring must not register (or trip RPL000)
    comments: List[Tuple[int, str, bool]] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                code_before = tok.line[:tok.start[1]].strip()
                comments.append((tok.start[0], tok.string,
                                 not code_before))
    except tokenize.TokenError:
        return waivers, malformed
    for lineno, text, own_line in comments:
        m = WAIVER_RE.search(text)
        if not m:
            continue
        rules = frozenset(r.strip() for r in m.group("rules").split(",")
                          if r.strip())
        reason = m.group("reason").strip()
        unknown = sorted(r for r in rules if r not in RULES)
        if unknown:
            malformed.append(
                (lineno, f"unknown rule id(s) {unknown} in waiver"))
            continue
        if not reason:
            malformed.append(
                (lineno, "waiver has no reason — every exception must be "
                         "documented in-line"))
            continue
        waivers[lineno] = (rules, reason)
        if own_line:
            # comment-only line: the waiver covers the next code line
            waivers[lineno + 1] = (rules, reason)
    return waivers, malformed
