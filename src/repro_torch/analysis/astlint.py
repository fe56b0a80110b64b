"""Layer 1: the port's AST lint over ``src/repro_torch/``.

Counterpart of ``repro/analysis/astlint.py``; implements the RPL rules of
:mod:`repro_torch.analysis.rules`. Scope:

* RPL001/RPL004 apply to every function of the hot modules
  (``rules.HOT_MODULE_PATTERNS``): the port has no ``jit``, so there is
  no trace to be reachable from -- each of those functions runs once per
  level, join or batch on the device's tensors. A value counts as a
  tensor when the function's own code shows it: a parameter annotated
  ``torch.Tensor``, the result of a ``torch.*`` function, of a tensor's
  method (other than ``.item()``, ``.tolist()``, ``.numpy()``, ``.dim()``,
  ``.numel()``, ``.size()``, ...), an index into a tensor or arithmetic
  on one, and a name bound to any of those. ``int(bool(causal))`` on a
  Python flag is not a sync and is not reported.
* RPL002 applies everywhere: a call of a kernel arm (``*_ref``, the
  plain version; ``*_cuda``, the kernel) is allowed only in a function
  that picks the arm through ``kernels.registry.resolve_arm`` (directly,
  or through a private helper that calls it, as ``core/join.py``'s
  ``_cuda``), in an arm of the same kind (a plain version may call plain
  versions, a CUDA arm CUDA arms), or in a function that only such arms
  of that kind call (``core/join.py``'s ``_assemble_keyed``, reached only
  from ``keyed_join_ref``).
* RPL003 has no counterpart (no ``jit``); it is never reported.
* RPL005 applies everywhere except ``core/graph.py`` (the definition
  site of ``pow2_ceil``).
* RPL006 applies in the timed modules (``rules.TIMED_MODULE_PATTERNS``
  less ``rules.UNTIMED_MODULES``): calling ``time.perf_counter()``
  directly instead of taking stage walls from ``repro_torch.obs.trace``
  spans. ``obs/`` itself is exempt.

Waivers (``# repro-lint: waive[RULE] reason``) are honoured on the
finding's line or the line directly above.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .report import AnalysisReport, Finding
from .rules import is_hot_module, is_timed_module, parse_waivers

__all__ = ["lint_source", "lint_tree", "iter_rule_ids"]

_CAST_NAMES = {"int", "float", "bool"}
_PERF_COUNTER_CALLS = {
    "time.perf_counter", "perf_counter",
    "time.perf_counter_ns", "perf_counter_ns",
}
_NUMPY_PREFIXES = ("np.", "numpy.")
_HOST_COPY_CALLS = {"np.asarray", "np.array", "numpy.asarray",
                    "numpy.array"}
# tensor methods whose result is not a tensor
_SCALAR_METHODS = {
    "item", "tolist", "numpy", "dim", "ndimension", "numel", "nelement",
    "size", "stride", "data_ptr", "element_size", "is_contiguous",
    "storage_offset", "get_device", "is_floating_point", "untyped_storage",
    "__len__", "__bool__", "__int__", "__float__", "equal",
}
# attributes of a tensor that are tensors (shape, dtype, device, ... are
# not)
_TENSOR_ATTRS = {"T", "mT", "real", "imag", "data"}
# torch.<x> namespaces and functions that return no tensor
_TORCH_NON_TENSOR = {
    "device", "Size", "dtype", "cuda", "profiler", "autograd", "utils",
    "backends", "distributed", "is_tensor", "is_floating_point",
    "get_default_dtype", "no_grad", "inference_mode", "Generator", "finfo",
    "iinfo", "manual_seed", "set_grad_enabled", "equal", "numel",
    "is_grad_enabled", "version", "library", "ops",
}
_ARM_KINDS = ("_ref", "_cuda")


def _dotted(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    if isinstance(node, ast.Name):
        return node.id
    return None


def _arm_kind(name: str) -> Optional[str]:
    """``"_ref"`` / ``"_cuda"`` for a kernel arm's name (a stem before the
    suffix is required: ``_cuda`` itself is a helper, not an arm)."""
    stem = name.lstrip("_")
    for kind in _ARM_KINDS:
        if stem.endswith(kind) and len(stem) > len(kind):
            return kind
    return None


def _to_host(node: ast.Call) -> bool:
    """``x.to("cpu", ...)`` / ``x.to(device="cpu")``."""
    args = list(node.args[:1]) + [k.value for k in node.keywords
                                  if k.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu"
               for a in args)


def _callee(node: ast.Call) -> Optional[str]:
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


class _ModuleIndex:
    """Function table + same-module call graph + arm classification."""

    def __init__(self, tree: ast.Module):
        self.functions: Dict[str, ast.AST] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.setdefault(node.name, node)
        self.calls: Dict[str, Set[str]] = {}
        pickers: Set[str] = set()
        for name, fn in self.functions.items():
            out: Set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    callee = _callee(node)
                    if callee == "resolve_arm":
                        pickers.add(name)
                    if callee in self.functions and callee != name:
                        out.add(callee)
            self.calls[name] = out
        callers: Dict[str, Set[str]] = {n: set() for n in self.functions}
        for name, out in self.calls.items():
            for callee in out:
                callers[callee].add(name)
        # a dispatcher picks the arm: it calls resolve_arm, or a private
        # helper that does (core/join.py's _cuda)
        self.dispatchers = pickers | {
            name for name, out in self.calls.items()
            if any(c in pickers and c.startswith("_") for c in out)}
        # per kind: the arms of that kind, and the functions that only
        # arms of that kind call (fixed point over the call graph)
        self.arm_fns: Dict[str, Set[str]] = {}
        for kind in _ARM_KINDS:
            fns = {n for n in self.functions if _arm_kind(n) == kind}
            changed = True
            while changed:
                changed = False
                for name, who in callers.items():
                    if name not in fns and who and who <= fns:
                        fns.add(name)
                        changed = True
            self.arm_fns[kind] = fns


class _Scope:
    """What one function's own code shows about its names."""

    def __init__(self, fn: Optional[ast.AST] = None):
        self.tensors: Set[str] = set()
        self.arrays: Set[str] = set()           # numpy arrays
        if fn is not None:
            a = fn.args
            for p in (*a.posonlyargs, *a.args, *a.kwonlyargs):
                ann = _dotted(p.annotation) if p.annotation is not None \
                    else None
                if ann in ("torch.Tensor", "Tensor"):
                    self.tensors.add(p.arg)


class _RuleVisitor(ast.NodeVisitor):
    """Single-pass visitor collecting raw (rule, line, message) hits."""

    def __init__(self, relpath: str, index: _ModuleIndex, *,
                 hot: bool, is_graph: bool, timed: bool):
        self.relpath = relpath
        self.index = index
        self.hot = hot                  # RPL001/004 scope
        self.is_graph = is_graph        # core/graph.py (RPL005 exempt)
        self.timed = timed              # RPL006 scope (obs/ exempt)
        self.hits: List[Tuple[str, int, str]] = []
        self._fn_stack: List[str] = []
        self._scopes: List[_Scope] = [_Scope()]

    def _flag(self, rule: str, node: ast.AST, msg: str) -> None:
        self.hits.append((rule, getattr(node, "lineno", 0), msg))

    def _in_hot_fn(self) -> bool:
        return self.hot and bool(self._fn_stack)

    # -- what is a tensor ----------------------------------------------
    def _is_tensor(self, node: ast.expr) -> bool:
        scope = self._scopes[-1]
        if isinstance(node, ast.Name):
            return node.id in scope.tensors
        if isinstance(node, ast.Call):
            d = _dotted(node.func) or ""
            if d.startswith("torch."):
                return d.split(".")[1] not in _TORCH_NON_TENSOR
            if isinstance(node.func, ast.Attribute):
                return node.func.attr not in _SCALAR_METHODS and \
                    self._is_tensor(node.func.value)
            return False
        if isinstance(node, ast.Attribute):
            return node.attr in _TENSOR_ATTRS and self._is_tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self._is_tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self._is_tensor(node.left) or self._is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._is_tensor(node.operand)
        if isinstance(node, ast.Compare):
            return self._is_tensor(node.left) or \
                any(self._is_tensor(c) for c in node.comparators)
        return False

    def _is_array(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self._scopes[-1].arrays
        if isinstance(node, ast.Call):
            d = _dotted(node.func) or ""
            if d.startswith(_NUMPY_PREFIXES):
                return True
            return isinstance(node.func, ast.Attribute) and \
                node.func.attr == "numpy"
        return isinstance(node, ast.Subscript) and self._is_array(node.value)

    def _bind(self, target: ast.expr, value: Optional[ast.expr]) -> None:
        scope = self._scopes[-1]
        if isinstance(target, ast.Name):
            scope.tensors.discard(target.id)
            scope.arrays.discard(target.id)
            if value is None:
                return
            if self._is_tensor(value):
                scope.tensors.add(target.id)
            elif self._is_array(value):
                scope.arrays.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            vals = value.elts if isinstance(value, (ast.Tuple, ast.List)) \
                and len(value.elts) == len(target.elts) else None
            for i, t in enumerate(target.elts):
                self._bind(t, vals[i] if vals is not None else None)

    # -- scope tracking ------------------------------------------------
    def visit_FunctionDef(self, node) -> None:
        self._fn_stack.append(node.name)
        self._scopes.append(_Scope(node))
        self.generic_visit(node)
        self._scopes.pop()
        self._fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        for tgt in node.targets:
            self._bind(tgt, node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self.generic_visit(node)
        self._bind(node.target, node.value)

    # -- calls: RPL001 + RPL002 + RPL006 -------------------------------
    def _arm_call_allowed(self, kind: str) -> bool:
        for fn in self._fn_stack:
            if fn in self.index.dispatchers or \
                    fn in self.index.arm_fns[kind]:
                return True
        return False

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func) or ""
        name = _callee(node) or ""

        if self.timed and dotted in _PERF_COUNTER_CALLS:
            self._flag(
                "RPL006", node,
                f"direct {dotted}() timing in a timed module -- wrap the "
                f"stage in a repro_torch.obs.trace span and read "
                f"span.duration so the wall lands in the trace/metrics "
                f"pipeline")

        kind = _arm_kind(name)
        if kind is not None and not self._arm_call_allowed(kind):
            self._flag(
                "RPL002", node,
                f"direct call to kernel arm '{name}' outside arm selection "
                f"-- call the ops.py wrapper (or its core counterpart), "
                f"which picks the arm through registry.resolve_arm")

        if self._in_hot_fn():
            recv = node.func.value if isinstance(node.func, ast.Attribute) \
                else None
            if name == "item" and recv is not None:
                self._flag("RPL001", node,
                           ".item() copies a scalar to the host and waits "
                           "for the device")
            elif name == "tolist" and recv is not None and \
                    not self._is_array(recv):
                self._flag("RPL001", node,
                           ".tolist() copies a tensor to the host and "
                           "waits for the device")
            elif name in ("cpu", "numpy") and recv is not None and \
                    not self._is_array(recv) and not node.args:
                self._flag("RPL001", node,
                           f".{name}() copies a tensor to the host and "
                           f"waits for the device")
            elif name == "to" and recv is not None and _to_host(node):
                self._flag("RPL001", node,
                           ".to('cpu') copies a tensor to the host and "
                           "waits for the device")
            elif dotted in _CAST_NAMES and len(node.args) == 1 and \
                    self._is_tensor(node.args[0]):
                self._flag("RPL001", node,
                           f"{dotted}() on a tensor copies it to the host "
                           f"and waits for the device")
            elif dotted in _HOST_COPY_CALLS and node.args and \
                    self._is_tensor(node.args[0]):
                self._flag("RPL001", node,
                           f"{dotted}() on a tensor copies it to the host "
                           f"and waits for the device")
        self.generic_visit(node)

    # -- RPL004: loops over device tensors -----------------------------
    def visit_For(self, node: ast.For) -> None:
        if self._in_hot_fn():
            it = node.iter
            over = [it]
            if isinstance(it, ast.Call) and _dotted(it.func) in ("enumerate",
                                                                 "zip"):
                over = list(it.args)
            if any(self._is_tensor(x) for x in over):
                self._flag(
                    "RPL004", node,
                    "Python for-loop over a device tensor (one host sync "
                    "and one tiny launch per element) -- vectorize")
        self.generic_visit(node)
        self._bind(node.target, None)

    # -- RPL005: raw pow2 / parity shape math --------------------------
    def visit_BinOp(self, node: ast.BinOp) -> None:
        if not self.is_graph:
            def const(n: ast.expr) -> Optional[object]:
                return n.value if isinstance(n, ast.Constant) else None

            if isinstance(node.op, ast.Pow) and const(node.left) == 2 and \
                    const(node.right) is None:
                self._flag("RPL005", node,
                           "raw 2**x shape math -- use graph.pow2_ceil")
            elif isinstance(node.op, ast.LShift) and \
                    const(node.left) in (1, 2) and \
                    const(node.right) is None:
                self._flag("RPL005", node,
                           "raw 1<<x pow2 math -- use graph.pow2_ceil")
            elif isinstance(node.op, ast.Mod) and const(node.right) == 2 \
                    and const(node.left) is None:
                self._flag("RPL005", node,
                           "raw x%2 parity shape math -- use "
                           "graph.pow2_ceil")
        self.generic_visit(node)


def lint_source(source: str, relpath: str) -> List[Finding]:
    """Lint one module's source. ``relpath`` is posix-style relative to
    the lint root (e.g. ``core/msbfs.py``)."""
    rel = relpath.replace("\\", "/")
    waivers, malformed = parse_waivers(source)
    findings = [Finding("RPL000", rel, line, msg) for line, msg in malformed]

    tree = ast.parse(source)
    visitor = _RuleVisitor(rel, _ModuleIndex(tree),
                           hot=is_hot_module(rel),
                           is_graph=rel == "core/graph.py",
                           timed=is_timed_module(rel))
    visitor.visit(tree)

    for rule, line, msg in visitor.hits:
        waiver = waivers.get(line)
        if waiver and rule in waiver[0]:
            findings.append(Finding(rule, rel, line, msg,
                                    waived=True, waiver_reason=waiver[1]))
        else:
            findings.append(Finding(rule, rel, line, msg))
    return findings


def lint_tree(root: Path, *,
              exclude: Sequence[str] = ("__pycache__",)) -> AnalysisReport:
    """Lint every ``*.py`` under ``root`` (the ``src/repro_torch``
    directory)."""
    root = Path(root)
    report = AnalysisReport()
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if any(part in exclude for part in path.parts):
            continue
        report.n_files += 1
        try:
            report.add(lint_source(path.read_text(), rel))
        except SyntaxError as exc:  # pragma: no cover - tree is importable
            report.add([Finding("RPL000", rel, exc.lineno or 0,
                                f"syntax error: {exc.msg}")])
    return report


def iter_rule_ids(findings: Iterable[Finding]) -> Set[str]:
    return {f.rule for f in findings}
