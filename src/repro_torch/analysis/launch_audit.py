"""Layer 2: launch audit of the hot-function manifest.

Counterpart of ``repro/analysis/jaxpr_audit.py``. The reference traces
each hot function into a jaxpr and counts its equations; the port has no
trace to read, so it runs each function on tiny concrete inputs and
counts what it dispatches, per kernel arm:

* the plain arm (``torch``, on the CPU): every aten op dispatched, seen
  by a ``TorchDispatchMode``. aten-op counts follow the torch version, so
  the plain arm's budgets hold on the CPU they were written on;
* the CUDA arm (``cuda``, on a card): every launch a ``torch.profiler``
  window with CUDA activity sees on the device -- kernels, memsets and
  copies -- and, by name, the port's own kernels. Those launch through
  ``ctypes``, so the dispatcher never sees them: only the device trace
  does.

Checks:

  audit/budget     per-level counts (the reference's finite difference:
                   run at levels 2 and 3, ``per_level = c(3) - c(2)``,
                   ``base = c(2) - 2 * per_level``) or per-call counts of
                   launches / aten ops and host syncs, at or below the
                   committed ``LAUNCH_BUDGETS.json`` beside this module
                   (the CUDA arm's entries are checked only on a card).
                   The budgets' host syncs are ``aten::
                   _local_scalar_dense`` on the plain arm (what ``int(t)``,
                   ``.item()`` and ``pathset.read_status`` dispatch to) and
                   copies to the host on the card -- what the reference's
                   audit/trace catches as a ``ConcretizationTypeError``
  audit/int8       ``msbfs_dist_ell`` and ``msbfs_set_dist_ell`` raise a
                   ``ValueError`` naming ``k_max`` past ``K_MAX_INT8``, and
                   the sentinel keeps its headroom
  audit/retrace    a second call at the same shapes, with other values,
                   adds no compile in ``core/compilelog``
  audit/coverage   every name in ``kernels.registry`` (``KERNELS`` and
                   ``ROUTE_COUNTS``) is either measured by a manifest
                   entry or exempted with a written reason; on a card each
                   measured name must also have launched in the audit
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from .report import AnalysisReport, Finding

__all__ = ["MANIFEST", "AUDIT_EXEMPT_KERNELS", "KERNEL_SYMBOLS", "HotFn",
           "ARMS", "run_audit", "measure", "measure_budgets",
           "merge_budgets", "default_arm", "DEFAULT_BUDGETS_PATH"]

DEFAULT_BUDGETS_PATH = Path(__file__).resolve().with_name(
    "LAUNCH_BUDGETS.json")

ARMS = ("torch", "cuda")
_DEVICE_OF_ARM = {"torch": "cpu", "cuda": "cuda"}

# level knob values used for the finite-difference measurement
_LEVELS = (2, 3)

# the port's kernels as a device trace names them -> their LAUNCHES name
KERNEL_SYMBOLS = {
    "msbfs_step_kernel": "msbfs_step",
    "expand_level_kernel": "level_fused",
    "join_kernel": "join_fused",
    "ell_gather_f1_kernel": "ell_gather_f1",
    "ell_spmm_kernel": "ell_spmm",
    "gamma_pack_kernel": "gamma_pack",
    "pairwise_popcount_kernel": "pairwise_popcount",
}
_SYMBOL_RE = re.compile(r"\b(" + "|".join(KERNEL_SYMBOLS) + r")\b")

# a kernel that only waits, launched first in each card window: on the
# H100 a short profiler window has been seen to drop its first device
# event (chip_smoke.py's MARKER); its own event is left out of the counts
_MARKER = "spin_kernel"
# card windows per count: a short window has also been seen to come back
# with some or all of its device events missing (never with extra ones;
# most often in a process that had run other profiler windows before).
# A window is complete when it shows each of the port's kernels as often
# as their wrappers counted launches (registry.LAUNCHES); an incomplete
# one is traced again, up to _TRACE_TRIES times, and each count is the
# most that any of _WINDOWS complete windows saw
_WINDOWS = 2
_TRACE_TRIES = 8


@dataclasses.dataclass(frozen=True)
class HotFn:
    """One audited hot function.

    ``make(device, level)`` returns ``(fn, args)`` ready for ``fn(*args)``
    on tiny shapes on ``device``; for unleveled entries the ``level``
    argument is ignored.
    """
    name: str
    make: Callable[[torch.device, int], tuple]
    leveled: bool = True


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------

def _ell(device, n: int = 16, D: int = 4) -> torch.Tensor:
    """A ring plus chords: every vertex has in-neighbours (a level does
    work), pads = n."""
    v = torch.arange(n + 1, dtype=torch.int32)
    ell = torch.full((n + 1, D), n, dtype=torch.int32)
    ell[:n, 0] = (v[:n] - 1) % n
    ell[:n, 1] = (v[:n] + 3) % n
    return ell.to(device)


def _mk_msbfs_dist_ell(device, k: int):
    from ..core.msbfs import msbfs_dist_ell
    n = 16
    srcs = torch.tensor([0, 5, 9, 12], dtype=torch.int64, device=device)
    return (lambda a, b: msbfs_dist_ell(a, b, n=n, k_max=k),
            (_ell(device, n), srcs))


def _mk_msbfs_set_dist_ell(device, k: int):
    from ..core.msbfs import msbfs_set_dist_ell
    n = 16
    seed = torch.zeros((n + 1,), dtype=torch.int8)
    seed[[1, 7]] = 1
    return (lambda a, b: msbfs_set_dist_ell(a, b, n=n, k_max=k),
            (_ell(device, n), seed.to(device)))


def _mk_walk_counts_ell(device, k: int):
    from ..core.index import walk_counts_ell
    n = 16
    slack = torch.full((n + 1,), 8, dtype=torch.int8)
    slack[-1] = -1
    return (lambda a, s: walk_counts_ell(a, 0, s, n=n, budget=k),
            (_ell(device, n), slack.to(device)))


def _rows(device, cap: int = 8, L: int = 6, fill: int = 2) -> tuple:
    """``fill`` valid rows of 3 vertices (cols 0..2), the rest -1."""
    verts = torch.full((cap, L), -1, dtype=torch.int32)
    for r in range(fill):
        verts[r, :3] = torch.tensor([r, r + 4, r + 8], dtype=torch.int32)
    return (verts.to(device),
            torch.tensor(fill, dtype=torch.int64, device=device))


def _mk_expand_level(device, k: int):
    from ..core.enumerate import expand_level
    n, cap = 16, 8
    verts, count = _rows(device, cap)
    tbl = torch.full((n + 1, 2), 8, dtype=torch.int8)
    tbl[n] = -1
    return (lambda v, c, e, t: expand_level(
                v, c, e, t, -2, level=2, budget=5, out_cap=cap),
            (verts, count, _ell(device, n)[:n].contiguous(), tbl.to(device)))


def _join_sides(device) -> tuple:
    """A side sorted by its last vertex (the engine sorts once per level,
    outside the join), and a B side."""
    from ..core.join import sort_by_last
    verts, count = _rows(device)
    a = sort_by_last(verts, count, col=2)
    return (a.verts, a.keys, a.count, verts, count)


def _mk_keyed_join(device, k: int):
    from ..core.join import SortedSide, keyed_join
    return (lambda av, ak, ac, bv, bc: keyed_join(
                SortedSide(av, ak, ac), bv, bc, a_col=2, b_col=2,
                out_cap=8, out_width=6),
            _join_sides(device))


def _mk_keyed_join_count(device, k: int):
    from ..core.join import SortedSide, keyed_join_count
    return (lambda av, ak, ac, bv, bc: keyed_join_count(
                SortedSide(av, ak, ac), bv, bc, a_col=2, b_col=2,
                pair_cap=8),
            _join_sides(device))


def _mk_cross_join(device, k: int):
    from ..core.join import cross_join
    verts, count = _rows(device)
    return (lambda pv, pc, cv, cc: cross_join(
                pv, pc, cv, cc, p_col=2, c_col=2, out_cap=8, out_width=6),
            (verts, count, verts, count))


def _mk_gamma_intersections(device, k: int):
    from ..kernels.pairwise_popcount.ops import gamma_intersections
    n = 40
    dist = torch.arange((n + 1) * 3, dtype=torch.int32).reshape(n + 1, 3)
    dist = (dist % 7).to(torch.int8).to(device)
    col = torch.tensor([0, 1, 2, 1], dtype=torch.int32, device=device)
    ks = torch.tensor([3, 4, 2, 5], dtype=torch.int8, device=device)
    return (lambda d, c, q: gamma_intersections(d, c, q, n),
            (dist, col, ks))


MANIFEST: Tuple[HotFn, ...] = (
    HotFn("msbfs_dist_ell", _mk_msbfs_dist_ell),
    HotFn("msbfs_set_dist_ell", _mk_msbfs_set_dist_ell),
    HotFn("walk_counts_ell", _mk_walk_counts_ell),
    HotFn("expand_level", _mk_expand_level, leveled=False),
    HotFn("keyed_join", _mk_keyed_join, leveled=False),
    HotFn("keyed_join_count", _mk_keyed_join_count, leveled=False),
    HotFn("cross_join", _mk_cross_join, leveled=False),
    # the similarity stage (once per batch and direction, not per level)
    HotFn("gamma_intersections", _mk_gamma_intersections, leveled=False),
)

# registry names deliberately not measured by the manifest. Every name in
# kernels.registry's KERNELS and ROUTE_COUNTS must be either reached by a
# MANIFEST entry (_KERNELS_COVERED) or listed here with a reason.
_LM = ("the LM path (models/transformer), not the HC-s-t query path; "
       "parity pinned by tests/test_torch_flash_attention.py")
AUDIT_EXEMPT_KERNELS: Dict[str, str] = {
    "flash_attention": _LM,
    "attn_wgmma": _LM, "attn_splitk": _LM, "attn_mma": _LM,
    "attn_scalar": _LM,
    "msbfs_expand": "the ops API's single hop (msbfs_hop_packed), not the "
                    "engine's level: the fused msbfs_step carries the "
                    "sweep; parity pinned by tests/test_torch_ops.py",
    "path_overlap": "the ops API's pairwise path similarity, not the "
                    "per-level enumeration loop; parity pinned by "
                    "tests/test_torch_ops.py",
}

# registry names each manifest entry's CUDA arm launches (for coverage):
# path_member runs inside the fused level, rowwise_overlap inside the
# fused join, ell_spmm as its F = 1 kernel
_KERNELS_COVERED = {
    "msbfs_step": ("msbfs_dist_ell", "msbfs_set_dist_ell"),
    "ell_spmm": ("walk_counts_ell",),
    "ell_gather_f1": ("walk_counts_ell",),
    "path_member": ("expand_level",),
    "level_fused": ("expand_level",),
    "rowwise_overlap": ("keyed_join", "keyed_join_count", "cross_join"),
    "join_fused": ("keyed_join", "keyed_join_count", "cross_join"),
    "gamma_pack": ("gamma_intersections",),
    "pairwise_popcount": ("gamma_intersections",),
}


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def default_arm() -> str:
    """The arm this machine measures: ``cuda`` where there is a card."""
    return "cuda" if torch.cuda.is_available() else "torch"


def _count_aten_ops(fn: Callable, args: Sequence) -> Dict:
    """aten ops dispatched by ``fn(*args)`` and its host syncs (the
    plain arm runs on CPU tensors, so a sync is a
    ``_local_scalar_dense``: ``int(t)``, ``.item()``, ``read_status``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0
            self.syncs = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            self.ops += 1
            if func.overloadpacket.__name__ == "_local_scalar_dense":
                self.syncs += 1
            return func(*args, **kwargs)

    with Counter() as c:
        fn(*args)
    return {"ops": c.ops, "syncs": c.syncs}


def _device_events(fn: Callable, args: Sequence) -> list:
    """The name of each device event of ``fn(*args)`` under a card-only
    profiler window (kernels, memsets, copies; a span's range on the
    device timeline and the marker kernel left out), from the first
    complete window of at most _TRACE_TRIES. Raises ``RuntimeError`` when
    none is complete."""
    from torch.profiler import ProfilerActivity, profile

    from ..kernels.registry import LAUNCHES
    counted = set(KERNEL_SYMBOLS.values()) - {"ell_spmm"}  # a route's
    # launch also counts under ell_spmm; its own kernel is named apart
    for _ in range(_TRACE_TRIES):
        torch.cuda.synchronize()
        before = {k: LAUNCHES[k] for k in counted}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(10000)
            fn(*args)
            torch.cuda.synchronize()
        launched = {k: LAUNCHES[k] - before[k] for k in counted}
        events = [e.name() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation()
                  and _MARKER not in e.name()]
        seen = _count_window(events)["kernels"]
        if events and all(seen.get(k, 0) == n for k, n in launched.items()):
            return events
    raise RuntimeError(
        f"no complete profiler window in {_TRACE_TRIES}: the trace showed "
        f"{seen} of the port's kernels, their wrappers counted {launched}")


def _count_window(events: list) -> Dict:
    launches = syncs = 0
    kernels: Dict[str, int] = {}
    for name in events:
        low = name.lower()
        if "memcpy" in low and "dtoh" in low:
            syncs += 1
            continue
        launches += 1
        m = _SYMBOL_RE.search(name)
        if m:
            k = KERNEL_SYMBOLS[m.group(1)]
            kernels[k] = kernels.get(k, 0) + 1
    return {"ops": launches, "syncs": syncs, "kernels": kernels}


def _count_launches(fn: Callable, args: Sequence) -> Dict:
    """Device launches of ``fn(*args)`` on a card: every kernel, memset
    and copy but the copies to the host, which are its syncs; and the
    port's own kernels by name. Each count is the most of _WINDOWS
    windows."""
    out: Dict = {"ops": 0, "syncs": 0, "kernels": {}}
    for _ in range(_WINDOWS):
        c = _count_window(_device_events(fn, args))
        out["ops"] = max(out["ops"], c["ops"])
        out["syncs"] = max(out["syncs"], c["syncs"])
        for k, v in c["kernels"].items():
            out["kernels"][k] = max(out["kernels"].get(k, 0), v)
    return out


def _count(arm: str, fn: Callable, args: Sequence) -> Dict:
    return _count_launches(fn, args) if arm == "cuda" else \
        _count_aten_ops(fn, args)


def measure(entry: HotFn, arm: str) -> Dict:
    """Measured dispatch stats of one (entry, arm) cell."""
    device = torch.device(_DEVICE_OF_ARM[arm])
    unit = "launches" if arm == "cuda" else "aten_ops"
    if not entry.leveled:
        fn, args = entry.make(device, _LEVELS[0])
        fn(*args)                                  # warm (may load)
        c = _count(arm, fn, args)
        stats = {unit: c["ops"], "syncs": c["syncs"]}
        if arm == "cuda":
            stats["kernels"] = c["kernels"]
        return stats
    lo, hi = _LEVELS
    f_lo, a_lo = entry.make(device, lo)
    f_hi, a_hi = entry.make(device, hi)
    f_lo(*a_lo)                                    # warm (may load)
    c_lo = _count(arm, f_lo, a_lo)
    c_hi = _count(arm, f_hi, a_hi)
    per = c_hi["ops"] - c_lo["ops"]
    per_sync = c_hi["syncs"] - c_lo["syncs"]
    stats = {f"{unit}_per_level": per, f"base_{unit}": c_lo["ops"] - lo * per,
             "syncs_per_level": per_sync,
             "base_syncs": c_lo["syncs"] - lo * per_sync}
    if arm == "cuda":
        stats["kernels_per_level"] = {
            k: c_hi["kernels"].get(k, 0) - c_lo["kernels"].get(k, 0)
            for k in sorted(set(c_hi["kernels"]) | set(c_lo["kernels"]))}
    return stats


def measure_budgets(arms: Optional[Sequence[str]] = None
                    ) -> Dict[str, Dict[str, Dict]]:
    """Measured dispatch stats of the whole manifest on ``arms`` (default:
    :func:`default_arm`); ``python -m repro_torch.analysis
    --write-budgets`` commits this."""
    arms = tuple(arms) if arms is not None else (default_arm(),)
    return {e.name: {a: measure(e, a) for a in arms} for e in MANIFEST}


def merge_budgets(base: Dict, measured: Dict) -> Dict:
    """``base`` (a budgets document) with the measured arms' entries
    replaced and every other arm's entries kept."""
    out = {k: (dict(v) if isinstance(v, dict) and not k.startswith("_")
               else v) for k, v in base.items()}
    for name, by_arm in measured.items():
        out.setdefault(name, {}).update(by_arm)
    return out


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _check_budget(name: str, arm: str, stats: Dict,
                  budget: Optional[Dict]) -> list:
    loc = f"{name}[{arm}]"
    if budget is None:
        return [Finding("audit/budget", loc, 0,
                        f"no committed budget in LAUNCH_BUDGETS.json "
                        f"(measured: {stats}); run --write-budgets and "
                        f"commit the baseline")]
    findings = []

    def check(key: str, actual: int, allowed: Optional[int]) -> None:
        if allowed is None:
            findings.append(Finding(
                "audit/budget", loc, 0,
                f"budget entry missing key {key!r} (measured {actual})"))
        elif actual > allowed:
            findings.append(Finding(
                "audit/budget", loc, 0,
                f"{key} regressed: measured {actual} > committed budget "
                f"{allowed}"))

    for key, actual in stats.items():
        if isinstance(actual, dict):
            allowed = budget.get(key) or {}
            for k, v in actual.items():
                check(f"{key}.{k}", v, allowed.get(k))
        else:
            check(key, actual, budget.get(key))
    return findings


def _check_int8(report: AnalysisReport) -> None:
    """int8 overflow hazards proven in range, not just clamped."""
    from ..core import msbfs

    inf = msbfs.INF_FOR(msbfs.K_MAX_INT8)
    headroom = 127 - inf
    if inf > 127 or headroom < 1:
        report.add([Finding(
            "audit/int8", "msbfs.K_MAX_INT8", 0,
            f"INF_FOR(K_MAX_INT8)={inf} leaves headroom={headroom} in "
            f"int8 -- the sentinel no longer fits")])
    report.meta["int8"] = {"k_max_ceiling": msbfs.K_MAX_INT8,
                          "inf": inf, "headroom": headroom}

    # the guard must RAISE for k_max past the ceiling (naming k_max), not
    # silently clamp
    n = 4
    ell = torch.full((n + 1, 2), n, dtype=torch.int32)
    seed = torch.zeros((n + 1,), dtype=torch.int8)
    srcs = torch.zeros((2,), dtype=torch.int64)
    for fn_name, call in (
        ("msbfs_dist_ell", lambda k: msbfs.msbfs_dist_ell(
            ell, srcs, n=n, k_max=k)),
        ("msbfs_set_dist_ell", lambda k: msbfs.msbfs_set_dist_ell(
            ell, seed, n=n, k_max=k)),
    ):
        try:
            call(msbfs.K_MAX_INT8 + 1)
            report.add([Finding(
                "audit/int8", fn_name, 0,
                f"k_max={msbfs.K_MAX_INT8 + 1} did not raise -- the int8 "
                f"bound is clamped, not checked")])
        except ValueError as exc:
            if "k_max" not in str(exc):
                report.add([Finding(
                    "audit/int8", fn_name, 0,
                    f"out-of-range k_max raised but the error does not "
                    f"name k_max: {exc}")])


def _perturb(args: Sequence) -> tuple:
    """Same-shape, other-value variants of the example args: every
    tensor of rank >= 1 becomes zeros (index tensors stay in range),
    scalars (counts) keep their meaning."""
    return tuple(torch.zeros_like(a) if isinstance(a, torch.Tensor)
                 and a.dim() >= 1 else a for a in args)


def _check_retrace(entry: HotFn, arm: str) -> list:
    """A second same-shape call must add zero compiles."""
    from ..core import compilelog
    log = compilelog.enable()
    fn, args = entry.make(torch.device(_DEVICE_OF_ARM[arm]), _LEVELS[0])
    loc = f"{entry.name}[{arm}]"
    try:
        args2 = _perturb(args)
        fn(*args)                       # warm (may load a library)
        snap = log.snapshot()
        fn(*args2)                      # same shapes, new values
    except Exception as exc:  # noqa: BLE001 -- reported as a finding
        return [Finding("audit/retrace", loc, 0,
                        f"execution failed: {type(exc).__name__}: "
                        f"{str(exc).splitlines()[0][:160]}")]
    new = log.compiles_since(snap)
    if new:
        return [Finding(
            "audit/retrace", loc, 0,
            f"{new} new compile(s) on a same-shape re-run -- a library "
            f"depends on an argument's value ({log.since(snap)})")]
    return []


def _check_coverage(launched: Optional[Dict[str, int]] = None) -> list:
    """Every registry name measured or exempted; with ``launched`` (the
    audit's launch counts on a card) every measured name launched."""
    from ..kernels.registry import KERNELS, ROUTE_COUNTS
    names = KERNELS + ROUTE_COUNTS
    findings = []
    for name in names:
        if name in AUDIT_EXEMPT_KERNELS:
            continue
        if name not in _KERNELS_COVERED:
            findings.append(Finding(
                "audit/coverage", f"registry:{name}", 0,
                f"kernel {name!r} is neither measured by the audit "
                f"manifest nor listed in AUDIT_EXEMPT_KERNELS with a "
                f"reason"))
        elif launched is not None and not launched.get(name):
            findings.append(Finding(
                "audit/coverage", f"registry:{name}", 0,
                f"kernel {name!r} never launched in the audit of "
                f"{list(_KERNELS_COVERED[name])}"))
    for name in sorted((set(AUDIT_EXEMPT_KERNELS) | set(_KERNELS_COVERED))
                       - set(names)):
        findings.append(Finding(
            "audit/coverage", f"registry:{name}", 0,
            f"the audit lists {name!r}, which is no longer a kernel of "
            f"the registry -- drop the stale entry"))
    return findings


def load_budgets(path: Optional[Path] = None) -> Optional[Dict]:
    """The committed budgets (``None`` when the file is missing)."""
    path = Path(path or DEFAULT_BUDGETS_PATH)
    if not path.exists():
        return None
    return json.loads(path.read_text())


def run_audit(budgets_path: Optional[Path] = None, *,
              arm: Optional[str] = None, check_budgets: bool = True,
              check_retraces: bool = True) -> AnalysisReport:
    """Run the full layer-2 audit on ``arm`` (default: the CUDA arm where
    there is a card, else the plain arm); returns one
    :class:`AnalysisReport`. A missing budgets file is one finding."""
    from ..kernels.registry import LAUNCHES, reset_launches
    arm = arm or default_arm()
    report = AnalysisReport()
    budgets: Dict = {}
    if check_budgets:
        doc = load_budgets(budgets_path)
        if doc is None:
            report.add([Finding(
                "audit/budget", str(budgets_path or DEFAULT_BUDGETS_PATH),
                0, "committed budget baseline not found -- run `python -m "
                   "repro_torch.analysis --write-budgets` and commit it")])
            check_budgets = False
        else:
            budgets = {k: v for k, v in doc.items() if not k.startswith("_")}

    measured: Dict[str, Dict[str, Dict]] = {}
    reset_launches()
    for entry in MANIFEST:
        report.n_functions += 1
        loc = f"{entry.name}[{arm}]"
        try:
            stats = measure(entry, arm)
        except Exception as exc:  # noqa: BLE001 -- reported as a finding
            report.add([Finding(
                "audit/trace", loc, 0,
                f"failed to run: {type(exc).__name__}: "
                f"{str(exc).splitlines()[0][:200]}")])
            continue
        measured.setdefault(entry.name, {})[arm] = stats
        if check_budgets:
            report.add(_check_budget(entry.name, arm, stats,
                                     budgets.get(entry.name, {}).get(arm)))
        if check_retraces:
            report.add(_check_retrace(entry, arm))
    launched = dict(LAUNCHES) if arm == "cuda" else None

    _check_int8(report)
    report.add(_check_coverage(launched))
    report.meta["arm"] = arm
    report.meta["measured"] = measured
    if launched is not None:
        report.meta["launched"] = {k: v for k, v in launched.items() if v}
    return report
