"""The port's static analyzer (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``).

The seeded-source cases of ``tests/test_analysis.py`` (``TestRules``,
``TestWaivers``) are translated to the port's idiom -- a tensor where the
reference has a traced array, ``resolve_arm`` where it has
``register_op`` -- and each must give the same rule ids in both linters;
RPL003 has no counterpart (no ``jit``) and is never reported.
``parse_waivers`` equals the reference's on the same sources. The real
tree lints clean, the CLI exits 0 or 1 as it should, and a seeded
``.item()`` inside a level is caught by both the lint and the launch
audit's sync count. The committed budgets exist, the CPU ones reproduce,
and the CUDA arm's pin one ``msbfs_step`` per level; the int8 and
coverage checks find what they should.
"""
import json
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import lint_source as j_lint_source  # noqa: E402
from repro.analysis.rules import parse_waivers as j_parse_waivers  # noqa: E402,E501
from repro_torch.analysis import lint_source, lint_tree  # noqa: E402
from repro_torch.analysis import launch_audit  # noqa: E402
from repro_torch.analysis.astlint import iter_rule_ids  # noqa: E402
from repro_torch.analysis.report import AnalysisReport  # noqa: E402
from repro_torch.analysis.rules import RULES, parse_waivers  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src" / "repro_torch"


def _rules(findings):
    return sorted(f.rule for f in findings)


def _src(text: str) -> str:
    return textwrap.dedent(text).lstrip("\n")


# (case, the reference's source, the port's source, path): the cases of
# tests/test_analysis.py's TestRules, each tripping its rule exactly once
# (or, for the clean cases, nothing) in both linters
CASES = [
    ("rpl001_item_host_sync", """
        import jax
        @jax.jit
        def hot(x):
            return x.sum().item()
        """, """
        import torch
        def hot(x: torch.Tensor):
            return x.sum().item()
        """, "core/msbfs.py"),
    ("rpl001_cast_on_a_value", """
        import jax
        @jax.jit
        def hot(x):
            return int(x.sum())
        """, """
        import torch
        def hot(x: torch.Tensor):
            return int(x.sum())
        """, "core/join.py"),
    ("rpl001_not_applied_outside_hot_modules", """
        import jax
        @jax.jit
        def f(x):
            return x.sum().item()
        """, """
        import torch
        def f(x: torch.Tensor):
            return x.sum().item()
        """, "core/oracle.py"),
    ("rpl002_arm_outside_selection", """
        from ..kernels.msbfs_expand.ref import pack_bits
        """, """
        from ..kernels.path_join.ops import path_member_ref
        def dup(v, c):
            return path_member_ref(v, c)
        """, "core/engine.py"),
    ("rpl002_arm_selection_allowed", """
        from .ref import msbfs_step_ref
        from .kernel import msbfs_step_pallas
        """, """
        def msbfs_step(x, arm=None):
            if resolve_arm(x.device, arm) is KernelArm.CUDA:
                return msbfs_step_cuda(x)
            return msbfs_step_ref(x)
        """, "kernels/msbfs_expand/ops.py"),
    ("rpl004_python_loop_over_device_array", """
        import jax
        import jax.numpy as jnp
        @jax.jit
        def f(x):
            xs = jnp.arange(4)
            t = 0
            for v in xs:
                t = t + v
            return t
        """, """
        import torch
        def f(x):
            xs = torch.arange(4)
            t = 0
            for v in xs:
                t = t + v
            return t
        """, "core/enumerate.py"),
    ("rpl005_raw_pow2_shape_math", """
        def cap_for(k):
            return 2 ** k
        """, None, "core/cache.py"),
    ("rpl005_exempt_in_graph_py", """
        def pow2_ceil(k):
            return 2 ** k
        """, None, "core/graph.py"),
    ("rpl006_perf_counter_in_timed_module", """
        import time
        def run_batch(qs):
            t0 = time.perf_counter()
            return t0
        """, None, "core/engine.py"),
    ("rpl006_bare_import_form", """
        from time import perf_counter
        def admit(batch):
            return perf_counter()
        """, None, "launch/serve.py"),
    ("rpl006_exempt_in_obs", """
        import time
        def now():
            return time.perf_counter()
        """, None, "obs/trace.py"),
    ("rpl006_waivable", """
        import time
        def run(qs):
            t0 = time.perf_counter()  # repro-lint: waive[RPL006] clock calibration, not a stage
            return t0
        """, None, "core/engine.py"),
    ("rpl000_malformed_waiver", """
        x = 1  # repro-lint: waive[RPL999] not a known rule
        """, None, "core/cache.py"),
    ("rpl000_missing_reason", """
        import jax
        @jax.jit
        def hot(x):
            return x.sum().item()  # repro-lint: waive[RPL001]
        """, """
        import torch
        def hot(x: torch.Tensor):
            return x.sum().item()  # repro-lint: waive[RPL001]
        """, "core/msbfs.py"),
    # TestWaivers
    ("waiver_same_line", """
        import jax
        @jax.jit
        def hot(x):
            return x.sum().item()  # repro-lint: waive[RPL001] epilogue sync, once per batch
        """, """
        import torch
        def hot(x: torch.Tensor):
            return x.sum().item()  # repro-lint: waive[RPL001] epilogue sync, once per batch
        """, "core/msbfs.py"),
    ("waiver_own_line_covers_next", """
        import jax
        @jax.jit
        def hot(x):
            # repro-lint: waive[RPL001] epilogue sync is intentional
            return x.sum().item()
        """, """
        import torch
        def hot(x: torch.Tensor):
            # repro-lint: waive[RPL001] epilogue sync is intentional
            return x.sum().item()
        """, "core/msbfs.py"),
    ("waiver_wrong_rule_does_not_apply", """
        import jax
        @jax.jit
        def hot(x):
            return x.sum().item()  # repro-lint: waive[RPL004] wrong rule
        """, """
        import torch
        def hot(x: torch.Tensor):
            return x.sum().item()  # repro-lint: waive[RPL004] wrong rule
        """, "core/msbfs.py"),
    ("parse_waivers_ignores_docstrings", '''
        """Docs mentioning waive[RPL001] syntax are not waivers."""
        x = 1
        ''', None, "core/msbfs.py"),
]


def _pair(case):
    name, ref, port, rel = case
    ref = _src(ref)
    return ref, _src(port) if port is not None else ref, rel


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_rule_ids_equal_reference(case):
    ref, port, rel = _pair(case)
    mine, theirs = lint_source(port, rel), j_lint_source(ref, rel)
    assert _rules(mine) == _rules(theirs)
    assert [(f.rule, f.waived, f.waiver_reason) for f in mine] == \
        [(f.rule, f.waived, f.waiver_reason) for f in theirs]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_parse_waivers_equal_reference(case):
    ref, port, _ = _pair(case)
    for source in {ref, port}:
        assert parse_waivers(source) == j_parse_waivers(source)


def test_rpl003_has_no_counterpart():
    src = _src("""
        from functools import partial
        import jax
        @partial(jax.jit, static_argnames=('a_col',))
        def f(x, a_col, out_cap):
            return x
        """)
    assert _rules(j_lint_source(src, "core/join.py")) == ["RPL003"]
    assert lint_source(src, "core/join.py") == []
    assert "RPL003" in RULES and "no counterpart" in RULES["RPL003"]
    # a waiver naming it is still well formed
    assert parse_waivers("x = 1  # repro-lint: waive[RPL003] kept id\n")[1] \
        == []


@pytest.mark.parametrize("body,rules", [
    ("return x.tolist()", ["RPL001"]),
    ("return x.cpu()", ["RPL001"]),
    ("return x.numpy()", ["RPL001"]),
    ("return x.to('cpu', copy=True)", ["RPL001"]),
    ("return float(x[0] + 1)", ["RPL001"]),
    ("return bool((x > 0).any())", ["RPL001"]),
    ("return int(x.shape[0]) + len(x)", []),
    ("return x.to(x.device)", []),
    ("return int(bool(causal))", []),
    ("return int(_aligned(x, x))", []),
    ("a = np.arange(3)\n    return a.tolist()", []),
    ("for i, v in enumerate(x):\n        pass", ["RPL004"]),
    ("for hop in range(x.shape[0]):\n        pass", []),
])
def test_rpl001_rpl004_on_tensors_only(body, rules):
    src = ("import numpy as np\nimport torch\n"
           f"def hot(x: torch.Tensor, causal=False):\n    {body}\n")
    assert _rules(lint_source(src, "kernels/flash_attention/ops.py")) == rules


def test_flash_attention_launch_arguments_are_not_syncs():
    # the JAX rule flags ops.py's int(bool(causal)) and int(_aligned(...)):
    # Python values, not tensors
    rel = "kernels/flash_attention/ops.py"
    text = (SRC / rel).read_text()
    assert "RPL001" in {f.rule for f in j_lint_source(text, rel)}
    assert not [f for f in lint_source(text, rel) if f.rule == "RPL001"]


RPL002_SOURCES = {
    # a private helper picks the arm (core/join.py's _cuda)
    "private_picker": ("""
        def _cuda(device, arm):
            return resolve_arm(device, arm) is KernelArm.CUDA
        def join(a, b, arm=None):
            fn = join_cuda if _cuda(a.device, arm) else join_ref
            return fn(a, b)
        """, []),
    # reached only from a plain version (core/join.py's _assemble_keyed)
    "reached_only_from_plain": ("""
        def _assemble(a, b):
            return rowwise_overlap_ref(a, b)
        def join_ref(a, b):
            return _assemble(a, b)
        """, []),
    "reached_from_elsewhere_too": ("""
        def _assemble(a, b):
            return rowwise_overlap_ref(a, b)
        def join_ref(a, b):
            return _assemble(a, b)
        def join_other(a, b):
            return _assemble(a, b)
        """, ["RPL002"]),
    # a CUDA arm calls CUDA arms (keyed_join_cuda -> fused_join_cuda)
    "cuda_calls_cuda": ("""
        def keyed_join_cuda(a, b):
            return fused_join_cuda(a, b)
        """, []),
    "plain_calls_cuda": ("""
        def keyed_join_ref(a, b):
            return fused_join_cuda(a, b)
        """, ["RPL002"]),
    "module_level_call": ("""
        X = path_member_ref(1, 2)
        """, ["RPL002"]),
}


@pytest.mark.parametrize("name", sorted(RPL002_SOURCES))
def test_rpl002_arm_selection(name):
    src, rules = RPL002_SOURCES[name]
    assert _rules(lint_source(_src(src), "core/join.py")) == rules


def test_iter_rule_ids_helper():
    src = "import torch\ndef hot(x: torch.Tensor):\n    return x.item()\n"
    assert iter_rule_ids(lint_source(src, "core/msbfs.py")) == {"RPL001"}


# ----------------------------------------------------------------------
# the real tree and the CLI
# ----------------------------------------------------------------------

def test_real_tree_lints_clean():
    report = lint_tree(SRC)
    assert report.n_files > 50
    assert report.ok, report.render()
    # every deliberate sync is waived with its reason
    assert all(f.waiver_reason for f in report.waived)
    assert {f.rule for f in report.waived} >= {"RPL001", "RPL005",
                                                "RPL006"}


SEEDED = "import torch\ndef f(x: torch.Tensor):\n    return x.sum().item()\n"


def test_cli_lint_exit_codes(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    mod = tmp_path / "core"
    mod.mkdir()
    (mod / "msbfs.py").write_text(SEEDED)
    assert main(["--lint", "--root", str(tmp_path)]) == 1
    (mod / "msbfs.py").write_text("def f(x):\n    return x\n")
    assert main(["--lint", "--root", str(tmp_path)]) == 0


def test_cli_all_exit_codes(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["--all"]) == 0
    out = capsys.readouterr().out
    assert "0 violation(s)" in out and "hot function(s) audited" in out
    mod = tmp_path / "core"
    mod.mkdir()
    (mod / "msbfs.py").write_text(SEEDED)
    assert main(["--all", "--root", str(tmp_path), "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert not doc["ok"] and doc["findings"][0]["rule"] == "RPL001"


# ----------------------------------------------------------------------
# the launch audit
# ----------------------------------------------------------------------

LEVEL_SRC = """
import torch
def sweep(x: torch.Tensor, k: int):
    for _ in range(k):
        x = x + 1
        x.sum().item()
    return x
"""


def _toy(source: str):
    ns = {}
    exec(compile(source, "<seeded>", "exec"), ns)
    return launch_audit.HotFn(
        "sweep", lambda device, k: (lambda x: ns["sweep"](x, k),
                                    (torch.zeros(4, device=device),)))


def test_seeded_item_in_a_level_caught_by_lint_and_audit():
    assert _rules(lint_source(LEVEL_SRC, "core/msbfs.py")) == ["RPL001"]
    stats = launch_audit.measure(_toy(LEVEL_SRC), "torch")
    assert stats["syncs_per_level"] == 1 and stats["base_syncs"] == 0
    budget = dict(stats, syncs_per_level=0)
    fs = launch_audit._check_budget("sweep", "torch", stats, budget)
    assert [f.rule for f in fs] == ["audit/budget"]
    assert "syncs_per_level regressed" in fs[0].message
    clean = LEVEL_SRC.replace("        x.sum().item()\n", "")
    assert lint_source(clean, "core/msbfs.py") == []
    stats = launch_audit.measure(_toy(clean), "torch")
    assert stats["syncs_per_level"] == 0
    assert stats["aten_ops_per_level"] == 1        # the add


def test_card_window_counts():
    # what a card window's device events count as (no card needed)
    c = launch_audit._count_window([
        "msbfs_step_kernel(int const*, int*, int*, signed char*, int)",
        "void join_kernel<1>(JoinArgs)", "Memset (Device)",
        "void at::native::vectorized_elementwise_kernel<4>(int)",
        "Memcpy DtoH (Device -> Pinned)", "Memcpy HtoD (Pinned -> Device)"])
    assert c == {"ops": 5, "syncs": 1,
                 "kernels": {"msbfs_step": 1, "join_fused": 1}}


def test_budget_regression_detected():
    fs = launch_audit._check_budget("f", "torch", {"aten_ops": 10},
                                    {"aten_ops": 5})
    assert len(fs) == 1 and "regressed" in fs[0].message
    assert launch_audit._check_budget("f", "torch", {"aten_ops": 5},
                                      {"aten_ops": 5}) == []
    fs = launch_audit._check_budget(
        "f", "cuda", {"kernels": {"msbfs_step": 2}},
        {"kernels": {"msbfs_step": 1}})
    assert len(fs) == 1 and "kernels.msbfs_step" in fs[0].message


def test_missing_budget_is_a_finding():
    fs = launch_audit._check_budget("f", "torch", {"aten_ops": 10}, None)
    assert len(fs) == 1 and fs[0].rule == "audit/budget"


def test_committed_budgets_exist_and_pin_one_msbfs_step_per_level():
    budgets = json.loads(launch_audit.DEFAULT_BUDGETS_PATH.read_text())
    assert {e.name for e in launch_audit.MANIFEST} <= set(budgets)
    for entry in launch_audit.MANIFEST:
        assert set(budgets[entry.name]) == set(launch_audit.ARMS)
    for fn in ("msbfs_dist_ell", "msbfs_set_dist_ell"):
        cuda = budgets[fn]["cuda"]
        assert cuda["kernels_per_level"] == {"msbfs_step": 1}
        assert cuda["syncs_per_level"] == 0
    # the fused passes' contract: a level or join takes at most 3
    # launches, the keyed join's pair-setup ops apart
    assert budgets["expand_level"]["cuda"]["launches"] <= 3
    assert budgets["cross_join"]["cuda"]["launches"] <= 3


def test_write_budgets_reproduces_the_cpu_budgets():
    committed = json.loads(launch_audit.DEFAULT_BUDGETS_PATH.read_text())
    measured = launch_audit.measure_budgets(("torch",))
    assert measured == {name: {"torch": committed[name]["torch"]}
                        for name in measured}
    merged = launch_audit.merge_budgets(committed, measured)
    assert merged == committed


def test_write_budgets_keeps_the_other_arm(tmp_path):
    from repro_torch.analysis.__main__ import main
    path = tmp_path / "budgets.json"
    committed = json.loads(launch_audit.DEFAULT_BUDGETS_PATH.read_text())
    assert main(["--write-budgets", "--budgets", str(path)]) == 0
    written = json.loads(path.read_text())
    assert {k: v for k, v in written.items() if k != "_comment"} == \
        {k: v for k, v in committed.items() if k != "_comment"}


def test_full_audit_clean_on_the_plain_arm():
    report = launch_audit.run_audit(arm="torch")
    assert report.ok, report.render()
    assert report.n_functions == len(launch_audit.MANIFEST)
    assert report.meta["arm"] == "torch"


def test_int8_check(monkeypatch):
    from repro_torch.core import msbfs
    report = AnalysisReport()
    launch_audit._check_int8(report)
    assert report.ok and report.meta["int8"]["headroom"] >= 1
    # a clamp instead of a raise is a finding, for both sweeps
    monkeypatch.setattr(msbfs, "_check_k_max", lambda k: None)
    monkeypatch.setattr(msbfs, "K_MAX_INT8", 4)
    report = AnalysisReport()
    launch_audit._check_int8(report)
    assert sorted(f.path for f in report.violations) == [
        "msbfs_dist_ell", "msbfs_set_dist_ell"]


def test_coverage_check(monkeypatch):
    assert launch_audit._check_coverage() == []
    exempt = dict(launch_audit.AUDIT_EXEMPT_KERNELS)
    del exempt["path_overlap"]
    monkeypatch.setattr(launch_audit, "AUDIT_EXEMPT_KERNELS", exempt)
    fs = launch_audit._check_coverage()
    assert [f.path for f in fs] == ["registry:path_overlap"]
    monkeypatch.setattr(launch_audit, "AUDIT_EXEMPT_KERNELS",
                        dict(exempt, gone_kernel="stale"))
    assert {f.path for f in launch_audit._check_coverage()} == {
        "registry:path_overlap", "registry:gone_kernel"}
    # on a card a measured kernel that never launched is a finding too
    monkeypatch.setattr(launch_audit, "AUDIT_EXEMPT_KERNELS",
                        dict(exempt, path_overlap="ops API"))
    launched = {k: 1 for k in launch_audit._KERNELS_COVERED}
    assert launch_audit._check_coverage(launched) == []
    del launched["ell_gather_f1"]
    fs = launch_audit._check_coverage(launched)
    assert [f.path for f in fs] == ["registry:ell_gather_f1"]


def test_retrace_check_on_the_plain_arm():
    for entry in launch_audit.MANIFEST:
        assert launch_audit._check_retrace(entry, "torch") == []


class TestKmaxGuard:
    """The int8 distance ceiling is a static precondition, not a clamp."""

    def test_out_of_range_k_max_raises(self):
        from repro_torch.core.msbfs import K_MAX_INT8, msbfs_set_dist_ell
        n = 4
        ell = torch.full((n + 1, 2), n, dtype=torch.int32)
        seed = torch.zeros((n + 1,), dtype=torch.int8)
        with pytest.raises(ValueError) as exc:
            msbfs_set_dist_ell(ell, seed, n=n, k_max=K_MAX_INT8 + 1)
        msg = str(exc.value)
        assert f"k_max={K_MAX_INT8 + 1}" in msg
        assert "int8" in msg and "headroom" in msg

    def test_ceiling_leaves_sentinel_headroom(self):
        from repro_torch.core.msbfs import INF_FOR, K_MAX_INT8
        assert INF_FOR(K_MAX_INT8) <= 127 - 6

    def test_in_range_k_max_accepted(self):
        from repro_torch.core.msbfs import msbfs_set_dist_ell
        n = 4
        ell = torch.full((n + 1, 2), n, dtype=torch.int32)
        seed = torch.zeros((n + 1,), dtype=torch.int8)
        seed[1] = 1
        out = msbfs_set_dist_ell(ell, seed, n=n, k_max=3)
        assert out.shape == (n + 1,)
