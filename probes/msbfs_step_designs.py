#!/usr/bin/env python3
"""Time three designs of one MS-BFS level on the levels of a real index build.

    python3 probes/msbfs_step_designs.py       # from the root of a checkout

Needs one CUDA card. It builds ``chip_smoke.py``'s main workload (the
2**20-vertex community graph, 256 random queries, k in 4..6, from the same
seeds), records the inputs of every ``msbfs_step`` launch of one index
build (two directions, six hops), and runs each level through

- ``kept``: ``msbfs_step_cuda``, the kernel the port uses
  (``csrc/msbfs_step.cu``);
- ``warp_per_vertex``: a warp a vertex, pads dropped by a ballot
  (``csrc/msbfs_step_designs.cu``);
- ``thread_per_word``: a thread per (vertex, word), pads gathered (the same
  file; the port's kernel before its redesign).

Every design must give the kept kernel's new frontier, visited words and
distances exactly. Each level is timed as ``chip_smoke.py`` times
``device_ms``: 50 calls in one CUDA graph, each restoring visited from a
saved copy, less 50 copies alone. The levels run at their width (W = 8
words) and again on their first word only (W = 1, the width of the
``"msbfs"`` delta sweep). Prints the card's name and power limit, a JSON
line per level, and last a JSON line with the sums per design and width.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DESIGNS = ("kept", "warp_per_vertex", "thread_per_word")
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
SIGNATURES = {"step_warp_vertex_launch": _SIG,
              "step_thread_word_launch": _SIG}


def launcher(torch, lib, fn_name: str):
    """A wrapper of one design with ``msbfs_step_cuda``'s signature."""
    from repro_torch.kernels import build
    fn = getattr(lib, fn_name)

    def step(ell, fr, vis, dist, hop):
        V, D = ell.shape
        W = fr.shape[1]
        out = torch.empty((V + 1, W), dtype=torch.int32, device=fr.device)
        rc = fn(ell.data_ptr(), fr.data_ptr(), vis.data_ptr(),
                dist.data_ptr(), out.data_ptr(), V, D, W, hop,
                torch.cuda.current_stream().cuda_stream)
        build.check(lib, rc, fn_name)
        return out
    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--queries", type=int, default=256)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("msbfs_step_designs: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.core import EngineConfig, PathSession
    from repro_torch.core.index import build_index
    from repro_torch.kernels import build
    from repro_torch.kernels.msbfs_expand import ops as mops

    print(cs.smi("name,power.limit"), flush=True)
    lib = build.load("msbfs_step_designs", SIGNATURES)
    steps = {"kept": mops.msbfs_step_cuda,
             "warp_per_vertex": launcher(torch, lib,
                                         "step_warp_vertex_launch"),
             "thread_per_word": launcher(torch, lib,
                                         "step_thread_word_launch")}
    g, queries = cs.phase_workload(args.n, args.queries)
    session = PathSession(g, EngineConfig(plan_caps=False), device="cuda")
    recorders = cs.make_recorders(torch, ("msbfs_step",))
    with cs.recording(recorders):
        build_index(session.engine.dg, queries)
    del session, g

    sums = {}
    for level, (ell, fr, vis, dist, hop) in enumerate(
            recorders["msbfs_step"].calls):
        line = {"level": level, "hop": hop, "shape": list(ell.shape)}
        for width, (f, v, d) in (
                (fr.shape[1], (fr, vis, dist)),
                (1, (fr[:, :1].contiguous(), vis[:, :1].contiguous(),
                     dist[:, :32].contiguous()))):
            want = None
            times = {}
            for name in DESIGNS:
                v2, d2 = v.clone(), d.clone()
                out = steps[name](ell, f, v2, d2, hop)
                torch.cuda.synchronize()
                if want is None:
                    want = (out, v2, d2)
                cs.require(all(torch.equal(a, b) for a, b in
                               zip((out, v2, d2), want)),
                           f"{name} differs from the kept kernel at level "
                           f"{level}, W = {width}")

                def call(name=name, v2=v2, d2=d2):
                    v2.copy_(v)
                    steps[name](ell, f, v2, d2, hop)
                copy_ms = cs.graph_ms(torch, lambda v2=v2: v2.copy_(v))
                times[name] = cs.graph_ms(torch, call) - copy_ms
                total = sums.setdefault(f"W{width}",
                                        dict.fromkeys(DESIGNS, 0.0))
                total[name] += times[name]
            line[f"W{width}"] = {"new_bits": cs.popcount_total(torch, want[0]),
                                 "device_ms": times}
        cs.emit(line)
    cs.emit({"levels": len(recorders["msbfs_step"].calls),
             "sum_device_ms": sums})
    return 0


if __name__ == "__main__":
    sys.exit(main())
