#!/usr/bin/env python3
"""Time the designs of the ops API's two kernels on chip_smoke.py's inputs.

    python3 probes/ops_kernel_designs.py       # from the root of a checkout

Needs one CUDA card. It builds ``chip_smoke.py``'s main workload (the
2**20-vertex community graph and 256 random queries, k in 4..6, from the
same seeds), records the heaviest ``msbfs_step`` frontier of one index
build, and runs the sharing batch (64 overlapping queries, k 7..8) once to
record the half rows of its heaviest splice and keyed joins. Then:

- ``msbfs_expand`` on that frontier (V = 2**20, D = 32, W = 8) through
  ``kept``, the port's kernel (``msbfs_expand_cuda``: the staged level of
  ``csrc/msbfs_step.cu`` without visited and dist), and the designs of
  ``csrc/msbfs_step_designs.cu``: ``staged`` (a copy of the kept
  kernel) and its variants (``occ6``, ``occ8``: registers capped so
  that an SM holds 6 or 8 blocks; ``no_l1``: the gathers kept out of L1,
  6 blocks; ``u4``: four staging loads in flight a lane; ``g8``: eight
  entries unrolled in the gather; ``compact``: each staged row's live
  entries moved to its front by a ballot, then gathered four at a time;
  ``all``: every entry gathered, eight loads in flight; ``last``: the
  gathers L2 evict-last), ``bulk`` (each block's ELL slab
  by 1-D bulk asynchronous copies, double-buffered) and ``thread_word``
  (the port's first kernel); also
  on two variants of the frontier's ELL table that take one cost away:
  every entry a pad (no gathers), and the live entries folded onto the
  first 2**16 rows (the gathers from L2);
- ``path_overlap`` through ``kept`` (``path_overlap_cuda``: dictionary
  counts on the int8 tensor cores, ``csrc/path_join.cu``) and ``compare``
  (the port's first kernel, an ISETP and an IADD per (p, q) pair,
  ``csrc/path_join_designs.cu``) on four inputs: phase ``ops``'s 4096 x
  4096 random rows of 6 (nearly every output 0), the splice join's and
  the keyed join's half rows, 4096 x 4096 rows drawn from the keyed
  join's half rows (overlaps the rule at full size), and the random rows
  with every A entry a pad (an empty dictionary: the output's zeros
  alone) or every B entry a pad (no id found); beside them, ``fill``:
  ``torch.Tensor.zero_`` of a 4096 x 4096 int32 output, the time to write
  the output alone.

Every design must equal the plain version exactly. Each is timed as
``chip_smoke.py`` times a kernel: ``ms``, the CUDA-event median of 10
warm calls (wrapper included), and ``device_ms``, 50 calls in one CUDA
graph, in turns (kept, other, other, kept). Prints the card's name and
power limit, a JSON line per input, and last a JSON line with every time.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
EXPAND_SIG = [_P, _P, _P, _I, _I, _I, _P]
OVERLAP_SIG = [_P, _L, _P, _L, _P, _I, _I, _I, _I, _P]
# the designs of msbfs_expand in csrc/msbfs_step_designs.cu
EXPAND_DESIGNS = ("staged", "staged_occ8", "staged_no_l1",
                  "staged_compact", "staged_compact_occ6",
                  "staged_compact_occ8", "staged_u4", "staged_g8",
                  "staged_all", "staged_last", "bulk", "thread_word")


def expand_design(torch, lib, fn_name: str):
    """A design of ``msbfs_expand`` with ``msbfs_expand_cuda``'s
    signature."""
    from repro_torch.kernels import build
    fn = getattr(lib, fn_name)

    def expand(ell, fr):
        V, D = ell.shape
        W = fr.shape[1]
        out = torch.empty((V + 1, W), dtype=torch.int32, device=fr.device)
        rc = fn(ell.data_ptr(), fr.data_ptr(), out.data_ptr(), V, D, W,
                torch.cuda.current_stream().cuda_stream)
        build.check(lib, rc, fn_name)
        return out
    return expand


def overlap_design(torch, lib, fn_name: str):
    """A design of ``path_overlap`` with ``path_overlap_cuda``'s
    signature."""
    from repro_torch.kernels import build
    fn = getattr(lib, fn_name)

    def overlap(a, b):
        out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32,
                          device=a.device)
        rc = fn(a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
                out.data_ptr(), a.shape[0], b.shape[0], a.shape[1],
                b.shape[1], torch.cuda.current_stream().cuda_stream)
        build.check(lib, rc, fn_name)
        return out
    return overlap


def time_designs(torch, cs, designs: dict, plain, args) -> dict:
    """Each design held to ``plain(*args)`` exactly, then timed in turns:
    the first design, the others, the others again, the first."""
    want = plain(*args)
    for name, fn in designs.items():
        got = fn(*args)
        torch.cuda.synchronize()
        cs.require(torch.equal(got, want),
                   f"{name} differs from the plain version")
    del want
    names = list(designs)
    order = names[:1] + names[1:] + names[1:] + names[:1]
    times = {name: {"ms": [], "device_ms": []} for name in names}
    for name in order:
        fn = designs[name]
        times[name]["ms"].append(cs.cuda_ms(torch, fn, lambda: args))
        times[name]["device_ms"].append(
            cs.graph_ms(torch, lambda fn=fn: fn(*args)))
        torch.cuda.empty_cache()
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--sharing-queries", type=int, default=64)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("ops_kernel_designs: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.core import EngineConfig, PathSession, generators
    from repro_torch.core.index import build_index
    from repro_torch.kernels import build
    from repro_torch.kernels.msbfs_expand import ops as mops
    from repro_torch.kernels.path_join import ops as jops

    print(cs.smi("name,power.limit"), flush=True)
    build.build(build.SOURCES + ("msbfs_step_designs", "path_join_designs"))
    step_lib = build.load("msbfs_step_designs", {
        f"expand_{name}_launch": EXPAND_SIG for name in EXPAND_DESIGNS})
    join_lib = build.load("path_join_designs",
                          {"overlap_compare_launch": OVERLAP_SIG})

    g, queries = cs.phase_workload(args.n, args.queries)
    session = PathSession(g, EngineConfig(plan_caps=False), device="cuda")
    recorders = cs.make_recorders(torch, ("msbfs_step",))
    with cs.recording(recorders):
        build_index(session.engine.dg, queries)
    ell, fr = recorders["msbfs_step"].best[:2]
    del recorders

    share = generators.similar_queries(g, args.sharing_queries,
                                       similarity=0.8, k_range=(7, 8),
                                       seed=2)
    join_rec = cs.join_recorders()
    with cs.recording(join_rec):
        session.run(share, planner="batch")
    sp, ky = join_rec["splice"].best, join_rec["keyed"].best
    cs.require(sp is not None and ky is not None,
               "the sharing batch ran no splice or no keyed join")
    splice = (sp["a"][:, :sp["kw"]["p_col"] + 1],
              sp["b"][:, :sp["kw"]["c_col"] + 1])
    keyed = (ky["a"][:, :ky["kw"]["a_col"] + 1],
             ky["b"][:, :ky["kw"]["b_col"] + 1])
    gen = torch.Generator(device="cuda").manual_seed(1)
    a4k = cs.overlap_rows(torch, g.n, 4096, 6, gen)
    b4k = cs.overlap_rows(torch, g.n, 4096, 6, gen)
    pick = torch.Generator(device="cuda").manual_seed(2)
    keyed_4k = tuple(
        h[torch.randint(0, h.shape[0], (4096,), generator=pick,
                        device="cuda")].contiguous() for h in keyed)
    n_vertices = g.n
    del session, g, join_rec
    torch.cuda.empty_cache()

    results = {}
    V, D = ell.shape
    expand_designs = {"kept": mops.msbfs_expand_cuda}
    for name in EXPAND_DESIGNS:
        expand_designs[name] = expand_design(torch, step_lib,
                                             f"expand_{name}_launch")
    # the row's input, then two that take one cost away: every entry a
    # pad (no gathers: the ELL read and the output alone), and the live
    # entries folded onto the first 2**16 rows (as many gathers, from a
    # 2 MB slice of the frontier that the L2 holds)
    for name, e in (("heaviest_frontier", ell),
                    ("all_pads", torch.full_like(ell, V)),
                    ("l2_resident", torch.where(ell == V, ell,
                                                ell % (1 << 16)))):
        line = {"kernel": "msbfs_expand", "input": name, "V": V, "D": D,
                "W": fr.shape[1], "live_entries": int((e != V).sum()),
                "times": time_designs(torch, cs, expand_designs,
                                      mops.msbfs_expand_ref, (e, fr))}
        cs.emit(line)
        results[f"msbfs_expand_{name}"] = line["times"]
        del e
    del ell, fr

    compare = overlap_design(torch, join_lib, "overlap_compare_launch")
    fill = torch.empty((4096, 4096), dtype=torch.int32, device="cuda")
    fill_ms = {"ms": cs.cuda_ms(torch, fill.zero_),
               "device_ms": cs.graph_ms(torch, fill.zero_)}
    del fill
    cs.emit({"kernel": "fill", "input": "4096 x 4096 int32 zero_", **fill_ms})
    results["fill_4k"] = fill_ms
    pads_a = torch.full_like(a4k, -1)
    pads_b = torch.full_like(b4k, -1)
    for name, (a, b) in (("random_4k", (a4k, b4k)), ("splice", splice),
                         ("keyed", keyed), ("keyed_4k", keyed_4k),
                         ("pads_a_4k", (pads_a, b4k)),
                         ("pads_b_4k", (a4k, pads_b))):
        work = cs.overlap_work(torch, a, b)
        out = jops.path_overlap_ref(a, b)
        line = {"kernel": "path_overlap", "input": name,
                "NA": a.shape[0], "NB": b.shape[0], "LA": a.shape[1],
                "LB": b.shape[1], "ids_below": n_vertices,
                "nonzero": int(torch.count_nonzero(out)),
                "max_count": int(out.max()) if out.numel() else 0, **work,
                "times": time_designs(torch, cs, {
                    "kept": jops.path_overlap_cuda, "compare": compare},
                    jops.path_overlap_ref, (a, b))}
        del out
        cs.emit(line)
        results[f"path_overlap_{name}"] = line["times"]
    cs.emit({"designs": results})
    return 0


if __name__ == "__main__":
    sys.exit(main())
