#!/usr/bin/env python3
"""Time the engine's two batches of ``chip_smoke.py`` on one GPU.

    python3 probes/engine_batches.py NAME      # from the root of a checkout

Needs one CUDA card. It builds the kernels and ``chip_smoke.py``'s
workload (the 2**20-vertex community graph and its 256 random queries,
k in 4..6), then runs two batches under ``planner="batch"``, each once
cold and three times warm on one session: the main batch with
``EngineConfig(plan_caps=False)`` (phase ``main``) and the 64 overlapping
queries of phase ``sharing`` (``similar_queries``, similarity 0.8, k in
7..8) with the default ``EngineConfig()`` (phase ``planners``). Prints
one line, ``AB`` and a JSON object with ``NAME`` and each run's stage
times (``t_build_index``, ``t_cluster``, ``t_detect``, ``t_enumerate``,
``t_wall_s``) and host wall.

To compare two trees on one card, unpack both (``git archive``) and run
the probe from the root of each in turns, in one call: parent, change,
change, parent.
"""
from __future__ import annotations

import json
import os
import sys
import time


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    name = argv[0] if argv else "tree"
    import torch
    if not torch.cuda.is_available():
        print("engine_batches: no CUDA device", file=sys.stderr)
        return 2
    root = os.getcwd()
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke as cs
    from repro_torch.core import EngineConfig, PathSession, generators

    cs.phase_build()
    g, queries = cs.phase_workload(1 << 20, 256)
    sharing = generators.similar_queries(g, 64, similarity=0.8,
                                         k_range=(7, 8), seed=2)
    out = {"tree": name}
    for batch, cfg, qs in (("main_plan_caps_false",
                            EngineConfig(plan_caps=False), queries),
                           ("sharing_default", EngineConfig(), sharing)):
        session = PathSession(g, cfg, device="cuda")
        runs = []
        for _ in range(4):
            t0 = time.perf_counter()
            rep = session.run(qs, planner="batch")
            runs.append(dict({k: rep.stats[k] for k in cs.STAT_KEYS},
                             host_wall_s=time.perf_counter() - t0))
        out[batch] = runs
        del session
    print("AB", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
