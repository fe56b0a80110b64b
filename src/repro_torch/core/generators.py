"""Synthetic graph generators (offline stand-ins for the paper's datasets).

A numpy copy of ``repro/core/generators.py``: the same graphs and query
workloads for the same seed.

The paper evaluates on SNAP/LAW graphs (Epinions .. Friendster). Those are
not downloadable here, so benchmarks use parameter-matched synthetics:

  * ``powerlaw``  -- directed preferential attachment (Barabási–Albert
                     flavoured); degree tail ~ the social graphs (EP/SL/PO/LJ).
  * ``erdos``     -- uniform random (WT-like sparse).
  * ``community`` -- planted partition: dense intra-community, sparse
                     inter-community edges; gives the *controllable query
                     similarity* used by Exp-1 (queries within a community
                     overlap heavily).
  * ``grid``      -- 2-D torus (road-network-ish diameter, for KSP compares).
"""
from __future__ import annotations

import numpy as np

from .graph import Graph

__all__ = ["powerlaw", "erdos", "community", "grid",
           "random_queries", "similar_queries"]


def powerlaw(n: int, avg_deg: float = 8.0, seed: int = 0,
             alpha: float = 0.7) -> Graph:
    """Directed preferential-attachment-ish graph with power-law in-degree."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    # mixture: fraction alpha prefers low ids (Zipf-ish popularity), rest uniform
    zipf = np.minimum((rng.pareto(1.5, size=m) * n * 0.01).astype(np.int64), n - 1)
    uni = rng.integers(0, n, size=m, dtype=np.int64)
    pick = rng.random(m) < alpha
    dst = np.where(pick, zipf, uni)
    return Graph.from_edges(n, src, dst)


def erdos(n: int, avg_deg: float = 8.0, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    return Graph.from_edges(n, src, dst)


def community(n: int, n_comm: int = 8, avg_deg: float = 10.0,
              p_intra: float = 0.9, seed: int = 0) -> Graph:
    """Planted-partition digraph; queries inside a community share structure."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg)
    comm = rng.integers(0, n_comm, size=n)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    intra = rng.random(m) < p_intra
    # destination drawn from same community (intra) or anywhere (inter)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    # resample intra edges within src's community via bucket trick
    order = np.argsort(comm, kind="stable")
    bucket_start = np.searchsorted(comm[order], np.arange(n_comm))
    bucket_end = np.searchsorted(comm[order], np.arange(n_comm), side="right")
    c = comm[src]
    lo, hi = bucket_start[c], bucket_end[c]
    draw = lo + (rng.random(m) * np.maximum(hi - lo, 1)).astype(np.int64)
    dst = np.where(intra, order[np.minimum(draw, n - 1)], dst)
    return Graph.from_edges(n, src, dst)


def grid(side: int, seed: int = 0) -> Graph:
    """2-D torus, 4 out-neighbors each."""
    n = side * side
    v = np.arange(n, dtype=np.int64)
    x, y = v % side, v // side
    right = ((x + 1) % side) + y * side
    left = ((x - 1) % side) + y * side
    up = x + ((y + 1) % side) * side
    down = x + ((y - 1) % side) * side
    src = np.concatenate([v, v, v, v])
    dst = np.concatenate([right, left, up, down])
    return Graph.from_edges(n, src, dst)


# ----------------------------------------------------------------------
# query workload generators (paper §V Settings)
# ----------------------------------------------------------------------

def random_queries(g: Graph, nq: int, k_range=(4, 7), seed: int = 0,
                   require_reachable: bool = True, max_tries: int = 200):
    """Random (s, t, k) with s reaching t within k hops (paper's default)."""
    from .oracle import bfs_dist_from  # light host BFS

    rng = np.random.default_rng(seed)
    out = []
    tries = 0
    while len(out) < nq and tries < max_tries * nq:
        tries += 1
        s = int(rng.integers(0, g.n))
        k = int(rng.integers(k_range[0], k_range[1] + 1))
        if require_reachable:
            dist = bfs_dist_from(g, s, k)
            cand = np.flatnonzero((dist >= 1) & (dist <= k))
            if cand.size == 0:
                continue
            t = int(cand[rng.integers(0, cand.size)])
        else:
            t = int(rng.integers(0, g.n))
            if t == s:
                continue
        out.append((s, t, k))
    if len(out) < nq:
        raise RuntimeError("could not generate enough reachable queries")
    return out


def similar_queries(g: Graph, nq: int, similarity: float, k_range=(4, 7),
                    seed: int = 0):
    """Workload with tunable overlap (Exp-1): fraction ``similarity`` of the
    queries are drawn from a small set of hub (s, t) seed pairs perturbed to
    1-hop neighbors, the rest uniformly at random."""
    rng = np.random.default_rng(seed)
    base = random_queries(g, max(1, nq // 16), k_range, seed=seed + 1)
    out = []
    for i in range(nq):
        k = int(rng.integers(k_range[0], k_range[1] + 1))
        if rng.random() < similarity:
            s0, t0, _ = base[int(rng.integers(0, len(base)))]
            # perturb to a neighbor of the seed endpoints (keeps Γ overlap high)
            nb_s = g.neighbors(s0, reverse=True)
            nb_t = g.neighbors(t0)
            s = int(nb_s[rng.integers(0, nb_s.size)]) if nb_s.size and rng.random() < 0.5 else s0
            t = int(nb_t[rng.integers(0, nb_t.size)]) if nb_t.size and rng.random() < 0.5 else t0
            if s == t:
                s, t = s0, t0
            out.append((s, t, k))
        else:
            out.extend(random_queries(g, 1, (k, k), seed=seed + 1000 + i))
    return out[:nq]
