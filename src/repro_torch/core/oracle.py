"""Brute-force references for tests: pure-Python DFS enumeration + host BFS.

A numpy copy of ``repro/core/oracle.py``.

These are the ground truth every engine variant (BasicEnum, BasicEnum+,
BatchEnum, BatchEnum+) is validated against. Deliberately simple and slow, except
the host BFS: it goes level by level over the CSR arrays (the distances
of the reference's vertex queue), because the query generators run it
on graphs of a million vertices.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

from .graph import Graph, _ragged_arange

__all__ = ["enumerate_paths_bruteforce", "bfs_dist_from", "path_set"]


def bfs_dist_from(g: Graph, s: int, k_max: int, reverse: bool = False) -> np.ndarray:
    """Host BFS distances from s, capped at k_max (unreached = k_max+1)."""
    INF = k_max + 1
    ip, ix = (g.r_indptr, g.r_indices) if reverse else (g.indptr, g.indices)
    dist = np.full(g.n, INF, dtype=np.int32)
    dist[s] = 0
    frontier = np.array([s], dtype=np.int64)
    for hop in range(1, k_max + 1):
        lo = ip[frontier]
        cnt = ip[frontier + 1] - lo
        nbrs = ix[np.repeat(lo, cnt) + _ragged_arange(cnt)]
        frontier = np.unique(nbrs[dist[nbrs] == INF])
        if frontier.size == 0:
            break
        dist[frontier] = hop
    return dist


def enumerate_paths_bruteforce(g: Graph, s: int, t: int, k: int) -> list[tuple[int, ...]]:
    """All simple paths s->t with <= k hops, via recursive DFS."""
    out: list[tuple[int, ...]] = []
    if s == t or k <= 0:
        return out
    # prune with reverse BFS to keep the oracle usable on medium graphs
    dist_t = bfs_dist_from(g, t, k, reverse=True)
    path = [s]
    on_path = {s}

    def dfs(u: int):
        depth = len(path) - 1
        if u == t and depth >= 1:
            out.append(tuple(path))
            return  # extensions of a path through t would revisit t
        if depth == k:
            return
        for v in g.neighbors(u):
            v = int(v)
            if v in on_path:
                continue
            if depth + 1 + dist_t[v] > k:
                continue
            path.append(v)
            on_path.add(v)
            dfs(v)
            path.pop()
            on_path.remove(v)

    dfs(s)
    return out


def path_set(paths: Iterable) -> set[tuple[int, ...]]:
    """Normalize any iterable of paths (lists/arrays) to a set of tuples."""
    out = set()
    for p in paths:
        p = tuple(int(x) for x in np.asarray(p) if int(x) >= 0)
        out.add(p)
    return out
