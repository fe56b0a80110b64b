"""Bit-parallel multi-source BFS (the paper's BuildIndex, Alg 1/4 lines 1-2).

Counterpart of the ELL route of ``repro/core/msbfs.py``: the frontier is
bit-packed (32 sources per int32 word, ``pack_bits`` layout) over the
padded ELL *in*-neighbour table, and one level is ONE fused ``msbfs_step``
launch (expand + visited dedup + distance write). Distances are int8
(``k_max <= K_MAX_INT8``); unreached = INF = k_max + 1.

Direction convention (as in the JAX package): a level relaxes
``next[v] = OR over in-neighbours u of v``, so forward distances on G take
the reverse table ``dg.r_ell_idx`` and distances on G_r take ``dg.ell_idx``.

Like the reference, the sweep runs all k_max levels (no early exit), so a
batch costs exactly k_max launches per direction. ``msbfs_set_dist_ell``
is the set-seeded sweep of the delta path's cache invalidation: one bit
column seeded with a whole vertex set (W = 1 word, 31 of its 32 bits
idle), on the same kernel.
"""
from __future__ import annotations

import torch

from ..kernels.msbfs_expand.ops import msbfs_step, wrap_int32

__all__ = ["msbfs_dist_ell", "msbfs_set_dist_ell", "INF_FOR", "K_MAX_INT8"]

# Largest hop budget the int8 distance representation supports. INF_FOR
# (k_max + 1) must stay representable AND keep headroom below int8 max
# for downstream +1/-offset hop arithmetic (prune tables, splice
# budgets); 120 leaves 127 - 121 = 6 values of slack above the sentinel.
K_MAX_INT8 = 120
_INT8_MAX = 127


def INF_FOR(k_max: int) -> int:
    return k_max + 1


def _check_k_max(k_max: int) -> None:
    """int8-range guard of the sweep: raises before any device work
    instead of computing wrong-radius distances."""
    if not 0 <= int(k_max) <= K_MAX_INT8:
        raise ValueError(
            f"k_max={k_max} out of range for int8 MS-BFS distances: "
            f"requires 0 <= k_max <= K_MAX_INT8={K_MAX_INT8} so the "
            f"sentinel INF_FOR(k_max)={int(k_max) + 1} fits int8 "
            f"(max {_INT8_MAX}) with {_INT8_MAX - K_MAX_INT8 - 1} values "
            f"of headroom above INF for downstream hop arithmetic; "
            f"reduce the hop budget (or bucket it) before the sweep")


def msbfs_dist_ell(ell_in_idx: torch.Tensor, sources: torch.Tensor, *,
                   n: int, k_max: int) -> torch.Tensor:
    """Distances from each source, capped at k_max.

    ell_in_idx : (n, D) or (n+1, D) int32 padded ELL *in*-neighbour table
                 (pad = n; a row n is dropped, never expanded).
    sources    : (S,) int64/int32 vertex ids on the table's device.
    Returns (n+1, S) int8: ``dist[v, i] = min(hops(sources[i] -> v), INF)``,
    row n = INF (the sentinel of padded gathers).
    """
    _check_k_max(k_max)
    device = ell_in_idx.device
    idx = ell_in_idx[:n]
    S = int(sources.shape[0])
    W = -(-S // 32)
    INF = INF_FOR(k_max)
    sources = sources.to(device=device, dtype=torch.int64)
    cols = torch.arange(S, device=device)
    # seed bits straight into packed words: each column sets one distinct
    # bit, so the int64 sum of a word's bits is their OR
    words = torch.zeros((n + 1, W), dtype=torch.int64, device=device)
    words.index_put_((sources, cols // 32),
                     torch.ones_like(cols) << (cols % 32), accumulate=True)
    words[n] = 0                                   # sentinel stays 0
    frontier = wrap_int32(words)                   # (n+1, W)
    visited = frontier[:n].clone()                 # seeds reached at hop 0
    # row n is the INF sentinel; the kernel sees the first n rows
    dist = torch.full((n + 1, W * 32), INF, dtype=torch.int8, device=device)
    dist[sources, cols] = 0
    for hop in range(1, k_max + 1):
        frontier = msbfs_step(idx, frontier, visited, dist[:n], hop)
    return dist[:, :S].contiguous()


def msbfs_set_dist_ell(ell_in_idx: torch.Tensor, seed_mask: torch.Tensor,
                       *, n: int, k_max: int) -> torch.Tensor:
    """Distances from a vertex *set*: ``dist[v] = min over seeds x of
    hops(x -> v)``, capped at k_max.

    ell_in_idx : (n, D) or (n+1, D) int32 padded ELL *in*-neighbour table
                 (pad = n; a row n is dropped, never expanded).
    seed_mask  : (n+1,) int8 in {0, 1} on the table's device (row n is
                 ignored).
    Returns (n+1,) int8 with unreached = INF = k_max + 1, row n = INF.
    """
    _check_k_max(k_max)
    device = ell_in_idx.device
    idx = ell_in_idx[:n]
    INF = INF_FOR(k_max)
    seed = seed_mask.to(device=device) != 0
    seed[n] = False                                # sentinel stays 0
    # one column: the packed word of a vertex is 1 (bit 0) or 0
    frontier = seed.to(torch.int32)[:, None]       # (n+1, 1)
    visited = frontier[:n].clone()                 # seeds reached at hop 0
    dist = torch.full((n + 1, 32), INF, dtype=torch.int8, device=device)
    dist[:n, 0].masked_fill_(seed[:n], 0)
    for hop in range(1, k_max + 1):
        frontier = msbfs_step(idx, frontier, visited, dist[:n], hop)
    return dist[:, 0].contiguous()
