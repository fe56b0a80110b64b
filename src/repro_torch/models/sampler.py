"""Neighbor sampler for minibatch GNN training (GraphSAGE fanout sampling).

A numpy copy of ``repro/models/sampler.py``: host-side (part of the input
pipeline, like DGL/PyG samplers). Given roots and per-layer fanouts, it
uniformly samples in-neighbors layer by layer and emits one padded edge
list over the union of the hops plus the union node set with remapped
local ids. Given the same ``np.random.Generator`` it makes the same calls
in the same order as the JAX package's, so its blocks are equal array for
array.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.graph import Graph, pow2_ceil

__all__ = ["SampledBlock", "sample_blocks"]


@dataclasses.dataclass
class SampledBlock:
    node_ids: np.ndarray        # (N_cap,) global ids (-1 pad)
    n_nodes: int
    edge_src: np.ndarray        # (E_cap,) local ids into node_ids
    edge_dst: np.ndarray
    edge_mask: np.ndarray       # (E_cap,) bool
    root_mask: np.ndarray       # (N_cap,) bool -- loss restricted to roots


def sample_blocks(g: Graph, roots: np.ndarray, fanouts: tuple[int, ...],
                  rng: np.random.Generator, node_cap: int | None = None,
                  edge_cap: int | None = None) -> SampledBlock:
    """Union-graph variant: one merged block over all hops (message passing
    runs n_layers times over the union edge set, as in full-graph mode)."""
    frontier = np.unique(roots)
    all_nodes = [frontier]
    src_l, dst_l = [], []
    for f in fanouts:
        deg = g.r_indptr[frontier + 1] - g.r_indptr[frontier]
        reps = np.minimum(deg, f).astype(np.int64)
        dst = np.repeat(frontier, reps)
        # uniform sample without replacement per node (cheap: random offsets)
        offs = []
        for v, r in zip(frontier, reps):
            lo, hi = g.r_indptr[v], g.r_indptr[v + 1]
            if r == hi - lo:
                offs.append(np.arange(lo, hi))
            else:
                offs.append(rng.choice(hi - lo, size=r, replace=False) + lo)
        if offs:
            src = g.r_indices[np.concatenate(offs)] if dst.size else np.zeros(0, np.int64)
        else:
            src = np.zeros(0, np.int64)
        src_l.append(src.astype(np.int64))
        dst_l.append(dst.astype(np.int64))
        frontier = np.unique(src)
        all_nodes.append(frontier)

    nodes = np.unique(np.concatenate(all_nodes))
    remap = {int(v): i for i, v in enumerate(nodes)}
    src = np.concatenate(src_l) if src_l else np.zeros(0, np.int64)
    dst = np.concatenate(dst_l) if dst_l else np.zeros(0, np.int64)
    src_loc = np.array([remap[int(v)] for v in src], np.int32)
    dst_loc = np.array([remap[int(v)] for v in dst], np.int32)

    n_cap = node_cap or pow2_ceil(max(nodes.size, 2))
    e_cap = edge_cap or pow2_ceil(max(src_loc.size, 2))
    node_ids = np.full(n_cap, -1, np.int64)
    node_ids[:nodes.size] = nodes
    es = np.zeros(e_cap, np.int32)
    ed = np.zeros(e_cap, np.int32)
    em = np.zeros(e_cap, bool)
    es[:src_loc.size] = src_loc
    ed[:dst_loc.size] = dst_loc
    em[:src_loc.size] = True
    root_mask = np.zeros(n_cap, bool)
    root_set = set(int(r) for r in roots)
    for i, v in enumerate(nodes):
        if int(v) in root_set:
            root_mask[i] = True
    return SampledBlock(node_ids=node_ids, n_nodes=int(nodes.size),
                        edge_src=es, edge_dst=ed, edge_mask=em,
                        root_mask=root_mask)
