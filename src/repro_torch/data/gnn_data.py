"""Synthetic graph batches for the GNN zoo (offline stand-ins).

A numpy copy of ``repro/data/gnn_data.py``: the same batches for the same
seed, in the formats ``launch/steps.py`` expects: flat padded edge-list
batches (full-graph / sampled blocks) and batched small molecules
(positions + RBF edge features for SchNet). Host numpy arrays; the
launcher moves them to the device.
"""
from __future__ import annotations

import numpy as np

from ..core.graph import Graph
from ..config import GNNConfig, ShapeSpec

__all__ = ["flat_batch", "molecule_batch", "sampled_batch", "rbf_expand"]


def rbf_expand(dist: np.ndarray, n_rbf: int, cutoff: float) -> np.ndarray:
    """SchNet Gaussian radial basis."""
    centers = np.linspace(0.0, cutoff, n_rbf, dtype=np.float32)
    gamma = n_rbf / cutoff
    return np.exp(-gamma * (dist[..., None] - centers) ** 2).astype(np.float32)


def flat_batch(cfg: GNNConfig, shape: ShapeSpec, g: Graph, d_feat: int,
               d_out: int, seed: int = 0, n_pad: int | None = None,
               e_pad: int | None = None) -> dict:
    rng = np.random.default_rng(seed)
    N = n_pad or -(-g.n // 512) * 512
    E = e_pad or -(-g.m // 512) * 512
    src, dst = g.edges_by_dst
    b = {
        "nodes": _padf(rng.standard_normal((g.n, d_feat), dtype=np.float32), N),
        "edge_src": _padi(src, E),
        "edge_dst": _padi(dst, E),
        "edge_mask": _mask(g.m, E),
        "node_mask": _mask(g.n, N),
    }
    if cfg.kind == "schnet":
        pos = rng.standard_normal((g.n, 3)).astype(np.float32) * 3
        d = np.linalg.norm(pos[src] - pos[dst], axis=-1)
        b["edge_rbf"] = _padf(rbf_expand(d, cfg.extra("rbf", 300),
                                         cfg.extra("cutoff", 10.0)), E)
        b["targets"] = _padf(rng.standard_normal(g.n).astype(np.float32), N)
    elif cfg.kind == "graphsage":
        ncls = cfg.extra("n_classes", 41)
        b["labels"] = _padi(rng.integers(0, ncls, g.n), N)
    else:
        b["edge_feat"] = _padf(rng.standard_normal((g.m, 4), dtype=np.float32), E)
        b["targets"] = _padf(
            rng.standard_normal((g.n, d_out), dtype=np.float32), N)
    return b


def sampled_batch(cfg: GNNConfig, g: Graph, roots: np.ndarray,
                  fanouts: tuple[int, ...], d_feat: int, d_out: int,
                  seed: int = 0, n_pad: int | None = None,
                  e_pad: int | None = None) -> dict:
    from ..models.sampler import sample_blocks
    rng = np.random.default_rng(seed)
    blk = sample_blocks(g, roots, fanouts, rng, node_cap=n_pad, edge_cap=e_pad)
    N, E = blk.node_ids.shape[0], blk.edge_src.shape[0]
    feats = rng.standard_normal((N, d_feat)).astype(np.float32)
    b = {"nodes": feats,
         "edge_src": blk.edge_src, "edge_dst": blk.edge_dst,
         "edge_mask": blk.edge_mask,
         "node_mask": blk.node_ids >= 0}
    if cfg.kind == "schnet":
        d = rng.random(E).astype(np.float32) * cfg.extra("cutoff", 10.0)
        b["edge_rbf"] = rbf_expand(d, cfg.extra("rbf", 300),
                                   cfg.extra("cutoff", 10.0))
        b["targets"] = rng.standard_normal(N).astype(np.float32)
    elif cfg.kind == "graphsage":
        b["labels"] = rng.integers(0, cfg.extra("n_classes", 41), N).astype(np.int32)
        b["node_mask"] = blk.root_mask     # loss only on roots
    else:
        b["edge_feat"] = rng.standard_normal((E, 4)).astype(np.float32)
        b["targets"] = rng.standard_normal((N, d_out)).astype(np.float32)
    return b


def molecule_batch(cfg: GNNConfig, n_graphs: int, n_atoms: int, n_edges: int,
                   d_feat: int, d_out: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    B, N, E = n_graphs, n_atoms, n_edges
    pos = rng.standard_normal((B, N, 3)).astype(np.float32) * 2
    src = rng.integers(0, N, (B, E)).astype(np.int32)
    dst = rng.integers(0, N, (B, E)).astype(np.int32)
    b = {"nodes": rng.standard_normal((B, N, d_feat)).astype(np.float32),
         "edge_src": src, "edge_dst": dst,
         "edge_mask": np.ones((B, E), bool),
         "node_mask": np.ones((B, N), bool)}
    if cfg.kind == "schnet":
        d = np.linalg.norm(
            np.take_along_axis(pos, src[..., None], 1)
            - np.take_along_axis(pos, dst[..., None], 1), axis=-1)
        b["atom_types"] = rng.integers(0, 20, (B, N)).astype(np.int32)
        b["edge_rbf"] = rbf_expand(d, cfg.extra("rbf", 300),
                                   cfg.extra("cutoff", 10.0))
        b["targets"] = rng.standard_normal(B).astype(np.float32)
    elif cfg.kind == "graphsage":
        b["labels"] = rng.integers(0, cfg.extra("n_classes", 41),
                                   (B, N)).astype(np.int32)
    else:
        b["edge_feat"] = rng.standard_normal((B, E, 4)).astype(np.float32)
        b["targets"] = rng.standard_normal((B, N, d_out)).astype(np.float32)
    return b


def _padf(x: np.ndarray, n: int) -> np.ndarray:
    pad = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad)


def _padi(x: np.ndarray, n: int) -> np.ndarray:
    return np.pad(x.astype(np.int32), (0, n - x.shape[0]))


def _mask(k: int, n: int) -> np.ndarray:
    m = np.zeros(n, bool)
    m[:k] = True
    return m
