"""Architecture registry of the port: ``get(arch)`` and ``shapes_for``.

A copy of ``repro/configs/__init__.py``: each arch module holds ``CONFIG``
(the published configuration), ``REDUCED`` (a small same-family
configuration for CPU tests), ``SHAPES`` and ``FAMILY``. All five LM
archs, dense and MoE, serve and train in the port
(``models/transformer.py``, ``launch/train.py``); the four GNN archs and
two-tower-retrieval train, and the recsys model serves
(``models/gnn.py``, ``models/recsys.py``, ``launch/steps.py``), and the engine's
``path-engine`` config runs one billion-edge superstep
(``launch/steps.py``'s engine bundle; ``ASSIGNED`` leaves it out, as in
the JAX package).
"""
from __future__ import annotations

import importlib

__all__ = ["ARCHS", "ASSIGNED", "get", "shapes_for"]

ARCHS = {
    # LM family
    "granite-8b": "granite_8b",
    "qwen1.5-110b": "qwen1_5_110b",
    "qwen2.5-14b": "qwen2_5_14b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    # GNN family
    "meshgraphnet": "meshgraphnet",
    "graphcast": "graphcast",
    "schnet": "schnet",
    "graphsage-reddit": "graphsage_reddit",
    # recsys
    "two-tower-retrieval": "two_tower_retrieval",
    # the paper's engine
    "path-engine": "path_engine",
}

ASSIGNED = [a for a in ARCHS if a != "path-engine"]


def get(arch: str):
    """The arch module (``CONFIG``, ``REDUCED``, ``SHAPES``, ``FAMILY``)."""
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def shapes_for(arch: str):
    return get(arch).SHAPES
