"""Architecture registry of the port: ``get(arch)`` and ``shapes_for``.

A copy of ``repro/configs/__init__.py``: each arch module holds ``CONFIG``
(the published configuration), ``REDUCED`` (a small same-family
configuration for CPU tests), ``SHAPES`` and ``FAMILY``. All five LM
archs, dense and MoE, serve and train in the port
(``models/transformer.py``, ``launch/train.py``); the four GNN archs and
two-tower-retrieval train, and the recsys model serves
(``models/gnn.py``, ``models/recsys.py``, ``launch/steps.py``). The
engine's ``path-engine`` config is not ported yet; asking for it raises
``NotImplementedError`` naming the ROADMAP item that brings it.
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

# the archs whose family has no slice in the port yet -> the ROADMAP item
_NOT_PORTED = {
    "path-engine": "ROADMAP.md queue 1, item 13 (the dry-run launchers, "
                   "launch/dryrun.py)",
}


def get(arch: str):
    """The arch module (``CONFIG``, ``REDUCED``, ``SHAPES``, ``FAMILY``)."""
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported to repro_torch yet: see "
            f"{_NOT_PORTED[arch]}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def shapes_for(arch: str):
    return get(arch).SHAPES
