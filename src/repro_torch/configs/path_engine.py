"""The paper's engine as an architecture: billion-edge batch query
processing (the TW/FS-scale graphs of the paper's Table I), a copy of
``repro/configs/path_engine.py``. ``launch/steps.py``'s engine bundle
runs one superstep of it: an MS-BFS hop of the index over the whole graph
and one enumeration expand on the index-pruned subgraph."""
from ..config import PathEngineConfig
from ._shapes import ENGINE_SHAPES as SHAPES  # noqa: F401

CONFIG = PathEngineConfig(name="path-engine", n_vertices=67_108_864,
                          avg_degree=16, n_queries=512, k=6, ell_cap=64)

REDUCED = PathEngineConfig(name="path-engine-reduced", n_vertices=4096,
                           avg_degree=6, n_queries=16, k=4, ell_cap=16)

FAMILY = "engine"
