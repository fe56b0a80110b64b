"""graphcast [gnn] — encoder-processor-decoder mesh GNN, 16L d=512,
n_vars=227 [arXiv:2212.12794].

Adaptation (DESIGN.md §5): the grid2mesh/mesh2grid bipartite stages of the
original run on *this* cell's assigned graph directly — the processor
(16 message-passing blocks at d=512) operates on the given node/edge set;
the encoder maps shape d_feat -> 512, the decoder emits the 227 variables.
mesh_refinement=6 governs the synthetic icosahedral generator in data/.
"""
from ..config import GNNConfig
from ._shapes import GNN_SHAPES as SHAPES  # noqa: F401

CONFIG = GNNConfig(name="graphcast", kind="graphcast", n_layers=16,
                   d_hidden=512, aggregator="sum", mlp_layers=2,
                   extras=(("d_out", 227), ("mesh_refinement", 6),
                           ("n_vars", 227)))

REDUCED = GNNConfig(name="graphcast-reduced", kind="graphcast", n_layers=2,
                    d_hidden=24, aggregator="sum", mlp_layers=2,
                    extras=(("d_out", 8), ("n_vars", 8)))

FAMILY = "gnn"
