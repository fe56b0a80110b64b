"""meshgraphnet [gnn] — 15L d=128 sum-agg, 2-layer MLPs [arXiv:2010.03409]."""
from ..config import GNNConfig
from ._shapes import GNN_SHAPES as SHAPES  # noqa: F401

CONFIG = GNNConfig(name="meshgraphnet", kind="meshgraphnet", n_layers=15,
                   d_hidden=128, aggregator="sum", mlp_layers=2,
                   extras=(("d_out", 3),))

REDUCED = GNNConfig(name="meshgraphnet-reduced", kind="meshgraphnet",
                    n_layers=2, d_hidden=16, aggregator="sum", mlp_layers=2,
                    extras=(("d_out", 3),))

FAMILY = "gnn"
