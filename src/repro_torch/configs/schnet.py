"""schnet [gnn] — 3 interactions d=64, rbf=300, cutoff=10 [arXiv:1706.08566]."""
from ..config import GNNConfig
from ._shapes import GNN_SHAPES as SHAPES  # noqa: F401

CONFIG = GNNConfig(name="schnet", kind="schnet", n_layers=3, d_hidden=64,
                   aggregator="sum", mlp_layers=2,
                   extras=(("rbf", 300), ("cutoff", 10.0), ("d_out", 1)))

REDUCED = GNNConfig(name="schnet-reduced", kind="schnet", n_layers=2,
                    d_hidden=16, aggregator="sum", mlp_layers=2,
                    extras=(("rbf", 32), ("cutoff", 10.0), ("d_out", 1)))

FAMILY = "gnn"
