"""graphsage-reddit [gnn] — 2L d=128 mean-agg, fanout 25-10 [arXiv:1706.02216]."""
from ..config import GNNConfig
from ._shapes import GNN_SHAPES as SHAPES  # noqa: F401

CONFIG = GNNConfig(name="graphsage-reddit", kind="graphsage", n_layers=2,
                   d_hidden=128, aggregator="mean", mlp_layers=1,
                   extras=(("sample_sizes", (25, 10)), ("n_classes", 41)))

REDUCED = GNNConfig(name="graphsage-reduced", kind="graphsage", n_layers=2,
                    d_hidden=16, aggregator="mean", mlp_layers=1,
                    extras=(("sample_sizes", (5, 3)), ("n_classes", 8)))

FAMILY = "gnn"
