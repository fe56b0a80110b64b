"""The model substrate: the dense and MoE transformer, its serving and
training paths (:mod:`.transformer`, :mod:`.moe`). GNN and recsys models
come with a later slice."""
from . import moe, transformer  # noqa: F401
