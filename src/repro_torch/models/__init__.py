"""The model substrate: the dense transformer's serving path
(:mod:`.transformer`). MoE, GNN and recsys models and training come with
later slices."""
from . import transformer  # noqa: F401
