"""The model substrate: the dense and MoE transformer, its serving and
training paths (:mod:`.transformer`, :mod:`.moe`), the GNN zoo with its
neighbour sampler (:mod:`.gnn`, :mod:`.sampler`) and the two-tower recsys
model (:mod:`.recsys`), whose gathers and segmented sums add in a fixed
order (:mod:`.segment`)."""
from . import gnn, moe, recsys, sampler, segment, transformer  # noqa: F401
