"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060; hf]."""
from ..config import LMConfig, MoEConfig
from ._shapes import LM_SHAPES as SHAPES  # noqa: F401

CONFIG = LMConfig(name="olmoe-1b-7b", n_layers=16, d_model=2048,
                  n_heads=16, n_kv_heads=16, d_ff=1024, vocab=50304,
                  qkv_bias=False,
                  moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024))

REDUCED = LMConfig(name="olmoe-reduced", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=4, d_ff=96, vocab=256,
                   moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64,
                                 capacity_factor=2.0),
                   dtype="float32")

FAMILY = "lm"
