"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64e top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]."""
from ..config import LMConfig, MoEConfig
from ._shapes import LM_SHAPES as SHAPES  # noqa: F401

CONFIG = LMConfig(name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048,
                  n_heads=16, n_kv_heads=16, d_ff=1408, vocab=163840,
                  qkv_bias=False,
                  moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408))

REDUCED = LMConfig(name="moonshot-reduced", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=4, d_ff=96, vocab=256,
                   moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96,
                                 capacity_factor=2.0),
                   dtype="float32")

FAMILY = "lm"
