"""qwen2.5-14b [dense] — GQA + QKV bias [hf:Qwen/Qwen2.5-0.5B; hf].

40 q-heads on a 16-way tensor axis: heads padded to 48 in sharded runs
(zeroed, exact no-op; see transformer.padded_heads).
"""
from ..config import LMConfig
from ._shapes import LM_SHAPES as SHAPES  # noqa: F401

CONFIG = LMConfig(name="qwen2.5-14b", n_layers=48, d_model=5120, n_heads=40,
                  n_kv_heads=8, d_ff=13824, vocab=152064, qkv_bias=True,
                  head_dim=128)

REDUCED = LMConfig(name="qwen2.5-14b-reduced", n_layers=2, d_model=60,
                   n_heads=5, n_kv_heads=1, d_ff=144, vocab=256,
                   qkv_bias=True, head_dim=12, dtype="float32")

FAMILY = "lm"
