"""qwen1.5-110b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from ..config import LMConfig
from ._shapes import LM_SHAPES as SHAPES  # noqa: F401

CONFIG = LMConfig(name="qwen1.5-110b", n_layers=80, d_model=8192, n_heads=64,
                  n_kv_heads=8, d_ff=49152, vocab=152064, qkv_bias=True)

REDUCED = LMConfig(name="qwen1.5-110b-reduced", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=192, vocab=256,
                   qkv_bias=True, dtype="float32")

FAMILY = "lm"
