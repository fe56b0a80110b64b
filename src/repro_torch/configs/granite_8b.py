"""granite-8b [dense] — llama-arch code model [arXiv:2405.04324; hf]."""
from ..config import LMConfig
from ._shapes import LM_SHAPES as SHAPES  # noqa: F401

CONFIG = LMConfig(name="granite-8b", n_layers=36, d_model=4096, n_heads=32,
                  n_kv_heads=8, d_ff=14336, vocab=49152, qkv_bias=False)

REDUCED = LMConfig(name="granite-8b-reduced", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=160, vocab=256,
                   qkv_bias=False, dtype="float32")

FAMILY = "lm"
