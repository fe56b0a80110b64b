"""two-tower-retrieval [recsys] — embed 256, towers 1024-512-256, dot
interaction, sampled softmax [RecSys'19 (YouTube)]."""
from ..config import RecsysConfig
from ._shapes import RECSYS_SHAPES as SHAPES  # noqa: F401

CONFIG = RecsysConfig(name="two-tower-retrieval", embed_dim=256,
                      tower_mlp=(1024, 512, 256), interaction="dot",
                      n_users=5_242_880, n_items=2_097_152, n_user_hist=20)

REDUCED = RecsysConfig(name="two-tower-reduced", embed_dim=16,
                       tower_mlp=(32, 16), interaction="dot",
                       n_users=1000, n_items=500, n_user_hist=5)

FAMILY = "recsys"
