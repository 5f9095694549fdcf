"""granite-moe-1b-a400m [moe] — hf:ibm-granite/granite-3.0-1b-a400m-base.
32 experts top-8.  24L d_model=1024 16H (GQA kv=8) d_expert=512
vocab=49155."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=8, d_ff=0, vocab=49155,
    n_experts=32, top_k=8, d_expert=512, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=0, vocab=256,
    n_experts=4, top_k=2, d_expert=32, tie_embeddings=True,
    dtype="float32",
)
