"""recurrentgemma-2b [hybrid] — RG-LRU + local attention 1:2,
arXiv:2402.19427.  26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000, window=2048."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_ff=7680, vocab=256000, head_dim=256,
    pattern=("rec", "rec", "attn"), window=2048, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="rgemma-smoke", family="hybrid", n_layers=5, d_model=64,
    n_heads=4, n_kv_heads=1, d_ff=176, vocab=256, head_dim=16,
    pattern=("rec", "rec", "attn"), window=16, tie_embeddings=True,
    dtype="float32",
)
