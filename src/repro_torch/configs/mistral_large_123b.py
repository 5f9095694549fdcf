"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407.
88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense", n_layers=88, d_model=12288,
    n_heads=96, n_kv_heads=8, d_ff=28672, vocab=32768, head_dim=128,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="mistral-smoke", family="dense", n_layers=3, d_model=96,
    n_heads=6, n_kv_heads=2, d_ff=224, vocab=128, head_dim=16,
    dtype="float32",
)
