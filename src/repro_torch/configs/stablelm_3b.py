"""stablelm-3b [dense] — hf:stabilityai/stablelm family.
32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=6912, vocab=50304,
    norm="layernorm",
)

SMOKE = ModelConfig(
    name="stablelm-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=176, vocab=256, norm="layernorm",
    dtype="float32",
)
