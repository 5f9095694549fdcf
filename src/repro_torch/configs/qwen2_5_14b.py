"""qwen2.5-14b [dense] — hf:Qwen/Qwen2.5-14B family.  GQA, QKV bias.
48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=13824, vocab=152064, qkv_bias=True,
    head_dim=128, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke", family="dense", n_layers=3, d_model=80,
    n_heads=5, n_kv_heads=1, d_ff=216, vocab=256, qkv_bias=True,
    head_dim=16, dtype="float32",
)
