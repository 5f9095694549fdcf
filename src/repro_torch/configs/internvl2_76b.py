"""internvl2-76b [vlm] — InternViT + InternLM2 backbone, arXiv:2404.16821.
80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (n_img_tokens, d_model) that replace the sequence prefix."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256, head_dim=128,
    n_img_tokens=256,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=176, vocab=256, head_dim=16,
    n_img_tokens=8, dtype="float32",
)
