"""mamba2-130m [ssm] — SSD (state-space duality), arXiv:2405.21060.
24L d_model=768, attention-free, vocab=50280, ssm_state=128."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=24, n_kv_heads=24, d_ff=0, vocab=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, conv_kernel=4,
    tie_embeddings=True, norm="rmsnorm",
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm", n_layers=2, d_model=64,
    n_heads=2, n_kv_heads=2, d_ff=0, vocab=128,
    ssm_state=16, ssm_headdim=16, tie_embeddings=True, dtype="float32",
)
