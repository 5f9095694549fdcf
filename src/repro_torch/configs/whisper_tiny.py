"""whisper-tiny [audio] — arXiv:2212.04356.  Enc-dec; conv frontend is a
STUB (input_specs() provides precomputed frame embeddings).
4L d_model=384 6H d_ff=1536 vocab=51865.

Fidelity note: real whisper-tiny caps the decoder context at 448; max_seq is
raised here so the assigned decode_32k cache shape is exercised (DESIGN.md).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865, enc_layers=4,
    n_frames=1500, norm="layernorm", activation="gelu",
    tie_embeddings=True, max_seq=32768,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=176, vocab=256, enc_layers=2,
    n_frames=32, norm="layernorm", activation="gelu",
    tie_embeddings=True, max_seq=64, dtype="float32",
)
