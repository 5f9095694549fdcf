"""Model configuration: one dataclass for all ten architectures, copied from
``repro.models.config`` field for field so the configs read the same.

The port runs every family: dense, MoE, SSM, hybrid, VLM and the audio
enc-dec.  ``moe_impl`` is read and takes the grouped dense dispatch for
each of its values (one GPU has no mesh).  ``remat`` is read by a
forward that needs a gradient (``"full"`` or ``"none"``; the other
policies and ``remat_chunks > 1`` raise, see
``transformer.remat_layers``); ``seq_sp``, a sharding knob, is kept as a
field only.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                     # 0 -> d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"
    activation: str = "swiglu"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    max_seq: int = 32768

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    moe_capacity: float = 1.25
    moe_impl: str = "auto"
    seq_sp: str = "auto"
    remat: str = "full"
    remat_chunks: int = 0

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4

    # hybrid (RecurrentGemma): repeating unit of mixers
    pattern: tuple[str, ...] = ()
    window: int = 0

    # enc-dec (Whisper)
    enc_layers: int = 0
    n_frames: int = 1500

    # VLM
    n_img_tokens: int = 0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 (padded ids are never
        emitted by the data pipeline)."""
        return -(-self.vocab // 256) * 256

    @property
    def unit(self) -> tuple[str, ...]:
        """Repeating layer-kind unit."""
        if self.family == "ssm":
            return ("ssm",)
        if self.family == "hybrid":
            return self.pattern or ("rec", "rec", "attn")
        if self.family == "moe":
            return ("moe",)
        return ("dense",)                 # dense / vlm / audio backbones

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.unit)

    @property
    def remainder(self) -> tuple[str, ...]:
        return self.unit[: self.n_layers % len(self.unit)]

    @property
    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        mlp_mults = 3 if self.activation == "swiglu" else 2
        dense_mlp = mlp_mults * d * self.d_ff
        moe_mlp = self.n_experts * mlp_mults * d * self.d_expert \
            + d * self.n_experts
        per = {"dense": attn + dense_mlp,
               "moe": attn + moe_mlp,
               "ssm": self._ssm_params(),
               "rec": self._rec_params() + dense_mlp,
               }
        total = 0
        unit = self.unit
        for i in range(self.n_layers):
            kind = unit[i % len(unit)]
            if kind == "attn":
                kind = "dense"
            total += per.get(kind, attn + dense_mlp)
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "audio":
            total += self.enc_layers * (attn + dense_mlp) * 2  # +cross-attn
        return total

    def _ssm_params(self) -> int:
        d_in = self.ssm_expand * self.d_model
        conv_dim = d_in + 2 * self.ssm_state
        proj_in = self.d_model * (2 * d_in + 2 * self.ssm_state
                                  + d_in // self.ssm_headdim)
        return proj_in + conv_dim * self.conv_kernel + d_in * self.d_model

    def _rec_params(self) -> int:
        d = self.d_model
        return 3 * d * d + d * self.conv_kernel  # in/gate/out + conv

    @property
    def active_param_count(self) -> int:
        """N_active for MoE rooflines (experts scaled by top_k/E)."""
        if self.family != "moe":
            return self.param_count
        d = self.d_model
        mlp_mults = 3 if self.activation == "swiglu" else 2
        attn = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * self.head_dim * d
        active_mlp = self.top_k * mlp_mults * d * self.d_expert
        total = self.n_layers * (attn + active_mlp + d * self.n_experts)
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        return total
