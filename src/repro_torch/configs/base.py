"""Model/config schema for the assigned architectures.

The port's copy of the reference's config schema (``repro.configs.base``).
Every architecture in the assignment table becomes one frozen ``ModelConfig``
in its own module (``repro_torch/configs/<id>.py``) with the exact dimensions from
the table; ``reduced()`` derives the family-preserving small config used by
the per-arch CPU smoke tests.  Input shapes are separate (``ShapeSpec``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "reduced"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # attention flavor
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sliding_window: int = 0        # 0 = full attention
    local_global_ratio: int = 0    # gemma3: 5 -> pattern (5 local, 1 global)
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25

    # SSM / hybrid (zamba2) / xLSTM
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    hybrid_attn_every: int = 0     # zamba2: shared attn block every k layers
    mlstm_slstm_pattern: int = 0   # xlstm: (k mLSTM, 1 sLSTM) super-blocks

    # encoder-decoder (whisper)
    encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # modality frontend stub: model consumes precomputed embeddings
    frontend: Optional[str] = None  # None | "audio" | "vision"

    norm_eps: float = 1e-5
    vocab_pad_to: int = 1          # pad vocab to a multiple (sharding)
    dtype: str = "bfloat16"
    # remat policy for the layer scan: "full" recomputes everything in bwd
    # (min memory); "dots" saves matmul outputs (jax dots_saveable) trading
    # HBM for ~25% fewer bwd FLOPs — §Perf hillclimb #3.
    remat_policy: str = "full"

    # ---- derived -----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:      # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND rooflines."""
        from repro_torch.models.model import count_params  # lazy: imports torch

        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params

        return count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving tiny config for CPU smoke tests."""
    pattern = max(
        1,
        cfg.hybrid_attn_every or 0,
        cfg.mlstm_slstm_pattern + 1 if cfg.mlstm_slstm_pattern else 0,
        cfg.local_global_ratio + 1 if cfg.local_global_ratio else 0,
    )
    n_layers = 2 * pattern if pattern > 1 else 2
    heads = min(cfg.n_heads, 4)
    kv = max(1, min(cfg.n_kv_heads, heads))
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        n_encoder_layers=2 if cfg.encoder_decoder else 0,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        vocab_pad_to=1,
        n_experts=min(cfg.n_experts, 8),
        experts_per_token=min(cfg.experts_per_token, 2),
        moe_d_ff=32 if cfg.moe_d_ff else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        mrope_sections=(4, 2, 2) if cfg.mrope_sections else None,
        dtype="float32",
    )
