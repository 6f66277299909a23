"""The 10 assigned architectures, verbatim from the assignment table.

Each is selectable via ``--arch <id>`` in the launchers.  Sources are noted
per entry; dimensions are NOT altered except vocab padding for 16-way
sharding (whisper only; see DESIGN.md §5).
"""

from __future__ import annotations

from typing import Dict

from .base import ModelConfig

__all__ = ["ARCHS", "get_config", "ARCH_IDS"]


ARCHS: Dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# — dense ——————————————————————————————————————————————————————————————
# granite-20b [arXiv:2405.04324]: llama-arch code model, MQA (kv=1)
GRANITE_20B = _register(ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
))

# minitron-4b [arXiv:2407.14679]: pruned nemotron, GQA kv=8
MINITRON_4B = _register(ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab_size=256000, head_dim=128,
))

# qwen2-72b [arXiv:2407.10671]: GQA kv=8, QKV bias
QWEN2_72B = _register(ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064, head_dim=128, qkv_bias=True,
    rope_theta=1e6,
))

# gemma3-1b [hf:google/gemma-3-1b-pt]: 5:1 local:global, window 512
GEMMA3_1B = _register(ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_ff=6912, vocab_size=262144, head_dim=256,
    sliding_window=512, local_global_ratio=5, rope_theta=1e6,
))

# — hybrid / ssm ————————————————————————————————————————————————————————
# zamba2-2.7b [arXiv:2411.15242]: Mamba2 backbone + shared attn blocks
ZAMBA2_2P7B = _register(ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, hybrid_attn_every=6,
))

# xlstm-1.3b [arXiv:2405.04517]: mLSTM + sLSTM blocks, no FFN (d_ff=0)
XLSTM_1P3B = _register(ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=512,
    mlstm_slstm_pattern=5,  # (5 mLSTM, 1 sLSTM) super-blocks x 8
))

# — audio ———————————————————————————————————————————————————————————————
# whisper-medium [arXiv:2212.04356]: enc-dec, conv frontend stubbed.
# vocab 51865 padded to 51968 for 16-way sharding (DESIGN.md §5).
WHISPER_MEDIUM = _register(ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865, head_dim=64,
    encoder_decoder=True, n_encoder_layers=24, frontend="audio",
    vocab_pad_to=256,
))

# — MoE —————————————————————————————————————————————————————————————————
# llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E]: 16e top-1
LLAMA4_SCOUT = _register(ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    n_experts=16, experts_per_token=1, moe_d_ff=8192, shared_expert=True,
    rope_theta=5e5,
))

# olmoe-1b-7b [arXiv:2409.02060]: 64 experts top-8
OLMOE_1B_7B = _register(ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    n_experts=64, experts_per_token=8, moe_d_ff=1024,
))

# — VLM —————————————————————————————————————————————————————————————————
# qwen2-vl-7b [arXiv:2409.12191]: M-RoPE, patch frontend stubbed
QWEN2_VL_7B = _register(ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128,
    mrope_sections=(16, 24, 24), frontend="vision", rope_theta=1e6,
))

ARCH_IDS = tuple(ARCHS)


def get_config(arch: str) -> ModelConfig:
    try:
        return ARCHS[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; options: {ARCH_IDS}")


# long_500k applicability (DESIGN.md §5): sub-quadratic-capable archs only.
LONG_CONTEXT_ARCHS = ("zamba2-2.7b", "xlstm-1.3b", "gemma3-1b")


def shape_applicable(arch: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True
