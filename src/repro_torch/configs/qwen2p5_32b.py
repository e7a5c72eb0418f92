"""Qwen2.5-32B (dense, GQA, QKV bias).

[hf:Qwen/Qwen2.5-32B; family card hf:Qwen/Qwen2.5-0.5B] — 64 layers,
d_model 5120, 40 q heads / 8 kv heads, head_dim 128, d_ff 27648,
vocab 152064.  ``long_500k`` runs the labeled sliding-window variant.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=27648,
        vocab_size=152064,
        qkv_bias=True,
        act="swiglu",
        rope_theta=1_000_000.0,
        long_context_variant="swa-4096",
        source="hf:Qwen/Qwen2.5-0.5B (family card); 32B dims",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        qkv_bias=True,
        act="swiglu",
        long_context_variant="swa-64",
        source="reduced variant of qwen2.5-32b",
    )
