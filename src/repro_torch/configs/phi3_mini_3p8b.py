"""Phi-3-mini (3.8B dense; arXiv:2404.14219).

32 layers, d_model 3072, 32 q heads / 32 kv heads (full MHA per the
assignment spec), head_dim 96, d_ff 8192, vocab 32064, RoPE + SwiGLU.
``long_500k`` runs the labeled sliding-window variant.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab_size=32064,
        act="swiglu",
        rope_theta=10_000.0,
        long_context_variant="swa-4096",
        source="arXiv:2404.14219 (Phi-3)",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        act="swiglu",
        long_context_variant="swa-64",
        source="reduced variant of phi3-mini-3.8b",
    )
