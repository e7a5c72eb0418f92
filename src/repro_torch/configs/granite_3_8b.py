"""Granite-3.0-8B (dense, GQA).

[hf:ibm-granite/granite-3.0-2b-base family card; 8B dims] — 40 layers,
d_model 4096, 32 q heads / 8 kv heads, head_dim 128, d_ff 12800,
vocab 49155, tied embeddings.  ``long_500k`` runs the labeled
sliding-window variant.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12800,
        vocab_size=49155,
        act="swiglu",
        tie_embeddings=True,
        rope_theta=10_000.0,
        long_context_variant="swa-4096",
        source="hf:ibm-granite/granite-3.0-2b-base (family card); 8B dims",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        act="swiglu",
        tie_embeddings=True,
        long_context_variant="swa-64",
        source="reduced variant of granite-3-8b",
    )
