"""Llama-4 Maverick (400B total / 17B active).

[hf:meta-llama/Llama-4-Scout-17B-16E family card] — 48 layers, d_model 5120,
40 q heads / 8 kv heads (GQA), d_ff 8192 per expert, 128 experts top-1,
vocab 202048.  "Early fusion" multimodality enters as precomputed embeddings
through the ``frontend`` hook (stubbed per the assignment carve-out); the
assigned family is [moe], so the default configuration is text-only.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        n_experts=128,
        experts_per_token=1,
        capacity_factor=1.25,
        # interleaved dense/MoE layers (the published 400B total only adds up
        # with every other layer MoE; all-MoE would be ~778B)
        block_pattern=("attn", "moe"),
        act="swiglu",
        rope_theta=500_000.0,
        long_context_variant="swa-4096",
        source="hf:meta-llama/Llama-4-Scout-17B-16E (Maverick sibling)",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        n_experts=4,
        experts_per_token=1,
        capacity_factor=1.25,
        block_pattern=("attn", "moe"),
        act="swiglu",
        long_context_variant="swa-64",
        source="reduced variant of llama4-maverick-400b-a17b",
    )
