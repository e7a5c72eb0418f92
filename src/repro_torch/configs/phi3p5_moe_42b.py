"""Phi-3.5-MoE-instruct (42B total / 6.6B active).

[hf:microsoft/Phi-3.5-MoE-instruct] — 32 layers, d_model 4096, 32 q heads /
8 kv heads (GQA), d_ff 6400 per expert, 16 experts top-2, vocab 32064.
``long_500k`` runs only under the labeled sliding-window variant (full
attention cannot hold a 512k cache) — DESIGN.md §5.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab_size=32064,
        n_experts=16,
        experts_per_token=2,
        capacity_factor=1.25,
        act="swiglu",
        rope_theta=10_000.0,
        long_context_variant="swa-4096",
        source="hf:microsoft/Phi-3.5-MoE-instruct",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        n_experts=4,
        experts_per_token=2,
        capacity_factor=1.25,
        act="swiglu",
        long_context_variant="swa-64",
        source="reduced variant of hf:microsoft/Phi-3.5-MoE-instruct",
    )
