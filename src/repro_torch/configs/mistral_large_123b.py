"""Mistral-Large-Instruct-2407 (123B dense).

[hf:mistralai/Mistral-Large-Instruct-2407] — 88 layers, d_model 12288,
96 q heads / 8 kv heads (GQA), head_dim 128, d_ff 28672, vocab 32768.
The largest *dense* assigned model — the client_serial FL plan is mandatory
(DESIGN.md §4).  ``long_500k`` runs the labeled sliding-window variant.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b",
        family="dense",
        n_layers=88,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=32768,
        act="swiglu",
        rope_theta=1_000_000.0,
        long_context_variant="swa-4096",
        source="hf:mistralai/Mistral-Large-Instruct-2407",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        act="swiglu",
        long_context_variant="swa-64",
        source="reduced variant of mistral-large-123b",
    )
