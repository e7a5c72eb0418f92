"""Qwen2-VL-72B language backbone (arXiv:2409.12191).

80 layers, d_model 8192, 64 q heads / 8 kv heads (GQA, QKV bias), head_dim
128, d_ff 29568, vocab 152064.  M-RoPE with (t, h, w) frequency sections
(16, 24, 24) over head_dim/2 = 64.  The ViT vision encoder + projector is a
STUB per the assignment carve-out: ``input_specs`` feeds 1024 precomputed
patch embeddings (dynamic-resolution stand-in) that are prepended to the
text tokens.  ``long_500k`` runs the labeled sliding-window variant.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        mrope_sections=(16, 24, 24),
        frontend="vision",
        frontend_tokens=1024,
        act="swiglu",
        rope_theta=1_000_000.0,
        long_context_variant="swa-4096",
        source="arXiv:2409.12191 (Qwen2-VL); hf:Qwen/Qwen2-VL-72B-Instruct",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke",
        family="vlm",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        qkv_bias=True,
        mrope_sections=(4, 6, 6),
        frontend="vision",
        frontend_tokens=16,
        act="swiglu",
        long_context_variant="swa-64",
        source="reduced variant of qwen2-vl-72b",
    )
