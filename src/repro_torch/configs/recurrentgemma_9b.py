"""RecurrentGemma-9B (Griffin architecture, arXiv:2402.19427).

38 layers in the 2:1 Griffin pattern (rec, rec, local-attn), d_model 4096,
16 q heads / 1 kv head (MQA) with head_dim 256, d_ff 12288, vocab 256000,
RG-LRU width 4096, local attention window 2048.  Natively sub-quadratic:
``long_500k`` runs without any variant (O(1) recurrent state + 2048-window
rolling KV cache).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256_000,
        block_pattern=("rec", "rec", "attn"),
        lru_width=4096,
        sliding_window=2048,
        conv_width=4,
        act="geglu",
        tie_embeddings=True,
        source="arXiv:2402.19427 (RecurrentGemma); Griffin 2:1 pattern",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke",
        family="hybrid",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        block_pattern=("rec", "attn"),
        lru_width=128,
        sliding_window=32,
        conv_width=4,
        act="geglu",
        tie_embeddings=True,
        source="reduced variant of recurrentgemma-9b",
    )
