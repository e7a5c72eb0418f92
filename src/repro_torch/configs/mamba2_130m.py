"""Mamba2-130m (SSD — state-space duality, arXiv:2405.21060).

24 layers, d_model 768, attention-free, vocab 50280, ssm_state 128,
head_dim 64 (expand 2 → 1536 inner → 24 SSD heads).  Natively O(1)-state:
all decode shapes including ``long_500k`` run in the recurrent form.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=1,       # unused (attention-free)
        n_kv_heads=1,    # unused
        head_dim=64,
        d_ff=0,          # no MLP in the Mamba2 stack
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_chunk=128,
        ssm_expand=2,
        conv_width=4,
        tie_embeddings=True,
        source="arXiv:2405.21060 (Mamba2 SSD); hf:state-spaces/mamba2-130m",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        n_layers=2,
        d_model=128,
        n_heads=1,
        n_kv_heads=1,
        head_dim=32,
        d_ff=0,
        vocab_size=512,
        ssm_state=32,
        ssm_head_dim=32,
        ssm_chunk=16,
        ssm_expand=2,
        conv_width=4,
        tie_embeddings=True,
        source="reduced variant of mamba2-130m",
    )
