"""zamba2-2.7b [hybrid]: 54L d2560 32H (kv=32) d_ff=10240 ssm_state=64 —
Mamba2 backbone + 2 weight-shared attention blocks (width 2*d = 5120,
32 heads x hd 160), every 6 layers [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
        vocab_size=32_000, ssm_state=64, ssm_heads=80, ssm_expand=2,
        ssm_chunk=128, shared_attn_every=6, n_shared_attn_blocks=2,
        subquadratic=True, tie_embeddings=True, dtype="bfloat16",
        remat="dots",
    )


def reduced() -> ModelConfig:
    return full().replace(n_layers=4, d_model=32, n_heads=4, n_kv_heads=4,
                          d_ff=64, vocab_size=256, ssm_state=16, ssm_heads=4,
                          ssm_chunk=8, shared_attn_every=2, dtype="float32",
                          remat="none", fsdp=False)
