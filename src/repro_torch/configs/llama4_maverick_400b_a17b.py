"""llama4-maverick-400b-a17b [moe]: 48L d5120 40H (kv=8) d_ff=8192
vocab=202048, 128 routed experts top-1 + 1 shared, MoE interleaved with
dense layers (step 2, as published) [hf:meta-llama/Llama-4-*]."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
        head_dim=128, vocab_size=202_048, n_experts=128, n_shared_experts=1,
        experts_per_token=1, moe_d_ff=8192, moe_interleave=2,
        tie_embeddings=False, dtype="bfloat16", remat="dots",
    )


def reduced() -> ModelConfig:
    return full().replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256, n_experts=8,
                          experts_per_token=1, moe_d_ff=64, dtype="float32",
                          remat="none", fsdp=False)
