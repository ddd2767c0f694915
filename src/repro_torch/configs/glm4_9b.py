"""glm4-9b [dense]: 40L d4096 32H (kv=2) d_ff=13696 vocab=151552 —
partial RoPE (half dims), QKV bias, extreme GQA [hf:THUDM/glm-4-9b]."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
        head_dim=128, vocab_size=151_552, rope_fraction=0.5, qkv_bias=True,
        tie_embeddings=False, dtype="bfloat16", remat="dots",
    )


def reduced() -> ModelConfig:
    return full().replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256,
                          dtype="float32", remat="none", fsdp=False)
