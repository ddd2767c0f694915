"""qwen1.5-110b [dense]: 80L d8192 64H (kv=8) d_ff=49152 vocab=152064 —
QKV bias [hf:Qwen/Qwen1.5-110B]."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=49152,
        head_dim=128, vocab_size=152_064, qkv_bias=True,
        tie_embeddings=False, dtype="bfloat16", remat="dots",
    )


def reduced() -> ModelConfig:
    return full().replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256,
                          dtype="float32", remat="none", fsdp=False)
