"""tspm-mlho: the paper's own downstream config — a compact dense LM
trained on tSPM+-mined clinical event streams (the MLHO-workflow model,
also the ~100M end-to-end training config)."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="tspm-mlho", family="dense",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=3072,
        vocab_size=4096, tie_embeddings=True, dtype="float32", remat="none",
    )


def reduced() -> ModelConfig:
    return full().replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=512, fsdp=False)
