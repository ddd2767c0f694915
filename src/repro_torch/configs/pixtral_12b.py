"""pixtral-12b [vlm]: 40L d5120 32H (kv=8) d_ff=14336 vocab=131072 —
mistral-nemo decoder; the pixtral-ViT frontend is a STUB: input_specs()
provides precomputed patch embeddings [hf:mistralai/Pixtral-12B-2409]."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
        head_dim=128, vocab_size=131_072, n_patches=1024, frontend_dim=1024,
        tie_embeddings=False, dtype="bfloat16", remat="dots",
    )


def reduced() -> ModelConfig:
    return full().replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256, n_patches=8,
                          frontend_dim=32, dtype="float32", remat="none",
                          fsdp=False)
