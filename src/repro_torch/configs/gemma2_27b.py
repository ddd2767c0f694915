"""gemma2-27b [dense]: 46L d4608 32H (kv=16) d_ff=36864 vocab=256000 —
local/global alternating, softcaps, GeGLU [arXiv:2408.00118]."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b", family="dense",
        n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_ff=36864,
        head_dim=128, vocab_size=256_000, local_global=True,
        sliding_window=4096, attn_softcap=50.0, final_softcap=30.0,
        post_norms=True, mlp_act="gelu", embed_scale=True,
        tie_embeddings=True, dtype="bfloat16", remat="dots",
    )


def reduced() -> ModelConfig:
    return full().replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256,
                          sliding_window=16, dtype="float32", remat="none",
                          fsdp=False)
