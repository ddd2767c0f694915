"""gemma2-2b [dense]: 26L d2304 8H (kv=4) d_ff=9216 vocab=256000 —
local(4096)/global alternating, attn softcap 50 / final softcap 30,
GeGLU, post-norms, scaled tied embeddings [arXiv:2408.00118]."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_ff=9216,
        head_dim=256, vocab_size=256_000, local_global=True,
        sliding_window=4096, attn_softcap=50.0, final_softcap=30.0,
        post_norms=True, mlp_act="gelu", embed_scale=True,
        tie_embeddings=True, dtype="bfloat16", remat="dots",
        # §Perf iteration 1: sequence-sharded KV cache (flash-decode):
        # decode collective bytes 14.7GiB -> 48MiB per device per step
        decode_kv_shard="seq",
    )


def reduced() -> ModelConfig:
    return full().replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256,
                          sliding_window=16, dtype="float32", remat="none",
                          fsdp=False)
