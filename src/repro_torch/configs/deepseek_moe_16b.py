"""deepseek-moe-16b [moe]: 28L d2048 16H (kv=16) vocab=102400,
2 shared + 64 routed top-6 fine-grained experts (d_ff_expert=1408)
[arXiv:2401.06066]."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
        vocab_size=102_400, n_experts=64, n_shared_experts=2,
        experts_per_token=6, moe_d_ff=1408, moe_interleave=1,
        tie_embeddings=False, dtype="bfloat16", remat="dots",
        # §Perf iteration 3a: replicated-routing shard_map EP (local-slice
        # dispatch + one psum combine): t_coll 29.5s -> 3.1s
        moe_dispatch="shard_map_ep", decode_kv_shard="seq",
    )


def reduced() -> ModelConfig:
    return full().replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab_size=256, n_experts=8,
                          experts_per_token=2, moe_d_ff=32, dtype="float32",
                          remat="none", fsdp=False)
