"""xlstm-125m [ssm]: 12L d768 4H (kv=4) d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks [arXiv:2405.04517].  d_ff=0: expansion lives inside the blocks."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="xlstm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
        vocab_size=50_304, ssm_expand=2, slstm_every=6, ssm_chunk=128,
        subquadratic=True, tie_embeddings=True, dtype="bfloat16",
        remat="dots",
        # §Perf iteration 2d: a 125M model must NOT be tensor-parallel on a
        # 256-chip pod — wide DP + shard_map'd sLSTM: frac 0.011 -> 0.556
        tp_internals=False, decode_kv_shard="seq",
    )


def reduced() -> ModelConfig:
    return full().replace(n_layers=6, d_model=64, n_heads=4, slstm_every=3,
                          vocab_size=256, ssm_chunk=8, dtype="float32",
                          remat="none", fsdp=False)
