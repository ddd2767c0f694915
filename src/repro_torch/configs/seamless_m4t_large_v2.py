"""seamless-m4t-large-v2 [audio]: enc-dec, 24L (24 enc + 24 dec), d1024
16H (kv=16) d_ff=8192 vocab=256206 — the speech frontend is a STUB:
input_specs() provides precomputed frame embeddings [arXiv:2308.11596]."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="encdec",
        n_layers=48, n_enc_layers=24, n_dec_layers=24,
        d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
        vocab_size=256_206, tie_embeddings=True, dtype="bfloat16",
        remat="dots",
    )


def reduced() -> ModelConfig:
    return full().replace(n_layers=4, n_enc_layers=2, n_dec_layers=2,
                          d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                          vocab_size=256, dtype="float32", remat="none",
                          fsdp=False)
