"""Corpus-free fused mine+screen bucket counting (CUDA kernel + plain versions)."""
