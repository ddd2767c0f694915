"""Masked bucket histogram of the hash screen (CUDA kernel + plain version)."""
