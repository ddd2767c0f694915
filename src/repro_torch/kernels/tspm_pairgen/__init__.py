"""Dense transitive pair generation (CUDA kernel + plain version)."""
