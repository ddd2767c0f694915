"""Blocked online-softmax attention (``csrc/flash_attention.cu``)."""
