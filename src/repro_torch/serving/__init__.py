"""Batched LM serving: the wave scheduler and token sampling."""
