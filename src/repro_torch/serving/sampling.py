"""Token sampling: greedy / temperature / top-k.

Greedy takes the first maximal index, as ``jnp.argmax`` does.  Sampling
draws from an explicit ``torch.Generator`` on the logits' device; it
cannot reproduce ``jax.random.categorical``'s draws, only its law.
"""
from __future__ import annotations

import torch


def sample(logits, generator=None, temperature: float = 0.0, top_k: int = 0):
    """logits [B, V] -> tokens [B] int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k:
        cut = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < cut, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
