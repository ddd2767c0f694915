"""Naive full-softmax attention oracle (f32) with the same mask options.

The plain version of ``csrc/flash_attention.cu``: ``ops.attention`` takes
it for CPU tensors, and the tests and the smoke script hold the kernel
against it.  Layout ``[B, H, S, D]``, as the reference's
``kernels/flash_attention/ref.attention_ref``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  softcap: float | None = None):
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    group = Hq // Hkv
    scale = D ** -0.5
    kq = k.repeat_interleave(group, dim=1).float()
    vq = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= kj
    if window is not None:
        mask &= (qi - kj) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    o = torch.einsum("bhqk,bhkd->bhqd",
                     p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30), vq)
    return o.to(q.dtype)
