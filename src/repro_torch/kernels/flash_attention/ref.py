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


# ---- the tf32x3 route's operands (plain versions of its pre-pass)

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits) as
    ``cvt.rna.tf32.f32`` rounds: to nearest, ties away from zero, by adding
    half of the dropped 13 bits' range to the magnitude and clearing them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) = (tf32(x), tf32(x - hi)): about 22 bits of x in two TF32s."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def value_key_order(n: int) -> torch.Tensor:
    """The key that each of ``n`` positions (a multiple of 8) of the
    tf32x3 route's transposed V holds: inside each group of 8, position c
    holds key 2c (c < 4) or 2c - 7 (c >= 4) (``vt_key`` in
    ``csrc/flash_attention.cu``).  A thread of a warpgroup holds the score
    accumulator's columns 2t, 2t + 1 of each 8 but the TF32 A fragment's
    k-indices t, t + 4 (t = lane % 4), so with this order the fragment's
    k-index t + 4e meets key 2t + e and P never leaves its registers."""
    c = torch.arange(n) % 8
    return torch.arange(n) - c + torch.where(c < 4, 2 * c, 2 * c - 7)


def tf32x3_operands(k, v):
    """What the tf32x3 pre-pass writes for float32 ``k/v [B,Hkv,Skv,D]``:
    ``ks [2*B*Hkv, Skv, D]`` (TF32 hi planes, then lo planes) and ``vts
    [2*B*Hkv, D, Skv8]``, V transposed (keys contiguous, Skv8 = Skv rounded
    up to 8, zero past Skv) with its keys in ``value_key_order``, hi planes
    then lo planes.  (The main kernel splits q itself, as ``tf32_split``.)"""
    B, Hkv, Skv, D = k.shape
    skv8 = -(-Skv // 8) * 8
    ks = torch.cat(tf32_split(k.reshape(B * Hkv, Skv, D)))
    vp = torch.zeros(B * Hkv, skv8, D, dtype=torch.float32, device=v.device)
    vp[:, :Skv] = v.reshape(B * Hkv, Skv, D)
    vt = vp[:, value_key_order(skv8).to(v.device)].transpose(1, 2)
    return ks, torch.cat(tf32_split(vt))
