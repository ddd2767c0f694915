"""Naive full-softmax attention oracle (f32) with the same mask options, its
log-sum-exp, and its backward.

``attention_ref`` is the plain version of ``csrc/flash_attention.cu`` and
``attention_bwd_ref`` of ``csrc/flash_attention_bwd.cu``: ``ops`` takes
them for CPU tensors, and the tests and the smoke script hold the kernels
against them.  Layout ``[B, H, S, D]``, as the reference's
``kernels/flash_attention/ref.attention_ref``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _scores(q, k, *, causal=True, window=None, softcap=None, ct=torch.float32):
    """``(s, mask, dcap)`` of ``q [B,Hq,Sq,D]`` against ``k [B,Hkv,Skv,D]``
    in dtype ``ct``: the scores after scale and softcap with invisible
    ones at ``NEG_INF``, the visibility mask ``[Sq, Skv]`` and the
    softcap's derivative ``1 - tanh^2`` (None without a softcap)."""
    Sq, D, Skv = q.shape[2], q.shape[3], k.shape[2]
    kq = k.to(ct).repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), kq) * D ** -0.5
    dcap = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
        dcap = 1 - t * t
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= kj
    if window is not None:
        mask &= (qi - kj) < window
    return torch.where(mask, s, NEG_INF), mask, dcap


def _lse(s, mask):
    """Each row's log-sum-exp over its visible scores; +inf where it sees
    none (so exp(s - lse) is 0 there)."""
    m = s.amax(-1, keepdim=True)
    l = torch.where(mask, torch.exp(s - m), 0.0).sum(-1, keepdim=True)
    return torch.where(l > 0, m + torch.log(l), torch.inf).squeeze(-1)


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  softcap: float | None = None, return_lse: bool = False):
    """``o`` in q's dtype (float32 arithmetic); with ``return_lse`` also
    each row's log-sum-exp, float32 ``[B, Hq, Sq]`` in natural-log units
    over the scores after scale, softcap and mask (+inf for a row that sees
    no key): what the kernels write when given a log-sum-exp pointer."""
    s, mask, _ = _scores(q, k, causal=causal, window=window, softcap=softcap,
                         ct=torch.float32)
    vq = v.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    o = torch.einsum("bhqk,bhkd->bhqd",
                     p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30), vq)
    if return_lse:
        return o.to(q.dtype), _lse(s, mask)
    return o.to(q.dtype)


def attention_lse_ref(q, k, *, causal: bool = True, window: int | None = None,
                      softcap: float | None = None):
    """``attention_ref``'s log-sum-exp, computed in float64 for float64
    inputs and in float32 otherwise (the backward's limit takes both)."""
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    return _lse(*_scores(q, k, causal=causal, window=window, softcap=softcap, ct=ct)[:2])


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


# ---- the backward (plain version of csrc/flash_attention_bwd.cu)

def attention_bwd_ref(q, k, v, o, do, lse, *, causal: bool = True,
                      window: int | None = None, softcap: float | None = None):
    """Gradients ``(dq, dk, dv)`` of ``attention_ref`` at ``(q, k, v)`` for
    the output gradient ``do``, written out from the forward's output ``o``
    and log-sum-exp ``lse`` (``attention_ref(..., return_lse=True)``): S
    recomputed (softcap included), ``P = exp(S - lse)`` on visible pairs,
    ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P * (dP - rowsum(dO * O))``
    times ``1 - tanh^2(s / cap)`` under the softcap, ``dQ = dS K * scale``,
    ``dK = dS^T Q * scale``, each KV head's gradient summed over its query
    heads.  A row that sees no key (lse = +inf) has P = 0, so it gives and
    gets no gradient.  The arithmetic is float32 (float64 for float64
    inputs); the results take the inputs' dtype."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    group = Hq // Hkv
    scale = D ** -0.5
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    q32, o32, do32 = (t.to(ct) for t in (q, o, do))
    kq = k.to(ct).repeat_interleave(group, dim=1)
    vq = v.to(ct).repeat_interleave(group, dim=1)
    s, mask, dcap = _scores(q, k, causal=causal, window=window, softcap=softcap, ct=ct)
    p = torch.where(mask, torch.exp(s - lse.to(ct)[..., None]), 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, vq)
    ds = p * (dp - (do32 * o32).sum(-1, keepdim=True))
    if dcap is not None:
        ds = ds * dcap
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kq) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q32) * scale

    def per_kv_head(x):           # [B, Hq, Skv, D] -> [B, Hkv, Skv, D]
        return x.reshape(B, Hkv, group, Skv, D).sum(2)

    return dq.to(q.dtype), per_kv_head(dk).to(k.dtype), per_kv_head(dv).to(v.dtype)


# The backward kernel's limit, as the card tests and chip_smoke.py hold it:
# |got - want64| <= BWD_ERR_FACTOR * max(e32, 2^-23 G) + rel |want64|, want64
# the plain version in float64 on the same inputs, e32 the float32 plain
# version's own largest distance from it, G the largest |want64| of dq, dk
# and dv (a floor: where float64 gives an exact 0, as dq of a row with one
# visible key, dS = dP - delta, the kernel's two sums in different orders
# leave a float32 rounding), rel = BWD_BF16_REL for bfloat16 (the one
# rounding of the float32 result; its half ulp is at most 2^-8 |x|) and 0
# for float32.  The factor was set from the kernel's first card run: over
# chip_smoke.py's edge cases its largest error was 4.3 x e32 (float32, GQA
# group 8, dv).  bfloat16 readings reach 0.99 of their limit by
# construction: the rounding alone takes up to 2^-8 |x| (x just above a
# power of two), and the kernel's float32 error, well inside the factor's
# term, adds the rest.
BWD_ERR_FACTOR = 16.0
BWD_BF16_REL = 2.0 ** -8


def attention_bwd_limit(q, k, v, o, do, **kw):
    """The backward kernel's limit at these inputs (comment above):
    ``(want64, want32, e32, limit)``, each a tuple over ``(dq, dk, dv)``:
    the plain version in float64 and in float32 (each from its own
    ``attention_lse_ref``), the float32 one's largest distance from
    float64, and the elementwise bound on ``|got - want64|``."""
    t32 = [t.float() for t in (q, k, v, o, do)]
    t64 = [t.double() for t in (q, k, v, o, do)]
    want32 = attention_bwd_ref(*t32, attention_lse_ref(t32[0], t32[1], **kw), **kw)
    want64 = attention_bwd_ref(*t64, attention_lse_ref(t64[0], t64[1], **kw), **kw)
    rel = BWD_BF16_REL if q.dtype == torch.bfloat16 else 0.0
    floor = 2.0 ** -23 * max(w.abs().max().item() for w in want64)
    e32 = tuple((w32.double() - w64).abs().max().item()
                for w32, w64 in zip(want32, want64))
    limit = tuple(BWD_ERR_FACTOR * max(e, floor) + rel * w64.abs()
                  for e, w64 in zip(e32, want64))
    return want64, want32, e32, limit
