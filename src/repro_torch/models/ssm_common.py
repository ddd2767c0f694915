"""Chunked scalar-decay linear recurrence, shared by mLSTM and Mamba2 SSD.

The twin of the reference's ``models/ssm_common.py``.  Per (batch, head):

    C_t = f_t * C_{t-1} + k_t v_t^T,   n_t = f_t * n_{t-1} + k_t,
    y_t = q_t @ C_t                    (+ the normalizer q_t . n_t)

with a data-dependent decay ``f_t = exp(log_f_t)`` in (0, 1].  The
sequence is cut into chunks of ``c``: within a chunk the weights
``exp(A_t - A_s)`` (``A`` the cumulative ``log_f``) give the outputs as
products, and a chunk's state carries into the next.  The reference
scans the chunks with ``lax.scan``; here a Python loop walks them, the
same arithmetic in the same order.  The scan and its state are float32
whatever the inputs' dtype, on either device (TF32 stays off: PyTorch's
default for float32 matmuls).

The chunk rule is the reference's: ``c = min(chunk, S)``, and one chunk
of ``S`` when ``S`` is no multiple of ``c``.  Results and their rounding
follow it, so the port keeps it; its ``[B, H, S, S]`` weights then cost
``S^2`` memory, which the serving engine's waves (one prompt length, a
multiple of the chunk at full size) avoid.

No TPU kernel computes any of this (the reference leaves it to XLA), so
the port keeps it as plain PyTorch on both devices.

One difference from the reference, in gradients only: the reference
takes ``where(tri, exp(A_t - A_s), 0)``, whose gradient is NaN once a
chunk's cumulative log-decay passes ~88 (``exp`` overflows above the
diagonal, and the masked entries' zero cotangent times inf is NaN), as
at zamba2-2.7b's full widths.  The port masks the exponent before the
``exp``: the same values bit for bit, the same gradients where the
reference's are finite, and finite gradients where the reference's are
NaN (tests/test_torch_ssm.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ScanState(NamedTuple):
    C: torch.Tensor   # [B, H, dk, dv] float32
    n: torch.Tensor   # [B, H, dk] float32


def init_state(b, h, dk, dv, dtype=torch.float32, device="cuda") -> ScanState:
    return ScanState(torch.zeros((b, h, dk, dv), dtype=dtype, device=device),
                     torch.zeros((b, h, dk), dtype=dtype, device=device))


def chunk_len(s: int, chunk: int) -> int:
    """The reference's chunk length for a sequence of ``s``."""
    c = min(chunk, s)
    return s if s % c else c


def chunked_scan(q, k, v, log_f, *, chunk: int = 64, state: ScanState | None = None,
                 normalize: bool = False):
    """q, k [B,S,H,dk]; v [B,S,H,dv]; log_f [B,S,H] (<= 0).

    Returns (y [B,S,H,dv] float32, qn [B,S,H] float32 or None, the final
    ``ScanState``)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    c = chunk_len(s, chunk)
    nc = s // c
    if state is None:
        state = init_state(b, h, dk, dv, device=q.device)

    def chunks(x, d):      # [B,S,H,d] -> [nc, B, H, c, d] float32
        return x.reshape(b, nc, c, h, d).permute(1, 0, 3, 2, 4).float()

    qc, kc, vc = chunks(q, dk), chunks(k, dk), chunks(v, dv)
    fc = log_f.reshape(b, nc, c, h).permute(1, 0, 3, 2).float()   # [nc, B, H, c]
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()

    C, n = state.C, state.n
    ys, qns = [], []
    for i in range(nc):
        qi, ki, vi, fi = qc[i], kc[i], vc[i], fc[i]
        A = torch.cumsum(fi, dim=-1)                          # [B,H,c]
        # the exponent masked before the exp (<= 0 on tril): above the
        # diagonal A_t - A_s > 0 overflows float32 once a chunk's decay
        # passes ~88, and exp's gradient there (inf x 0) would be NaN
        w = torch.exp(torch.where(tri, A[..., :, None] - A[..., None, :],
                                  float("-inf")))            # [B,H,c,c]
        scores = torch.einsum("bhtd,bhsd->bhts", qi, ki) * w
        y = torch.einsum("bhts,bhsv->bhtv", scores, vi)
        decay_in = torch.exp(A)[..., None]                   # [B,H,c,1]
        y = y + torch.einsum("bhtd,bhdv->bhtv", qi * decay_in, C)
        if normalize:
            qns.append(scores.sum(-1) + torch.einsum("bhtd,bhd->bht", qi * decay_in, n))
        w_end = torch.exp(A[..., -1:] - A)                   # [B,H,c]
        end = torch.exp(A[..., -1])
        C = torch.einsum("bhsd,bhsv->bhdv", w_end[..., None] * ki, vi) \
            + C * end[..., None, None]
        n = torch.einsum("bhs,bhsd->bhd", w_end, ki) + n * end[..., None]
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, s, h, dv)
    qn = torch.stack(qns).permute(1, 0, 3, 2).reshape(b, s, h) if normalize else None
    return y, qn, ScanState(C, n)


def decode_step(q, k, v, log_f, state: ScanState, normalize: bool = False):
    """One-token update.  q, k [B,H,dk]; v [B,H,dv]; log_f [B,H]."""
    f = torch.exp(log_f.float())[..., None]
    k32 = k.float()
    C = state.C * f[..., None] + torch.einsum("bhd,bhv->bhdv", k32, v.float())
    n = state.n * f + k32
    q32 = q.float()
    y = torch.einsum("bhd,bhdv->bhv", q32, C)
    qn = torch.einsum("bhd,bhd->bh", q32, n) if normalize else None
    return y, qn, ScanState(C, n)


def causal_conv1d(x, w, b=None):
    """Depthwise causal conv: x [B,S,C], w [K,C] -> [B,S,C], the
    reference's shift-and-add: each tap's product in ``x``'s dtype, summed
    tap after tap from the oldest (not ``conv1d``, whose bfloat16 sums
    round elsewhere)."""
    k, s = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    y = xp[:, 0:s] * w[0]
    for j in range(1, k):
        y = y + xp[:, j:j + s] * w[j]
    if b is not None:
        y = y + b
    return y


def conv_decode_step(x_t, conv_state, w, b=None):
    """x_t [B,C]; conv_state [B,K-1,C] (previous inputs, oldest first).
    The reference's ``einsum('bkc,kc->bc')``: the window's products summed
    in float32 and rounded once to ``x_t``'s dtype."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)       # [B,K,C]
    y = (window.float() * w.float()).sum(1).to(x_t.dtype)
    if b is not None:
        y = y + b
    return y, window[:, 1:]
