"""Mamba2 (SSD) block on the shared chunked scalar-decay recurrence.

The twin of the reference's ``models/mamba2.py``.  Per head h (state
``[N, P]``), mapped onto ``ssm_common.chunked_scan``:

    decay  f_t = exp(dt_t * A_h)     (A_h = -exp(a_log_h) < 0)
    k_t    = B_t * dt_t               (dt folded into the input)
    v_t    = x_t (head slice)         q_t = C_t
    y_t    = q_t @ S_t + D_h * v_t

B and C are shared across heads (one group); x, B and C pass through a
causal depthwise conv (kernel ``ssm_conv``) and silu; the output is
RMS-normed, gated by silu(z) and projected.  ``a_log``, ``d_skip`` and
``dt_bias`` are float32 whatever ``cfg.dtype`` is, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers, ssm_common
from repro_torch.models.layers import linear, rmsnorm


def _dims(cfg):
    di = cfg.d_model * cfg.ssm_expand
    h = cfg.ssm_heads or max(1, di // 64)
    return di, h, di // h, cfg.ssm_state


def softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``), written out as the
    reference's ``logaddexp``: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


class Mamba2(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        d = cfg.d_model
        di, h, _, n = _dims(cfg)
        conv_dim = di + 2 * n
        dtype = layers.dt(cfg)
        self.ln = layers.RMSNorm(d, dtype, device)
        self.in_proj = layers.Linear(d, 2 * di + 2 * n + h, dtype, device)
        self.conv_w = layers._param((cfg.ssm_conv, conv_dim), dtype, device)
        self.conv_b = layers._param((conv_dim,), dtype, device)
        self.a_log = layers._param((h,), torch.float32, device)
        self.d_skip = layers._param((h,), torch.float32, device)
        self.dt_bias = layers._param((h,), torch.float32, device)
        self.hn = layers.RMSNorm(di, dtype, device)
        self.out_proj = layers.Linear(di, d, dtype, device)

    def init_weights(self, generator):
        self.ln.init_weights()
        self.in_proj.init_weights(generator)
        layers.truncnorm_(self.conv_w, self.conv_w.shape[0] ** -0.5, generator)
        self.conv_b.zero_()
        self.a_log.zero_()
        self.d_skip.fill_(1.0)
        self.dt_bias.zero_()
        self.hn.init_weights()
        self.out_proj.init_weights(generator)


def _split(p: Mamba2, xn, cfg):
    di, h, _, n = _dims(cfg)
    return torch.split(linear(p.in_proj, xn), [di, di + 2 * n, h], dim=-1)


def _ssm_inputs(p: Mamba2, xbc, dt, cfg):
    """xbc [B,S,di+2N] (after the conv and silu); dt [B,S,H] -> q, k, v,
    log_f.  ``dt`` is cast to B's dtype before the product, as in the
    reference."""
    di, h, pdim, n = _dims(cfg)
    b, sq = xbc.shape[:2]
    xc, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    dt = softplus(dt.float() + p.dt_bias)                          # [B,S,H]
    a = -torch.exp(p.a_log)
    log_f = dt * a                                                 # <= 0
    v = xc.reshape(b, sq, h, pdim)
    k = bmat[:, :, None, :] * dt[..., None].to(bmat.dtype)         # [B,S,H,N]
    q = cmat[:, :, None, :].expand(k.shape)
    return q, k, v, log_f


def _out(p: Mamba2, x, y, v, z, cfg):
    """y (float32) plus the skip, cast to ``x``'s dtype before the gated norm."""
    di = _dims(cfg)[0]
    b, sq = z.shape[:2]
    y = y + p.d_skip[None, None, :, None] * v.float()
    y = y.reshape(b, sq, di).to(x.dtype)
    y = rmsnorm(p.hn, y, cfg.norm_eps) * F.silu(z)
    return x + linear(p.out_proj, y)


def apply(p: Mamba2, x, cfg, state=None):
    """x [B,S,D] -> (out, None) without a state (train), or, given the
    state to start from, (out, (conv state [B,K-1,conv], ScanState)) to
    continue with ``decode``: the conv state is the last K-1 inputs before
    the conv."""
    xn = rmsnorm(p.ln, x, cfg.norm_eps)
    z, xbc_pre, dt = _split(p, xn, cfg)
    xbc = F.silu(ssm_common.causal_conv1d(xbc_pre, p.conv_w, p.conv_b))
    q, k, v, log_f = _ssm_inputs(p, xbc, dt, cfg)
    y, _, new_ssm = ssm_common.chunked_scan(q, k, v, log_f, chunk=cfg.ssm_chunk,
                                            state=None if state is None else state[1])
    out = _out(p, x, y, v, z, cfg)
    if state is None:
        return out, None
    k1 = cfg.ssm_conv - 1
    padded = F.pad(xbc_pre, (0, 0, k1, 0))
    return out, (padded[:, -k1:], new_ssm)


def decode(p: Mamba2, x, cfg, state):
    """x [B,1,D]; state = (conv state, ScanState)."""
    conv_state, ssm_state = state
    xn = rmsnorm(p.ln, x, cfg.norm_eps)
    z, xbc, dt = _split(p, xn, cfg)
    y_c, new_conv = ssm_common.conv_decode_step(xbc[:, 0], conv_state, p.conv_w, p.conv_b)
    xbc = F.silu(y_c)[:, None]
    q, k, v, log_f = _ssm_inputs(p, xbc, dt, cfg)
    y, _, new_ssm = ssm_common.decode_step(q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], ssm_state)
    return _out(p, x, y[:, None], v, z, cfg), (new_conv, new_ssm)


def init_state(cfg, batch, dtype=None, device="cuda"):
    """(conv state zeros in ``dtype`` (default the config's), float32 ScanState)."""
    di, h, pdim, n = _dims(cfg)
    conv = torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * n),
                       dtype=dtype or layers.dt(cfg), device=device)
    return conv, ssm_common.init_state(batch, h, n, pdim, device=device)
