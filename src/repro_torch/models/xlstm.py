"""xLSTM LM: mLSTM (matrix memory, chunked-parallel) and sLSTM blocks.

The twin of the reference's ``models/xlstm.py``.  The mLSTM runs on the
shared chunked scalar-decay recurrence (``ssm_common``) with the xLSTM
normalizer ``h = (q C) / max(|q n|, 1)`` and bounded gates (sigmoid input,
log-sigmoid forget), as the reference.  The sLSTM is the stabilized
exponential-gate cell with per-head block-diagonal recurrent weights,
walked over time one step at a time in float32 (the reference's
``lax.scan``; its ``shard_map`` branch runs only under a mesh, and on one
device it takes the same scan).  The stabilizer ``m`` starts at -10 and
carries across prefill and decode in the state.

No TPU kernel computes any of this: both blocks are plain PyTorch on
either device.  Layer ``rep * len(pattern) + i`` is pattern position
``i``'s ``rep``-th repetition (the reference's ``blk{i}[rep]``); caches
are a tuple by pattern position, each a list by repetition (a
``ScanState`` for an mLSTM, ``{h, c, n, m}`` for an sLSTM), and take no
``max_len``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.models import layers, ssm_common
from repro_torch.models.layers import linear, rmsnorm
from repro_torch.models.mamba2 import softplus


def _dims(cfg):
    di = cfg.d_model * cfg.ssm_expand
    return di, cfg.n_heads, di // cfg.n_heads


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


def _scaled(x, c: float):
    """``x * c`` with ``c`` rounded to ``x``'s dtype first, as JAX's weakly
    typed Python scalar is."""
    return x * float(torch.tensor(c, dtype=x.dtype))


# --- mLSTM block -------------------------------------------------------------
class MLSTM(nn.Module):
    kind = "m"

    def __init__(self, cfg, device):
        super().__init__()
        d = cfg.d_model
        di, h, _ = _dims(cfg)
        dtype = layers.dt(cfg)
        self.ln = layers.RMSNorm(d, dtype, device)
        self.wq = layers.Linear(d, di, dtype, device)
        self.wk = layers.Linear(d, di, dtype, device)
        self.wv = layers.Linear(d, di, dtype, device)
        self.wz = layers.Linear(d, di, dtype, device)
        self.wg = layers.Linear(d, 2 * h, dtype, device)
        self.wo = layers.Linear(di, d, dtype, device)
        self.hn = layers.RMSNorm(di, dtype, device)

    def init_weights(self, generator):
        for m in self.children():
            m.init_weights(generator)


def _mlstm_qkv(p: MLSTM, xn, cfg):
    """-> (q, k scaled by the input gate in k's dtype, v, log_f)."""
    _, h, dh = _dims(cfg)
    b, sq = xn.shape[:2]
    q = _scaled(linear(p.wq, xn).reshape(b, sq, h, dh), dh ** -0.5)
    k = _scaled(linear(p.wk, xn).reshape(b, sq, h, dh), dh ** -0.5)
    v = linear(p.wv, xn).reshape(b, sq, h, dh)
    g = linear(p.wg, xn).reshape(b, sq, h, 2).float()
    log_f = log_sigmoid(g[..., 0])
    i = torch.sigmoid(g[..., 1])
    return q, k * i[..., None].to(k.dtype), v, log_f


def _mlstm_out(p: MLSTM, x, xn, y, qn, cfg):
    b, sq = xn.shape[:2]
    y = y / torch.clamp_min(qn.abs(), 1.0)[..., None]
    y = y.reshape(b, sq, _dims(cfg)[0]).to(x.dtype)
    y = rmsnorm(p.hn, y, cfg.norm_eps) * F.silu(linear(p.wz, xn))
    return x + linear(p.wo, y)


def mlstm_apply(p: MLSTM, x, cfg, state=None):
    xn = rmsnorm(p.ln, x, cfg.norm_eps)
    q, k, v, log_f = _mlstm_qkv(p, xn, cfg)
    y, qn, new_state = ssm_common.chunked_scan(q, k, v, log_f, chunk=cfg.ssm_chunk,
                                               state=state, normalize=True)
    return _mlstm_out(p, x, xn, y, qn, cfg), new_state


def mlstm_decode(p: MLSTM, x, cfg, state):
    """x [B, 1, D]."""
    xn = rmsnorm(p.ln, x, cfg.norm_eps)
    q, k, v, log_f = _mlstm_qkv(p, xn, cfg)
    y, qn, new_state = ssm_common.decode_step(q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], state,
                                              normalize=True)
    return _mlstm_out(p, x, xn, y[:, None], qn[:, None], cfg), new_state


def mlstm_state(cfg, batch, device="cuda"):
    _, h, dh = _dims(cfg)
    return ssm_common.init_state(batch, h, dh, dh, device=device)


# --- sLSTM block -------------------------------------------------------------
class SLSTM(nn.Module):
    kind = "s"

    def __init__(self, cfg, device):
        super().__init__()
        d = cfg.d_model
        di, h, dh = _dims(cfg)
        dtype = layers.dt(cfg)
        self.ln = layers.RMSNorm(d, dtype, device)
        self.wx = layers.Linear(d, 4 * di, dtype, device)
        self.r = layers._param((4, h, dh, dh), dtype, device)
        self.wo = layers.Linear(di, d, dtype, device)
        self.hn = layers.RMSNorm(di, dtype, device)

    def init_weights(self, generator):
        self.ln.init_weights()
        self.wx.init_weights(generator)
        layers.truncnorm_(self.r, self.r.shape[-1] ** -0.5, generator)
        self.wo.init_weights(generator)
        self.hn.init_weights()


def slstm_cell(gates_x, r32, h_prev, c, n, m):
    """One step, float32.  gates_x [B,4,H,dh]; r32 [4,H,dh,dh] (float32);
    states [B,H,dh]."""
    rec = torch.einsum("bhd,ghde->bghe", h_prev, r32)
    zi, ii, fi, oi = (gates_x[:, g].float() + rec[:, g] for g in range(4))
    log_f = log_sigmoid(fi)
    m_new = torch.maximum(log_f + m, ii)
    i_g = torch.exp(ii - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(zi)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(oi) * c_new / torch.clamp_min(n_new, 1.0)
    return h_new, c_new, n_new, m_new


def slstm_state(cfg, batch, device="cuda"):
    _, h, dh = _dims(cfg)
    z = torch.zeros((batch, h, dh), dtype=torch.float32, device=device)
    return {"h": z, "c": z, "n": z, "m": z - 10.0}


def _slstm_scan(gx, r, state):
    """The sequential cell over gx [B,S,4,H,dh] -> (final state, hs [B,S,H,dh])."""
    r32 = r.float()
    h, c, n, m = state["h"], state["c"], state["n"], state["m"]
    hs = []
    for t in range(gx.shape[1]):
        h, c, n, m = slstm_cell(gx[:, t], r32, h, c, n, m)
        hs.append(h)
    return {"h": h, "c": c, "n": n, "m": m}, torch.stack(hs, 1)


def slstm_apply(p: SLSTM, x, cfg, state=None):
    b, sq, _ = x.shape
    di, h, dh = _dims(cfg)
    xn = rmsnorm(p.ln, x, cfg.norm_eps)
    gx = linear(p.wx, xn).reshape(b, sq, 4, h, dh)
    if state is None:
        state = slstm_state(cfg, b, device=x.device)
    new_state, hs = _slstm_scan(gx, p.r, state)
    y = hs.reshape(b, sq, di).to(x.dtype)
    y = rmsnorm(p.hn, y, cfg.norm_eps)
    return x + linear(p.wo, y), new_state


slstm_decode = slstm_apply


# --- full LM ----------------------------------------------------------------
def pattern_of(cfg) -> tuple[str, ...]:
    k = cfg.slstm_every
    if k:
        return ("m",) * (k - 1) + ("s",)
    return ("m",)


class XLSTM(nn.Module):
    """The parameters, allocated (zeros) on ``device``; ``init_weights``
    fills them from a generator on that device."""

    def __init__(self, cfg, device):
        super().__init__()
        pattern = pattern_of(cfg)
        if cfg.n_layers % len(pattern):
            raise ValueError(f"{cfg.n_layers} layers do not repeat {pattern}")
        dtype = layers.dt(cfg)
        self.cfg = cfg
        self.embed = layers.Embedding(cfg.vocab_size, cfg.d_model, dtype, device)
        self.blocks = nn.ModuleList(
            (MLSTM if pattern[i % len(pattern)] == "m" else SLSTM)(cfg, device)
            for i in range(cfg.n_layers))
        self.ln_f = layers.RMSNorm(cfg.d_model, dtype, device)

    def init_weights(self, generator):
        self.embed.init_weights(generator)
        for blk in self.blocks:
            blk.init_weights(generator)
        self.ln_f.init_weights()
        return self


def init(generator, cfg, device) -> XLSTM:
    with torch.no_grad():
        return XLSTM(cfg, device).init_weights(generator)


def init_caches(cfg, batch, max_len=None, *, device="cuda"):
    """A tuple by pattern position of lists by repetition; ``max_len`` is
    ignored (the states do not grow)."""
    pattern = pattern_of(cfg)
    n_rep = cfg.n_layers // len(pattern)
    return tuple([(mlstm_state if kind == "m" else slstm_state)(cfg, batch, device=device)
                  for _ in range(n_rep)] for kind in pattern)


def _layer(blk, x, cfg, state, decode: bool):
    if blk.kind == "m":
        return (mlstm_decode if decode else mlstm_apply)(blk, x, cfg, state)
    return slstm_apply(blk, x, cfg, state)


def _logits(p: XLSTM, x, cfg):
    return layers.embed_logits(p.embed, rmsnorm(p.ln_f, x, cfg.norm_eps), cfg.final_softcap)


def apply(p: XLSTM, batch, cfg, *, mode="train", caches=None):
    """mode 'train': (logits, 0), differentiable; under ``cfg.remat !=
    'none'``, with gradients enabled, each repetition of the pattern is
    checkpointed (``torch.utils.checkpoint``, non-reentrant), as the
    reference checkpoints its scan body.  mode 'prefill' / 'decode' take
    and return caches (``init_caches``); prefill returns the last
    position's logits.  Prefill and decode run without gradients."""
    if mode in ("prefill", "decode"):
        return _serve(p, batch, cfg, mode=mode, caches=caches)
    x = layers.embed_lookup(p.embed, batch["tokens"], cfg.embed_scale)
    n = len(pattern_of(cfg))

    def rep(y, r):
        for blk in p.blocks[r * n:(r + 1) * n]:
            y, _ = _layer(blk, y, cfg, None, False)
        return y

    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for r in range(cfg.n_layers // n):
        x = (torch.utils.checkpoint.checkpoint(rep, x, r, use_reentrant=False) if remat
             else rep(x, r))
    return _logits(p, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def _serve(p: XLSTM, batch, cfg, *, mode, caches):
    x = layers.embed_lookup(p.embed, batch["tokens"], cfg.embed_scale)
    n = len(pattern_of(cfg))
    new = tuple([] for _ in range(n))
    for layer, blk in enumerate(p.blocks):
        rep, i = divmod(layer, n)
        x, st = _layer(blk, x, cfg, caches[i][rep], mode == "decode")
        new[i].append(st)
    if mode == "prefill":
        x = x[:, -1:]
    return _logits(p, x, cfg), new
