"""Encoder-decoder backbone (seamless-m4t-v2's text/speech transformer).

The twin of the reference's ``models/encdec.py``.  The modality frontend
is a stub, as in the reference: ``batch['src_embeds'] [B, Ss, d_model]``
arrive precomputed (speech frames or text embeddings) and are cast to
the model's dtype.  The encoder is ``n_enc_layers`` blocks of
non-causal self-attention and an MLP, closed by ``ln_enc``; the decoder
is ``n_dec_layers`` blocks of causal self-attention (with a KV cache when
serving), cross-attention over the encoder's output (``ln_x`` then
``xattn``: keys and values from the memory, no RoPE, no mask) and an
MLP.  The logits are the tied embedding's (``embed``).  RoPE replaces
the original relative positions, as in the reference.

The reference stacks each side's layers and scans them; here ``enc`` and
``dec`` hold the layers in order and a Python loop runs them.  Caches are
``{"attn": [layer] -> {k, v, pos}, "memory": [B, Ss, d_model]}``: prefill
encodes the source and keeps its output in ``memory``; each decode step
reads it and recomputes every layer's cross-attention keys and values
from it, as the reference does (no cross-attention cache).  On the card
the encoder's self-attention and the decoder's cross-attention (Sq = St
against Skv = Ss) are the flash kernel without the causal mask; a decode
step's cross-attention (Sq = 1) is ``blocked_sdpa``, as the reference's
dispatch.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models import attention, layers
from repro_torch.models.layers import rmsnorm


class EncLayer(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        dtype = layers.dt(cfg)
        self.ln1 = layers.RMSNorm(cfg.d_model, dtype, device)
        self.attn = attention.Attention(cfg, device)
        self.ln2 = layers.RMSNorm(cfg.d_model, dtype, device)
        self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, dtype, device)

    def init_weights(self, generator):
        for m in self.children():
            m.init_weights(generator)


class DecLayer(EncLayer):
    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        self.ln_x = layers.RMSNorm(cfg.d_model, layers.dt(cfg), device)
        self.xattn = attention.Attention(cfg, device)


class EncDec(nn.Module):
    """The parameters, allocated (zeros) on ``device``; ``init_weights``
    fills them from a generator on that device."""

    def __init__(self, cfg, device):
        super().__init__()
        dtype = layers.dt(cfg)
        self.cfg = cfg
        self.embed = layers.Embedding(cfg.vocab_size, cfg.d_model, dtype, device)
        self.enc = nn.ModuleList(EncLayer(cfg, device) for _ in range(cfg.n_enc_layers))
        self.dec = nn.ModuleList(DecLayer(cfg, device) for _ in range(cfg.n_dec_layers))
        self.ln_enc = layers.RMSNorm(cfg.d_model, dtype, device)
        self.ln_f = layers.RMSNorm(cfg.d_model, dtype, device)

    def init_weights(self, generator):
        self.embed.init_weights(generator)
        for m in (*self.enc, *self.dec):
            m.init_weights(generator)
        self.ln_enc.init_weights()
        self.ln_f.init_weights()
        return self


def init(generator, cfg, device) -> EncDec:
    with torch.no_grad():
        return EncDec(cfg, device).init_weights(generator)


def _remat(cfg) -> bool:
    """Checkpoint each layer (``torch.utils.checkpoint``, non-reentrant)
    where the reference wraps its scan body in ``jax.checkpoint``: under
    ``cfg.remat != 'none'``, with gradients enabled.  The values are the
    same either way."""
    return cfg.remat != "none" and torch.is_grad_enabled()


def _positions(b, s, device):
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def encode(p: EncDec, src_embeds, cfg):
    """The encoder's output ``[B, Ss, d_model]`` in the model's dtype."""
    x = torch.as_tensor(src_embeds, device=p.embed.table.device).to(layers.dt(cfg))
    positions = _positions(*x.shape[:2], x.device)

    def body(y, lp):
        h, _ = attention.apply(lp.attn, rmsnorm(lp.ln1, y, cfg.norm_eps), cfg,
                               positions=positions, causal=False)
        y = y + h
        return y + layers.mlp(lp.mlp, rmsnorm(lp.ln2, y, cfg.norm_eps), cfg.mlp_act)

    remat = _remat(cfg)
    for lp in p.enc:
        x = (torch.utils.checkpoint.checkpoint(body, x, lp, use_reentrant=False)
             if remat else body(x, lp))
    return rmsnorm(p.ln_enc, x, cfg.norm_eps)


def _dec_layer(lp: DecLayer, x, memory, cfg, positions, cache=None):
    h, new_cache = attention.apply(lp.attn, rmsnorm(lp.ln1, x, cfg.norm_eps), cfg,
                                   positions=positions, cache=cache)
    x = x + h
    hx, _ = attention.apply(lp.xattn, rmsnorm(lp.ln_x, x, cfg.norm_eps), cfg,
                            positions=positions, causal=False, memory=memory)
    x = x + hx
    x = x + layers.mlp(lp.mlp, rmsnorm(lp.ln2, x, cfg.norm_eps), cfg.mlp_act)
    return x, new_cache


def _logits(p: EncDec, x, cfg):
    return layers.embed_logits(p.embed, rmsnorm(p.ln_f, x, cfg.norm_eps), cfg.final_softcap)


def apply(p: EncDec, batch, cfg, *, mode="train", caches=None):
    """batch: ``src_embeds [B, Ss, d_model]`` (not read by a decode step
    with caches) and target ``tokens [B, St]``.

    mode 'train': (logits, 0), differentiable, each layer checkpointed
    under ``cfg.remat``.  mode 'prefill': (last-position logits, caches
    holding the memory) with caches from ``init_caches``, else (those
    logits, 0).  mode 'decode' (``tokens [B, 1]``): the memory from the
    caches, the position from the first layer's ``pos`` -> (logits,
    caches).  Prefill and decode run without gradients."""
    if mode in ("prefill", "decode"):
        return _serve(p, batch, cfg, mode=mode, caches=caches)
    memory = encode(p, batch["src_embeds"], cfg)
    x = layers.embed_lookup(p.embed, batch["tokens"], cfg.embed_scale)
    positions = _positions(*x.shape[:2], x.device)

    def body(y, lp):
        return _dec_layer(lp, y, memory, cfg, positions)[0]

    remat = _remat(cfg)
    for lp in p.dec:
        x = (torch.utils.checkpoint.checkpoint(body, x, lp, use_reentrant=False)
             if remat else body(x, lp))
    return _logits(p, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def _serve(p: EncDec, batch, cfg, *, mode, caches):
    with_cache = caches is not None
    if with_cache and mode == "decode":
        memory = caches["memory"]
    else:
        memory = encode(p, batch["src_embeds"], cfg)
    x = layers.embed_lookup(p.embed, batch["tokens"], cfg.embed_scale)
    b, st = x.shape[:2]
    if mode == "decode":
        positions = torch.full((b, 1), caches["attn"][0]["pos"], dtype=torch.int32,
                               device=x.device)
    else:
        positions = _positions(b, st, x.device)
    new_attn = []
    for i, lp in enumerate(p.dec):
        x, nc = _dec_layer(lp, x, memory, cfg, positions,
                           caches["attn"][i] if with_cache else None)
        new_attn.append(nc)
    if mode == "prefill":
        x = x[:, -1:]
    logits = _logits(p, x, cfg)
    if with_cache:
        return logits, {"attn": new_attn, "memory": memory}
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def init_caches(cfg, batch, max_len, src_len, *, device="cuda"):
    """One ``{k, v, pos}`` cache per decoder layer and a zero memory of
    ``src_len`` source positions (prefill replaces it with the
    encoder's output)."""
    return {"attn": [attention.init_cache(cfg, batch, max_len, device=device)
                     for _ in range(cfg.n_dec_layers)],
            "memory": torch.zeros((batch, src_len, cfg.d_model), dtype=layers.dt(cfg),
                                  device=device)}
