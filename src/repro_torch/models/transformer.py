"""Decoder-only transformer LM: the dense, MoE and VLM families.

The reference stacks each pattern position's layers and scans them with
``lax.scan``; here every layer is its own module in ``blocks`` (layer
order: repetition after repetition of the pattern) and a Python loop runs
them.  The reference's sharding hints (``constrain``) have no meaning on
one device and no twin.  Patterns:

  dense uniform        -> ('dense',)
  gemma2 local/global  -> ('local', 'global')
  MoE every layer      -> ('moe',)
  MoE interleave k     -> ('dense', ..., 'moe')

pixtral (family ``'vlm'``) is this same decoder with a projected
patch-embed prefix (``patch_proj``; the ViT frontend is a stub, as in the
reference): ``batch['patch_embeds'] [B, P, frontend_dim]`` go before the
tokens in train and prefill, positions run over the whole sequence, and
decode takes tokens only.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models import attention, layers, moe
from repro_torch.models.layers import rmsnorm


def pattern_of(cfg) -> tuple[str, ...]:
    if cfg.local_global:
        return ("local", "global")
    if cfg.n_experts:
        if cfg.moe_interleave > 1:
            return ("dense",) * (cfg.moe_interleave - 1) + ("moe",)
        return ("moe",)
    return ("dense",)


class Block(nn.Module):
    def __init__(self, cfg, kind, device):
        super().__init__()
        dtype = layers.dt(cfg)
        self.kind = kind
        self.ln1 = layers.RMSNorm(cfg.d_model, dtype, device)
        self.attn = attention.Attention(cfg, device)
        self.ln2 = layers.RMSNorm(cfg.d_model, dtype, device)
        self.ffn = (moe.MoE(cfg, device) if kind == "moe" else
                    layers.MLP(cfg.d_model, cfg.d_ff, dtype, device))
        if cfg.post_norms:
            self.ln1b = layers.RMSNorm(cfg.d_model, dtype, device)
            self.ln2b = layers.RMSNorm(cfg.d_model, dtype, device)

    def init_weights(self, generator):
        for m in self.children():
            m.init_weights(generator)


def layer_apply(p: Block, x, cfg, *, positions, cache=None):
    """-> (x, new_cache, aux): ``aux`` is an MoE layer's balance loss (a
    float32 scalar), None for the other kinds."""
    window = cfg.sliding_window if p.kind == "local" else None
    h, new_cache = attention.apply(
        p.attn, rmsnorm(p.ln1, x, cfg.norm_eps), cfg,
        positions=positions, window=window, cache=cache)
    if cfg.post_norms:
        h = rmsnorm(p.ln1b, h, cfg.norm_eps)
    x = x + h
    f = rmsnorm(p.ln2, x, cfg.norm_eps)
    aux = None
    if p.kind == "moe":
        f, aux = moe.apply(p.ffn, f, cfg)
    else:
        f = layers.mlp(p.ffn, f, cfg.mlp_act)
    if cfg.post_norms:
        f = rmsnorm(p.ln2b, f, cfg.norm_eps)
    return x + f, new_cache, aux


class Transformer(nn.Module):
    """The parameters of a decoder, allocated (zeros) on ``device``;
    ``init_weights`` fills them from a generator on that device."""

    def __init__(self, cfg, device):
        super().__init__()
        pattern = pattern_of(cfg)
        if cfg.n_layers % len(pattern):
            raise ValueError(f"{cfg.n_layers} layers do not repeat {pattern}")
        dtype = layers.dt(cfg)
        self.cfg = cfg
        self.embed = layers.Embedding(cfg.vocab_size, cfg.d_model, dtype, device)
        self.blocks = nn.ModuleList(
            Block(cfg, pattern[i % len(pattern)], device) for i in range(cfg.n_layers))
        self.ln_f = layers.RMSNorm(cfg.d_model, dtype, device)
        self.head = (None if cfg.tie_embeddings else
                     layers.Linear(cfg.d_model, cfg.vocab_size, dtype, device))
        self.patch_proj = (layers.Linear(cfg.frontend_dim, cfg.d_model, dtype, device)
                           if cfg.family == "vlm" else None)

    def init_weights(self, generator):
        self.embed.init_weights(generator)
        for blk in self.blocks:
            blk.init_weights(generator)
        self.ln_f.init_weights()
        for lin in (self.head, self.patch_proj):
            if lin is not None:
                lin.init_weights(generator)
        return self


def init(generator, cfg, device) -> Transformer:
    with torch.no_grad():
        return Transformer(cfg, device).init_weights(generator)


def _embed_inputs(p: Transformer, batch, cfg, *, mode):
    x = layers.embed_lookup(p.embed, batch["tokens"], cfg.embed_scale)
    if cfg.family == "vlm" and mode != "decode" and "patch_embeds" in batch:
        patches = torch.as_tensor(batch["patch_embeds"], device=x.device)
        x = torch.cat([layers.linear(p.patch_proj, patches.to(x.dtype)), x], dim=1)
    return x


def _logits(p: Transformer, x, cfg):
    x = rmsnorm(p.ln_f, x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return layers.embed_logits(p.embed, x, cfg.final_softcap)
    logits = layers.linear(p.head, x)
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _run_layers(p: Transformer, x, cfg, *, positions, caches=None):
    new_caches = []
    for i, blk in enumerate(p.blocks):
        x, nc, _ = layer_apply(blk, x, cfg, positions=positions,
                               cache=None if caches is None else caches[i])
        new_caches.append(nc)
    return x, (new_caches if caches is not None else None)


def _train_layers(p: Transformer, x, cfg, *, positions):
    """The layers over a full sequence -> (x, the sum of the MoE layers'
    aux in layer order, a float32 scalar).  Under ``cfg.remat != 'none'``,
    with gradients enabled, each block is checkpointed: its activations
    are recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant), where the reference wraps its scan body in
    ``jax.checkpoint``.  Either way the values are the same."""
    def layer(y, blk):
        y, _, a = layer_apply(blk, y, cfg, positions=positions)
        return y, a

    remat = cfg.remat != "none" and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in p.blocks:
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(layer, x, blk, use_reentrant=False)
        else:
            x, a = layer(x, blk)
        if a is not None:
            aux = aux + a
    return x, aux


def apply(p: Transformer, batch, cfg, *, mode="train", caches=None):
    """mode 'train': full-sequence (logits, aux), differentiable.
    mode 'prefill': caches required (empty) -> (last-position logits, caches).
    mode 'decode': batch['tokens'] is [B, 1], caches -> (logits, caches).
    ``aux`` is the sum of the MoE layers' balance losses, 0 without MoE
    layers.  Prefill and decode run without gradients (they write the
    caches in place).
    """
    if mode in ("prefill", "decode"):
        return _serve(p, batch, cfg, mode=mode, caches=caches)
    x = _embed_inputs(p, batch, cfg, mode=mode)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    x, aux = _train_layers(p, x, cfg, positions=positions)
    return _logits(p, x, cfg), aux


@torch.no_grad()
def _serve(p: Transformer, batch, cfg, *, mode, caches):
    x = _embed_inputs(p, batch, cfg, mode=mode)
    b, s = x.shape[:2]
    if mode == "decode":
        positions = torch.full((b, 1), caches[0]["pos"], dtype=torch.int32,
                               device=x.device)
        x, new_caches = _run_layers(p, x, cfg, positions=positions, caches=caches)
        return _logits(p, x, cfg), new_caches
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    x, new_caches = _run_layers(p, x, cfg, positions=positions, caches=caches)
    # serving prefill only needs next-token logits (saves a [B,S,V])
    return _logits(p, x[:, -1:], cfg), new_caches


def init_caches(cfg, batch, max_len, *, device="cuda"):
    """One ``{k, v, pos}`` cache per layer, in layer order."""
    return [attention.init_cache(cfg, batch, max_len, device=device)
            for _ in range(cfg.n_layers)]
