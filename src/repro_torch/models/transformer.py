"""Decoder-only transformer LM: the dense family.

The reference stacks each pattern position's layers and scans them with
``lax.scan``; here every layer is its own module in ``blocks`` (layer
order: repetition after repetition of the pattern) and a Python loop runs
them.  The reference's sharding hints (``constrain``) have no meaning on
one device and no twin.  Patterns:

  dense uniform        -> ('dense',)
  gemma2 local/global  -> ('local', 'global')
  MoE                  -> not ported (ROADMAP queue 1, item 17)
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models import attention, layers
from repro_torch.models.layers import rmsnorm


def pattern_of(cfg) -> tuple[str, ...]:
    if cfg.local_global:
        return ("local", "global")
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP queue 1, item 17)")
    return ("dense",)


class Block(nn.Module):
    def __init__(self, cfg, kind, device):
        super().__init__()
        dtype = layers.dt(cfg)
        self.kind = kind
        self.ln1 = layers.RMSNorm(cfg.d_model, dtype, device)
        self.attn = attention.Attention(cfg, device)
        self.ln2 = layers.RMSNorm(cfg.d_model, dtype, device)
        self.ffn = layers.MLP(cfg.d_model, cfg.d_ff, dtype, device)
        if cfg.post_norms:
            self.ln1b = layers.RMSNorm(cfg.d_model, dtype, device)
            self.ln2b = layers.RMSNorm(cfg.d_model, dtype, device)

    def init_weights(self, generator):
        for m in self.children():
            m.init_weights(generator)


def layer_apply(p: Block, x, cfg, *, positions, cache=None):
    window = cfg.sliding_window if p.kind == "local" else None
    h, new_cache = attention.apply(
        p.attn, rmsnorm(p.ln1, x, cfg.norm_eps), cfg,
        positions=positions, window=window, cache=cache)
    if cfg.post_norms:
        h = rmsnorm(p.ln1b, h, cfg.norm_eps)
    x = x + h
    f = layers.mlp(p.ffn, rmsnorm(p.ln2, x, cfg.norm_eps), cfg.mlp_act)
    if cfg.post_norms:
        f = rmsnorm(p.ln2b, f, cfg.norm_eps)
    return x + f, new_cache


class Transformer(nn.Module):
    """The parameters of a dense decoder, allocated (zeros) on ``device``;
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

    def init_weights(self, generator):
        self.embed.init_weights(generator)
        for blk in self.blocks:
            blk.init_weights(generator)
        self.ln_f.init_weights()
        if self.head is not None:
            self.head.init_weights(generator)
        return self


def init(generator, cfg, device) -> Transformer:
    with torch.no_grad():
        return Transformer(cfg, device).init_weights(generator)


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
        x, nc = layer_apply(blk, x, cfg, positions=positions,
                            cache=None if caches is None else caches[i])
        new_caches.append(nc)
    return x, (new_caches if caches is not None else None)


def _train_layers(p: Transformer, x, cfg, *, positions):
    """The layers over a full sequence.  Under ``cfg.remat != 'none'``, with
    gradients enabled, each block is checkpointed: its activations are
    recomputed in the backward (``torch.utils.checkpoint``, non-reentrant),
    where the reference wraps its scan body in ``jax.checkpoint``.  Either
    way the values are the same."""
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for blk in p.blocks:
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                lambda y, blk=blk: layer_apply(blk, y, cfg, positions=positions)[0],
                x, use_reentrant=False)
        else:
            x, _ = layer_apply(blk, x, cfg, positions=positions)
    return x


def apply(p: Transformer, batch, cfg, *, mode="train", caches=None):
    """mode 'train': full-sequence (logits, aux), differentiable.
    mode 'prefill': caches required (empty) -> (last-position logits, caches).
    mode 'decode': batch['tokens'] is [B, 1], caches -> (logits, caches).
    ``aux`` is the MoE balance loss of the reference, 0 for dense layers.
    Prefill and decode run without gradients (they write the caches in
    place).
    """
    if mode in ("prefill", "decode"):
        return _serve(p, batch, cfg, mode=mode, caches=caches)
    x = layers.embed_lookup(p.embed, batch["tokens"], cfg.embed_scale)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    x = _train_layers(p, x, cfg, positions=positions)
    return _logits(p, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def _serve(p: Transformer, batch, cfg, *, mode, caches):
    x = layers.embed_lookup(p.embed, batch["tokens"], cfg.embed_scale)
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
