"""Zamba2: a Mamba2 backbone with weight-shared attention blocks.

The twin of the reference's ``models/zamba.py``.  Every
``shared_attn_every`` Mamba2 layers a shared transformer block runs on
``concat(x, x0)`` (``x0`` the embedding output, after ``embed_scale``) at
width ``2 * d_model`` (zamba2-2.7b: 32 heads x head width 160 = 5,120),
with no softcap and no window, and its ``down`` projection back to
``d_model`` is added to the residual.  ``n_shared_attn_blocks`` parameter
sets alternate: invocation ``g`` uses block ``g % n_shared_attn_blocks``.
Each invocation keeps its own KV cache (the weights are shared, the
caches are not).  On the card the shared attention's prefill is the flash
kernel at D 160 (``attn_impl='auto'``), once an invocation.

The reference stacks the Mamba2 layers ``[n_groups, every]`` and scans the
groups; here ``mamba`` holds the layers in order (layer ``g * every + i``
is group ``g``'s ``i``-th) and a Python loop runs them.  Caches are
``{"mamba": [group][i] -> (conv state, ScanState), "attn": [group] ->
{k, v, pos}}``.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.distributed.sharding import constrain, fsdp_axis_for, with_current_rules
from repro_torch.models import attention, layers, mamba2
from repro_torch.models.layers import linear, rmsnorm


def _shared_cfg(cfg):
    d2 = 2 * cfg.d_model
    return cfg.replace(d_model=d2, head_dim=d2 // cfg.n_heads, attn_softcap=None,
                       sliding_window=None)


def _groups(cfg):
    every = cfg.shared_attn_every or cfg.n_layers
    if cfg.n_layers % every:
        raise ValueError(f"{cfg.n_layers} layers are no multiple of {every}")
    return cfg.n_layers // every, every


class SharedBlock(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        d2 = 2 * cfg.d_model
        dtype, fsdp = layers.dt(cfg), fsdp_axis_for(cfg)
        self.ln1 = layers.RMSNorm(d2, dtype, device)
        self.attn = attention.Attention(_shared_cfg(cfg), device)
        self.ln2 = layers.RMSNorm(d2, dtype, device)
        self.mlp = layers.MLP(d2, cfg.d_ff, dtype, device, fsdp)
        self.down = layers.Linear(d2, cfg.d_model, dtype, device, spec=("model", fsdp))

    def init_weights(self, generator):
        for m in self.children():
            m.init_weights(generator)


def shared_block_apply(p: SharedBlock, x, x0, cfg, *, positions, cache=None):
    scfg = _shared_cfg(cfg)
    h = torch.cat([x, x0], dim=-1)
    a, new_cache = attention.apply(p.attn, rmsnorm(p.ln1, h, cfg.norm_eps), scfg,
                                   positions=positions, cache=cache)
    h = h + a
    h = h + layers.mlp(p.mlp, rmsnorm(p.ln2, h, cfg.norm_eps), cfg.mlp_act)
    return x + linear(p.down, h), new_cache


class Zamba(nn.Module):
    """The parameters, allocated (zeros) on ``device``; ``init_weights``
    fills them from a generator on that device."""

    def __init__(self, cfg, device):
        super().__init__()
        _groups(cfg)
        dtype = layers.dt(cfg)
        self.cfg = cfg
        self.embed = layers.Embedding(cfg.vocab_size, cfg.d_model, dtype, device,
                                      fsdp_axis_for(cfg))
        self.mamba = nn.ModuleList(mamba2.Mamba2(cfg, device) for _ in range(cfg.n_layers))
        self.shared = nn.ModuleList(SharedBlock(cfg, device)
                                    for _ in range(cfg.n_shared_attn_blocks))
        self.ln_f = layers.RMSNorm(cfg.d_model, dtype, device)

    def init_weights(self, generator):
        self.embed.init_weights(generator)
        for m in (*self.mamba, *self.shared):
            m.init_weights(generator)
        self.ln_f.init_weights()
        return self


def init(generator, cfg, device) -> Zamba:
    with torch.no_grad():
        return Zamba(cfg, device).init_weights(generator)


def init_caches(cfg, batch, max_len, *, device="cuda"):
    n_groups, every = _groups(cfg)
    scfg = _shared_cfg(cfg)
    return {"mamba": [[mamba2.init_state(cfg, batch, device=device) for _ in range(every)]
                      for _ in range(n_groups)],
            "attn": [attention.init_cache(scfg, batch, max_len, device=device)
                     for _ in range(n_groups)]}


def _group(p: Zamba, g: int, x, x0, cfg, *, positions, mode, caches=None):
    """Group ``g``: its Mamba2 layers, then shared block ``g %
    n_shared_attn_blocks`` -> (x, its Mamba2 states, its attention cache)."""
    _, every = _groups(cfg)
    states = []
    for i in range(every):
        lp = p.mamba[g * every + i]
        if mode == "decode":
            x, st = mamba2.decode(lp, x, cfg, caches["mamba"][g][i])
        else:
            x, st = mamba2.apply(lp, x, cfg, None if caches is None else caches["mamba"][g][i])
        states.append(st)
    x, ac = shared_block_apply(p.shared[g % cfg.n_shared_attn_blocks], x, x0, cfg,
                               positions=positions,
                               cache=None if caches is None else caches["attn"][g])
    return x, states, ac


def _logits(p: Zamba, x, cfg):
    return layers.embed_logits(p.embed, rmsnorm(p.ln_f, x, cfg.norm_eps), cfg.final_softcap)


def apply(p: Zamba, batch, cfg, *, mode="train", caches=None):
    """mode 'train': (logits, 0), differentiable; under ``cfg.remat !=
    'none'``, with gradients enabled, each group is checkpointed
    (``torch.utils.checkpoint``, non-reentrant), where the reference wraps
    its scan body in ``jax.checkpoint``.  mode 'prefill' (caches from
    ``init_caches``): (last-position logits, caches); mode 'decode'
    (``tokens [B, 1]``, positions from the caches' ``pos``): (logits,
    caches).  Prefill and decode run without gradients."""
    n_groups, _ = _groups(cfg)
    if mode in ("prefill", "decode"):
        return _serve(p, batch, cfg, mode=mode, caches=caches)
    x = constrain(layers.embed_lookup(p.embed, batch["tokens"], cfg.embed_scale),
                  ("batch", None, None))
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    x0 = x

    def group(y, g):
        return _group(p, g, y, x0, cfg, positions=positions, mode="train")[0]

    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for g in range(n_groups):
        if remat:
            x = torch.utils.checkpoint.checkpoint(with_current_rules(group), x, g,
                                                  use_reentrant=False)
        else:
            x = group(x, g)
    return _logits(p, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def _serve(p: Zamba, batch, cfg, *, mode, caches):
    n_groups, _ = _groups(cfg)
    x = constrain(layers.embed_lookup(p.embed, batch["tokens"], cfg.embed_scale),
                  ("batch", None, None))
    b, s = x.shape[:2]
    if mode == "decode":
        positions = torch.full((b, 1), caches["attn"][0]["pos"], dtype=torch.int32,
                               device=x.device)
    else:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    x0 = x
    new = {"mamba": [], "attn": []}
    for g in range(n_groups):
        x, states, ac = _group(p, g, x, x0, cfg, positions=positions, mode=mode,
                               caches=caches)
        new["mamba"].append(states)
        new["attn"].append(ac)
    if mode == "prefill":
        x = x[:, -1:]
    return _logits(p, x, cfg), new
