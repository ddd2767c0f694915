"""GQA attention: prefill (the flash kernel on the card) + KV-cache decode;
self-attention, causal or not, and cross-attention over an encoder's
output (``apply``'s ``memory``).

Two implementations of full-sequence attention, chosen by the tensor's
device under ``impl="auto"`` (the config's ``attn_impl``):

  * ``'flash'`` — ``kernels/flash_attention`` (the CUDA kernel for a CUDA
    tensor, its plain version for a CPU tensor);
  * ``'torch'`` — ``blocked_sdpa``, the reference's blocked softmax over
    query chunks (never the ``[Sq, Skv]`` scores of the whole sequence),
    for CPU tensors only: it raises for a CUDA tensor.

Under ``'flash'`` a single query row (Sq = 1) takes ``blocked_sdpa`` on
either device, as the reference's dispatch does.

Decode is a one-position einsum over the cache (linear, no blocking), as
in the reference, which computes it outside any kernel.

Caches are dicts ``{k, v [B, Smax, Hkv, hd], pos}`` with ``pos`` a host
int; prefill and decode write the new keys and values into the cache
tensors in place (the reference returns updated copies), which keeps one
cache per layer on the card.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed.sharding import (P, axis_size, batch_entry, current_rules,
                                             entry_axes, flatten, fsdp_axis_for, local_call,
                                             model_entry, on_mesh, unflatten)
from repro_torch.models import layers
from repro_torch.models.layers import Linear, linear

NEG_INF = -1e30
IMPLS = ("auto", "flash", "torch")


class Attention(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dtype, fsdp = layers.dt(cfg), fsdp_axis_for(cfg)
        self.wq = Linear(d, h * hd, dtype, device, bias=cfg.qkv_bias, spec=(fsdp, "model"))
        self.wk = Linear(d, hk * hd, dtype, device, bias=cfg.qkv_bias, spec=(fsdp, "model"))
        self.wv = Linear(d, hk * hd, dtype, device, bias=cfg.qkv_bias, spec=(fsdp, "model"))
        self.wo = Linear(h * hd, d, dtype, device, spec=("model", fsdp))

    def init_weights(self, generator):
        for lin in (self.wq, self.wk, self.wv, self.wo):
            lin.init_weights(generator)


def _split_heads(x, n):
    return unflatten(x, -1, (n, -1))


def _sdpa_chunk(q, k, v, *, scale, softcap, causal, window, q_start, kv_len):
    """q [B,Hkv,G,Cq,hd]; k/v [B,Hkv,Skv,hd] -> out [B,Hkv,G,Cq,hd]."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    cq, skv = q.shape[3], k.shape[2]
    qi = q_start + torch.arange(cq, device=q.device)[:, None]
    kj = torch.arange(skv, device=q.device)[None, :]
    mask = (kj < kv_len).expand(cq, skv)
    if causal:
        mask = mask & (qi >= kj)
    if window is not None:
        mask = mask & ((qi - kj) < window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, 0.0)
    return torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype), v)


def blocked_sdpa(q, k, v, *, causal=True, window=None, softcap=None,
                 scale=None, q_chunk=512, kv_len=None):
    """q [B,Sq,H,hd], k/v [B,Skv,Hkv,hd] -> [B,Sq,H,hd] without S^2 memory.

    ``scale`` defaults to ``hd ** -0.5``; keys at and past ``kv_len``
    (default Skv) are masked, as the reference's."""
    b, sq, h, hd = q.shape
    skv, hk = k.shape[1], k.shape[2]
    g = h // hk
    if scale is None:
        scale = hd ** -0.5
    if kv_len is None:
        kv_len = skv
    kt = k.transpose(1, 2)                                  # [B,Hkv,Skv,hd]
    vt = v.transpose(1, 2)
    qt = q.reshape(b, sq, hk, g, hd).permute(0, 2, 3, 1, 4)  # [B,Hkv,G,Sq,hd]
    c = min(q_chunk, sq)
    if sq % c:
        c = sq  # irregular small inputs: single chunk
    o = torch.cat([_sdpa_chunk(qt[:, :, :, i:i + c], kt, vt, scale=scale,
                               softcap=softcap, causal=causal, window=window,
                               q_start=i, kv_len=kv_len)
                   for i in range(0, sq, c)], dim=3)         # [B,Hkv,G,Sq,hd]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """``'auto'`` -> ``'flash'`` for a CUDA tensor, ``'torch'`` for a CPU
    tensor; ``'torch'`` on a CUDA tensor raises."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        return "flash" if x.device.type == "cuda" else "torch"
    if impl == "torch" and x.device.type != "cpu":
        raise ValueError(f"impl='torch' (blocked_sdpa) runs on CPU tensors only, "
                         f"not {x.device}: the card's attention is the flash kernel")
    return impl


def full_attention(q, k, v, cfg, *, causal, window, impl=None, kv_len=None):
    """q [B,Sq,H,hd], k/v [B,Skv,Hkv,hd] -> [B,Sq,H,hd].

    ``impl`` defaults to the config's ``attn_impl``; keys at and past
    ``kv_len`` are masked (under ``'flash'`` the kernel is given the keys
    before it, which is the same function).  Under ``'flash'`` Sq > 1
    takes the kernel (its plain version on the CPU) and Sq = 1 takes
    ``blocked_sdpa`` on either device, as in the reference."""
    if resolve_impl(impl or cfg.attn_impl, q) == "flash" and q.shape[1] > 1:
        from repro_torch.kernels.flash_attention import ops as flash_ops

        if kv_len is not None and kv_len < k.shape[1]:
            if kv_len <= 0:                      # every key masked: o = 0
                return torch.zeros_like(q)
            k, v = k[:, :kv_len], v[:, :kv_len]
        o = flash_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal, window=window,
                                softcap=cfg.attn_softcap)
        return o.transpose(1, 2)

    def sdpa(q, k, v):
        return blocked_sdpa(q, k, v, causal=causal, window=window,
                            softcap=cfg.attn_softcap, kv_len=kv_len)

    if on_mesh(q):
        # per (batch, head) with no communication: on the local shards
        ba = batch_entry(q.shape[0])
        seq = P(ba, None, model_entry(q.shape[2], k.shape[2], taken=entry_axes(ba)), None)
        return local_call(sdpa, (q, k, v), (seq, seq, seq), seq, tuple(q.shape))
    return sdpa(q, k, v)


def _cache_write(buf, x, pos):
    """The reference's ``dynamic_update_slice_in_dim``: the start index is
    clamped so the update fits (a write past the end lands on the last
    slots, as in the reference).  A cache on a mesh is written on each
    rank's local shard (``_cache_write_local``)."""
    start = min(max(pos, 0), buf.shape[1] - x.shape[1])
    if isinstance(buf, DTensor):
        _cache_write_local(buf, x, start)
        return
    buf[:, start:start + x.shape[1]] = x.to(buf.dtype)


def _cache_write_local(buf: DTensor, x, start: int) -> None:
    """Write ``x`` at ``start`` into a DTensor cache in place.  DTensor
    would slice a cache sharded on its sequence (``decode_kv_shard="seq"``)
    on a gathered copy, so the write would not land: here ``x`` takes the
    cache's placements with its sequence whole, and each rank writes the
    part of ``[start, start + S)`` that its shard holds (evenly sharded:
    ``sanitize_pspec`` keeps only dividing axes)."""
    mesh = buf.device_mesh
    want = [Replicate() if pl.is_shard(1) else pl for pl in buf.placements]
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    local, xl = buf.to_local(), x.redistribute(mesh, want).to_local()
    offset = 0
    for i, pl in enumerate(buf.placements):
        if pl.is_shard(1):
            offset = offset * mesh.size(i) + mesh.get_local_rank(i)
    offset *= local.shape[1]
    lo, hi = max(start, offset), min(start + xl.shape[1], offset + local.shape[1])
    if lo < hi:
        local[:, lo - offset:hi - offset] = xl[:, lo - start:hi - start].to(local.dtype)


def apply(p: Attention, x, cfg, *, positions, causal=True, window=None, cache=None,
          memory=None):
    """Self- or cross-attention of ``x [B, S, D]``.

    cache: None (full sequence) or ``{k, v, pos}``; with ``S == 1`` one
    decode step, else a prefill that fills the cache from ``pos``.
    memory: the encoder's output ``[B, Ss, D]`` for cross-attention: keys
    and values come from it, without RoPE (``causal=False`` takes the
    causal mask away, as the reference's callers pass it).
    Returns ``(out, new_cache)``, ``new_cache`` None without a cache.
    """
    hk, hd = cfg.n_kv_heads, cfg.hd
    q = _split_heads(linear(p.wq, x), cfg.n_heads)
    src = memory if memory is not None else x
    k = _split_heads(linear(p.wk, src), hk)
    v = _split_heads(linear(p.wv, src), hk)
    if memory is None:  # RoPE for self-attention only
        cos, sin = layers.rope_angles(positions, hd, cfg.rope_fraction,
                                      cfg.rope_theta)
        q = layers.apply_rope(q, cos, sin, cfg.rope_fraction)
        k = layers.apply_rope(k, cos, sin, cfg.rope_fraction)

    if cache is not None:
        pos = cache["pos"]
        _cache_write(cache["k"], k, pos)
        _cache_write(cache["v"], v, pos)
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + x.shape[1]}
        if x.shape[1] == 1:  # one-step decode
            o = decode_attention(q, cache["k"], cache["v"], cfg, pos=pos,
                                 window=window)
        else:                # prefill: bulk-fill cache, full attention
            o = full_attention(q, k, v, cfg, causal=causal, window=window)
        return linear(p.wo, flatten(o, 2)), new_cache

    o = full_attention(q, k, v, cfg, causal=causal, window=window)
    return linear(p.wo, flatten(o, 2)), None


def decode_attention(q, k, v, cfg, *, pos, window=None):
    """q [B,1,H,hd] vs cache k/v [B,Smax,Hkv,hd]; linear in Smax.  On a
    mesh, ``_decode_on_mesh``."""
    if on_mesh(q):
        return _decode_on_mesh(q, k, v, cfg, pos=pos, window=window)
    b, _, h, hd = q.shape
    hk = k.shape[2]
    qg = q.reshape(b, 1, hk, h // hk, hd)
    s = _decode_scores(qg, k, cfg, pos=pos, window=window, offset=0)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return o.reshape(b, 1, h, hd)


def _decode_scores(qg, k, cfg, *, pos, window, offset):
    """Masked float32 scores ``[B,Hkv,G,1,Sk]`` of keys ``offset ..``."""
    hd = qg.shape[-1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * hd ** -0.5
    if cfg.attn_softcap is not None:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    kj = offset + torch.arange(k.shape[1], device=qg.device)
    mask = kj <= pos
    if window is not None:
        mask = mask & ((pos - kj) < window)
    return torch.where(mask, s, NEG_INF)


def _decode_on_mesh(q, k, v, cfg, *, pos, window):
    """The decode step on each rank's local shards: the batch on the rules'
    batch axes; a cache sharded on its sequence (``decode_kv_shard="seq"``)
    stays so, flash-decode style (the softmax's max and sum, and the
    output, all-reduced over that axis: ``[B, H]``-sized, where gathering
    the cache would move it all); else the heads on 'model' where it
    divides both head counts."""
    mesh, _ = current_rules()
    b, _, h, hd = q.shape
    smax, hk = k.shape[1], k.shape[2]
    ba = batch_entry(b)
    batch = entry_axes(ba)
    names = mesh.mesh_dim_names
    seq = [names[i] for i, pl in enumerate(k.placements)
           if pl.is_shard(1) and names[i] not in batch]
    seq = seq[0] if len(seq) == 1 and smax % axis_size(mesh, seq[0]) == 0 else None
    hm = model_entry(h, hk, taken=(*batch, seq))
    group = mesh.get_group(seq) if seq else None

    def local(q, k, v):
        bl, _, hl, _ = q.shape
        hkl = k.shape[2]
        offset = mesh.get_local_rank(seq) * k.shape[1] if seq else 0
        s = _decode_scores(q.reshape(bl, 1, hkl, hl // hkl, hd), k, cfg, pos=pos,
                           window=window, offset=offset)
        m = s.amax(-1, keepdim=True)
        if seq:
            m = funcol.all_reduce(m, "max", group)
        p = torch.exp(s - m)
        den = p.sum(-1, keepdim=True)
        if seq:
            den = funcol.all_reduce(den, "sum", group)
        o = torch.einsum("bhgqk,bkhd->bqhgd", (p / den).to(v.dtype), v)
        if seq:
            o = funcol.all_reduce(o, "sum", group)
        return o.reshape(bl, 1, hl, hd)

    kv = P(ba, seq, hm, None)
    return local_call(local, (q, k, v), (P(ba, None, hm, None), kv, kv),
                      P(ba, None, hm, None), (b, 1, h, hd))


def init_cache(cfg, batch, max_len, *, device="cuda"):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=layers.dt(cfg), device=device),
            "v": torch.zeros(shape, dtype=layers.dt(cfg), device=device),
            "pos": 0}
