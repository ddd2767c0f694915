"""Mixture-of-Experts with sort-based capacity dispatch, on one device.

The twin of the reference's ``models/moe.py`` ``apply``: token -> expert
assignments are sorted by expert id (a stable sort), each assignment's
rank within its expert's run comes from ``searchsorted``, assignments at
and past the expert's capacity drop (token-choice), and the kept tokens
are gathered into an ``[e, c, d]`` buffer whose expert FFN is three
batched products.  Covers deepseek-moe (2 shared + 64 routed, top-6) and
llama4-maverick (1 shared + 128 routed, top-1).

Layout: the router is ``[d, e]`` in float32 whatever ``cfg.dtype`` is;
``w_gate`` / ``w_up`` are ``[e, d, ffe]`` and ``w_down`` ``[e, ffe, d]``
in ``cfg.dtype``, the reference's own layout, which is what ``torch.bmm``
takes for ``[e, c, d] @ [e, d, ffe]``, so ``convert`` copies them as
they are.  The shared experts are one ``layers.MLP`` of width
``n_shared_experts * moe_d_ff`` (PyTorch's linear layout).

Routing: top-k is the first k of a stable descending sort of the
probabilities, so experts of equal probability come lower index first,
as ``jax.lax.top_k`` orders them, on either device.

The combine adds no float atomics: each token's k contributions are
gathered into ``[n, k, d]`` in ascending expert order (the order in which
the reference's ``.at[token].add`` applies them) and summed one by one in
``x.dtype``, on both devices.

The reference's expert-parallel ``apply_shard_map`` has no twin here (one
device; ROADMAP item 17.5): on one device the reference itself takes
``apply``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import fsdp_axis_for
from repro_torch.models import layers


class MoE(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        d, e, ffe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        dtype, fsdp = layers.dt(cfg), fsdp_axis_for(cfg)
        self.router = layers._param((d, e), torch.float32, device)
        self.w_gate = layers._param((e, d, ffe), dtype, device)
        self.w_up = layers._param((e, d, ffe), dtype, device)
        self.w_down = layers._param((e, ffe, d), dtype, device)
        self.specs = {"router": (fsdp, "model"), "w_gate": ("model", fsdp, None),
                      "w_up": ("model", fsdp, None), "w_down": ("model", None, fsdp)}
        self.shared = (layers.MLP(d, cfg.n_shared_experts * ffe, dtype, device, fsdp)
                       if cfg.n_shared_experts else None)

    def init_weights(self, generator):
        d, ffe = self.w_gate.shape[1], self.w_gate.shape[2]
        layers.truncnorm_(self.router, d ** -0.5, generator)
        layers.truncnorm_(self.w_gate, d ** -0.5, generator)
        layers.truncnorm_(self.w_up, d ** -0.5, generator)
        layers.truncnorm_(self.w_down, ffe ** -0.5, generator)
        if self.shared is not None:
            self.shared.init_weights(generator)


def _capacity(n_tokens: int, cfg) -> int:
    c = int(n_tokens * cfg.experts_per_token * cfg.capacity_factor
            / max(cfg.n_experts, 1))
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    """One MoE call's routing over ``n`` tokens, ``k`` experts a token.

    ``probs [n, e]`` float32, ``gate`` / ``eid [n, k]`` (probability
    order); the rest in sorted-assignment order ``[n * k]``: ``order`` (the
    flat assignment each sorted position holds), ``rank`` within its
    expert's run, ``keep = rank < c``, ``slot`` in the ``[e * c + 1]``
    buffer (the sentinel row ``e * c`` for a dropped assignment) and
    ``token = order // k``."""
    probs: torch.Tensor
    gate: torch.Tensor
    eid: torch.Tensor
    order: torch.Tensor
    rank: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    token: torch.Tensor
    capacity: int


def route(p: MoE, xf, cfg) -> Routing:
    """``xf [n, d]``'s routing (``Routing``): float32 logits, softmax, top-k
    with the gates renormalised, then the sort dispatch at capacity
    ``_capacity(n, cfg)``."""
    n = xf.shape[0]
    e, k = cfg.n_experts, cfg.experts_per_token
    logits = xf.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)                     # [n, e]
    gate, eid = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eid = gate[:, :k], eid[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    c = _capacity(n, cfg)
    flat_e = eid.reshape(-1)
    sorted_e, order = torch.sort(flat_e, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(n * k, device=xf.device) - first
    keep = rank < c
    slot = torch.where(keep, sorted_e * c + rank, e * c)      # sentinel row
    return Routing(probs, gate, eid, order, rank, keep, slot, order // k, c)


def apply(p: MoE, x, cfg):
    """x [B, S, D] -> (y [B, S, D], aux): the routed experts' gated
    mixture plus the shared experts, and the Switch load-balance loss of
    the top-1 expert (a float32 scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    n = b * s
    xf = x.reshape(n, d)
    r = route(p, xf, cfg)
    c = r.capacity

    kept = r.keep[:, None]
    buf = x.new_zeros((e * c + 1, d)).index_put(
        (r.slot,), torch.where(kept, xf[r.token], 0))
    h = buf[: e * c].view(e, c, d)
    act = F.silu if cfg.mlp_act == "silu" else (lambda y: F.gelu(y, approximate="tanh"))
    hg = act(torch.bmm(h, p.w_gate.to(x.dtype)))
    hu = torch.bmm(h, p.w_up.to(x.dtype))
    ho = torch.bmm(hg * hu, p.w_down.to(x.dtype))

    ho_flat = torch.cat([ho.reshape(e * c, d), x.new_zeros((1, d))])
    gate = r.gate.reshape(-1)[r.order][:, None].to(x.dtype)
    contrib = torch.where(kept, ho_flat[r.slot] * gate, 0)    # sorted order
    # a token's assignments sit in the sorted order by ascending expert:
    # their sorted positions, ascending, give its k contributions in the
    # order the reference's scatter-add applies them
    pos = torch.empty_like(r.order).scatter_(
        0, r.order, torch.arange(n * k, device=x.device))
    per_token = contrib[pos.view(n, k).sort(dim=-1).values]   # [n, k, d]
    y = x.new_zeros((n, d))
    for i in range(k):
        y = y + per_token[:, i]

    if p.shared is not None:
        y = y + layers.mlp(p.shared, xf, cfg.mlp_act)

    me = r.probs.mean(0)                                      # [e]
    fe = F.one_hot(r.eid[:, 0], e).float().mean(0)
    aux = cfg.router_aux_coef * e * torch.sum(me * fe)
    return y.reshape(b, s, d), aux
