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

On a mesh (parameters and activations as DTensors under
``distributed.sharding.axis_rules``) ``apply`` chooses as the reference
does: ``moe_dispatch="shard_map_ep"`` with a 'model' axis that divides
the experts, and more than one position, takes ``apply_shard_map``, the
reference's manual SPMD: each 'model' rank routes its data shard's tokens
locally, keeps its own slab of ``n_experts / m_size`` experts
(``_local_expert_ffn``), and one all-reduce over 'model' combines the
partial outputs in the activation dtype.  The reference's other path
leaves the sort dispatch to XLA's partitioner, which has no DTensor twin
(DTensor has no sharding rule for a sort or ``searchsorted``):
``apply_shard_map(..., gather_tokens=True)`` takes its place, the same
local slab computation on the tokens of every batch shard gathered, at
the global capacity, so its result is ``apply``'s.  Both run on the ranks' local tensors
(``to_local``) and hand DTensors back, so their collectives are DTensor's
and show in the dry run's count.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed.sharding import (P, axis_size, batch_entry, current_rules,
                                             entry_axes, fsdp_axis_for, on_mesh,
                                             placements_of, to_local_as)
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


def _topk(xf, router, k):
    """(float32 probabilities ``[n, e]``, the renormalised gates and experts
    of the top ``k``, a stable descending sort's first ``k``)."""
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    gate, eid = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eid = gate[:, :k], eid[:, :k]
    return probs, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), eid


def route(p: MoE, xf, cfg) -> Routing:
    """``xf [n, d]``'s routing (``Routing``): float32 logits, softmax, top-k
    with the gates renormalised, then the sort dispatch at capacity
    ``_capacity(n, cfg)``."""
    n = xf.shape[0]
    e, k = cfg.n_experts, cfg.experts_per_token
    probs, gate, eid = _topk(xf, p.router, k)
    c = _capacity(n, cfg)
    order, rank, keep, slot = _dispatch(eid.reshape(-1), e, c)
    return Routing(probs, gate, eid, order, rank, keep, slot, order // k, c)


def _dispatch(key, n_slab: int, c: int):
    """The sort dispatch of the flat assignments ``key [n * k]`` (each an
    expert of the slab ``[0, n_slab)``, or ``n_slab`` for one elsewhere) at
    capacity ``c``: ``(order, rank, keep, slot)``, ``Routing``'s."""
    sorted_e, order = torch.sort(key, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(key.shape[0], device=key.device) - first
    keep = (sorted_e < n_slab) & (rank < c)
    slot = torch.where(keep, sorted_e * c + rank, n_slab * c)   # sentinel row
    return order, rank, keep, slot


def _experts(xf, gate, order, keep, slot, w_gate, w_up, w_down, cfg, c: int):
    """The slab's FFN (``w_* [e, ...]``) on the kept assignments, gathered
    into an ``[e, c, d]`` buffer, each token's contributions combined ->
    ``[n, d]`` (zeros for a token whose assignments all went elsewhere)."""
    n, d = xf.shape
    k, e = gate.shape[-1], w_gate.shape[0]
    kept = keep[:, None]
    buf = xf.new_zeros((e * c + 1, d)).index_put((slot,), torch.where(kept, xf[order // k], 0))
    h = buf[: e * c].view(e, c, d)
    act = F.silu if cfg.mlp_act == "silu" else (lambda y: F.gelu(y, approximate="tanh"))
    hg = act(torch.bmm(h, w_gate.to(xf.dtype)))
    hu = torch.bmm(h, w_up.to(xf.dtype))
    ho = torch.bmm(hg * hu, w_down.to(xf.dtype))

    ho_flat = torch.cat([ho.reshape(e * c, d), xf.new_zeros((1, d))])
    contrib = torch.where(kept, ho_flat[slot] * gate.reshape(-1)[order][:, None].to(xf.dtype),
                          0)                                  # sorted order
    # a token's assignments sit in the sorted order by ascending expert:
    # their sorted positions, ascending, give its k contributions in the
    # order the reference's scatter-add applies them
    pos = torch.empty_like(order).scatter_(0, order, torch.arange(n * k, device=xf.device))
    per_token = contrib[pos.view(n, k).sort(dim=-1).values]   # [n, k, d]
    y = xf.new_zeros((n, d))
    for i in range(k):
        y = y + per_token[:, i]
    return y


def _local_expert_ffn(xf, gate, eid, w_gate, w_up, w_down, cfg, e_base, e_loc, c):
    """Sort-dispatch ``xf``'s tokens to the LOCAL expert slab ``[e_loc,
    ...]``: ``apply``'s machinery restricted to experts ``[e_base, e_base +
    e_loc)``; other assignments sort last and drop.  -> the partial output
    ``[n, d]`` (zeros where tokens went elsewhere)."""
    flat_e = eid.reshape(-1)
    local = (flat_e >= e_base) & (flat_e < e_base + e_loc)
    order, _, keep, slot = _dispatch(torch.where(local, flat_e - e_base, e_loc), e_loc, c)
    return _experts(xf, gate, order, keep, slot, w_gate, w_up, w_down, cfg, c)


def apply_shard_map(p: MoE, x, cfg, *, gather_tokens: bool = False):
    """Replicated-routing expert parallelism (manual SPMD) on DTensors.

    Under plain GSPMD the sort-based dispatch scatters data-sharded tokens
    into a model-sharded buffer, which XLA turns into TB-scale all-reduces
    (the reference's finding).  Here every 'model' rank routes its data
    shard's tokens locally (the router product is redundant across ranks
    but small), keeps only the assignments of its OWN expert slab, and one
    all-reduce over 'model' combines the partial outputs in the activation
    dtype.  Expert weights enter pre-sliced (EP: gathered over the FSDP
    axes only), so their gradients stay local to the slab.  The aux loss
    averages the routing statistics over the batch axes.

    ``gather_tokens`` gathers the tokens of every batch shard first and
    routes them all at the global capacity."""
    mesh, rules = current_rules()
    ma = rules["model"]
    b, s, d = x.shape
    ba = batch_entry(b)
    bas = entry_axes(ba)
    e, k = cfg.n_experts, cfg.experts_per_token
    e_loc = e // axis_size(mesh, ma)

    # the ranks that hold the same slice on other tokens (or other experts)
    # each hold a part of its gradient
    token_axes = (ma,) if gather_tokens else mesh.mesh_dim_names
    x_spec = P(None, None, None) if gather_tokens else P(ba, None, None)
    xb = to_local_as(x, x_spec, (ma,))
    router = to_local_as(p.router, P(None, None), token_axes)
    w = [to_local_as(t, P(ma, None, None), () if gather_tokens else bas)
         for t in (p.w_gate, p.w_up, p.w_down)]

    xf = xb.reshape(-1, d)
    probs, gate, eid = _topk(xf, router, k)
    r = mesh.get_local_rank(ma)
    y_part = _local_expert_ffn(xf, gate, eid, *w, cfg, r * e_loc, e_loc,
                               _capacity(xf.shape[0], cfg))
    # combine in the activation dtype (bf16 halves the all-reduce's bytes)
    y = DTensor.from_local(y_part.to(x.dtype).reshape(xb.shape), mesh,
                           placements_of(mesh, x_spec, (ma,)), run_check=False,
                           shape=x.shape, stride=x.stride())
    y = y.redistribute(mesh, placements_of(mesh, P(ba, None, None)))

    # every 'model' rank computes the same statistics: one of them carries
    # their gradient, so the sum over 'model' counts it once
    if r:
        probs = probs.detach()
    stats = placements_of(mesh, P(None), () if gather_tokens else bas)
    me, fe = (DTensor.from_local(t, mesh, stats, run_check=False, shape=(e,), stride=(1,))
              for t in (probs.mean(0), F.one_hot(eid[:, 0], e).float().mean(0)))
    n_shards = 1 if gather_tokens else math.prod(axis_size(mesh, a) for a in bas)
    me, fe = (t.redistribute(mesh, [Replicate()] * mesh.ndim) / n_shards for t in (me, fe))
    aux = cfg.router_aux_coef * e * torch.sum(me * fe)
    if p.shared is not None:
        y = y + layers.mlp(p.shared, x.reshape(-1, d), cfg.mlp_act).reshape(x.shape)
    return y, aux


def apply(p: MoE, x, cfg):
    """x [B, S, D] -> (y [B, S, D], aux): the routed experts' gated
    mixture plus the shared experts, and the Switch load-balance loss of
    the top-1 expert (a float32 scalar).  On a mesh, ``apply_shard_map``
    (the module's docstring)."""
    if on_mesh(x):
        mesh, rules = current_rules()
        m_size = axis_size(mesh, rules["model"]) if rules["model"] else 1
        if m_size > 1 and cfg.n_experts % m_size == 0:
            # the reference's other path leaves the sort dispatch to XLA's
            # partitioner: here the tokens of every batch shard, gathered
            gather = not (cfg.moe_dispatch == "shard_map_ep" and x.shape[1] > 1)
            return apply_shard_map(p, x, cfg, gather_tokens=gather)
        raise NotImplementedError(
            f"{cfg.n_experts} experts on a {m_size}-wide 'model' axis: the slab "
            "dispatch needs the axis to divide the experts")
    b, s, d = x.shape
    e = cfg.n_experts
    xf = x.reshape(b * s, d)
    r = route(p, xf, cfg)
    y = _experts(xf, r.gate, r.order, r.keep, r.slot, p.w_gate, p.w_up, p.w_down, cfg,
                 r.capacity)

    if p.shared is not None:
        y = y + layers.mlp(p.shared, xf, cfg.mlp_act)

    me = r.probs.mean(0)                                      # [e]
    fe = F.one_hot(r.eid[:, 0], e).float().mean(0)
    aux = cfg.router_aux_coef * e * torch.sum(me * fe)
    return y.reshape(b, s, d), aux
