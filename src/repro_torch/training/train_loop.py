"""Train step assembly: loss, microbatch grad accumulation, optimizer.

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``.  The reference's step is a pure function that its launcher
jits; here the step advances ``state`` in place (the model's parameters
and the optimizer's moments, ``optimizer.update_``) and returns it, so a
state never exists twice on the card.  Microbatching loops over leading
batch splits, accumulating float32 gradients divided by the microbatch
count — grad accumulation == large-batch equivalence is tested.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.distributed import _functional_collectives as funcol

from repro_torch.distributed.sharding import (P, batch_entry, current_rules, entry_axes,
                                             local_call, model_entry, on_mesh)
from repro_torch.models import convert, layers
from repro_torch.training import optimizer as opt_lib


class TrainState(NamedTuple):
    params: nn.Module             # the model; its parameters require gradients
    opt: opt_lib.OptState


def lm_loss(logits, labels, mask, z_coef: float = 1e-4):
    """Masked CE + z-loss (keeps the softmax normalizer bounded at scale)."""
    if on_mesh(logits):
        ll_sum, z_sum, n = _loss_sums_on_mesh(logits, labels, mask)
        denom = torch.clamp(n, min=1.0)
        ce = -ll_sum / denom
        return ce + z_coef * (z_sum / denom), ce
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[..., None].long(), -1)[..., 0] - lse
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = -(ll * mask).sum() / denom
    z = (lse ** 2 * mask).sum() / denom
    return ce + z_coef * z, ce


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over a group; each rank's input is one term, so its
    gradient is the sum's."""

    @staticmethod
    def forward(ctx, x, group):
        return funcol.all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _loss_sums_on_mesh(logits, labels, mask):
    """``lm_loss``'s sums on a mesh, vocab-parallel: (the masked sum of
    log-likelihoods, the masked sum of ``lse ** 2``, the mask's count),
    partial over the batch axes.  Each rank keeps its slice of the vocab:
    the max, the sum of exponentials and the picked logit are all-reduced
    over 'model' (``[B, S]`` each), where DTensor would gather the
    ``[B, S, V]`` logits."""
    mesh, _ = current_rules()
    b, s, v = logits.shape
    vocab = model_entry(v)
    ba = batch_entry(b, exclude=(vocab,))
    group = mesh.get_group(vocab) if vocab else None

    def sums(lg, lab, msk):
        lg = lg.float()
        lo = mesh.get_local_rank(vocab) * lg.shape[-1] if vocab else 0
        m = lg.detach().amax(-1)
        if vocab:
            m = funcol.all_reduce(m, "max", group)
        se = torch.exp(lg - m[..., None]).sum(-1)
        ids = lab.long() - lo
        inside = (ids >= 0) & (ids < lg.shape[-1])
        picked = torch.where(inside, torch.take_along_dim(
            lg, ids.clamp(0, lg.shape[-1] - 1)[..., None], -1)[..., 0], 0.0)
        if vocab:
            se, picked = _SumOver.apply(se, group), _SumOver.apply(picked, group)
        lse = m + torch.log(se)
        msk = msk.float()
        return ((picked - lse) * msk).sum(), (lse ** 2 * msk).sum(), msk.sum()

    tok = P(ba, None)
    return local_call(sums, (logits, labels, mask), (P(ba, None, vocab), tok, tok),
                      (P(), P(), P()), ((), (), ()), out_partial=entry_axes(ba))


def make_loss_fn(mdl, z_coef: float = 1e-4):
    def loss_fn(params, batch):
        logits, aux = mdl.apply(params, batch, mode="train")
        total, ce = lm_loss(logits, batch["labels"], batch["loss_mask"], z_coef)
        return total + aux, {"ce": ce, "aux": aux}

    return loss_fn


def trainable(model: nn.Module) -> nn.Module:
    """``model`` with every parameter requiring a gradient."""
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def _on_device(batch: dict, device, dtype: torch.dtype) -> dict:
    """The batch on ``device``, its floating inputs (a VLM's
    ``patch_embeds``, an encoder-decoder's ``src_embeds``) in the model's
    ``dtype``, as the model casts them anyway."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = t.to(device, dtype) if t.is_floating_point() else t.to(device)
    return out


def make_train_step(mdl, opt_cfg: opt_lib.OptConfig, microbatches: int = 1,
                    z_coef: float = 1e-4):
    loss_fn = make_loss_fn(mdl, z_coef)

    def grads_of(model, batch):
        names, params = zip(*model.named_parameters())
        loss, metrics = loss_fn(model, batch)
        # a parameter the batch does not reach (a VLM's patch_proj under a
        # batch of tokens only) gets a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(names, grads))

    def train_step(state: TrainState, batch):
        model = state.params
        device = next(model.parameters()).device
        batch = _on_device(batch, device, layers.dt(mdl.cfg))
        if microbatches > 1:
            b = next(iter(batch.values())).shape[0]
            assert b % microbatches == 0
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=device)
                     for n, p in model.named_parameters()}
            loss = torch.zeros((), dtype=torch.float32, device=device)
            per_mb = []
            for i in range(microbatches):
                mb = {k: v.reshape(microbatches, b // microbatches, *v.shape[1:])[i]
                      for k, v in batch.items()}
                l_mb, m_mb, g_mb = grads_of(model, mb)
                for n, g in g_mb.items():
                    grads[n] = grads[n] + g.float() / microbatches
                del g_mb
                loss = loss + l_mb / microbatches
                per_mb.append(m_mb)
            metrics = {k: torch.stack([m[k] for m in per_mb]).mean() for k in per_mb[0]}
        else:
            loss, metrics, grads = grads_of(model, batch)
        new_opt, opt_metrics = opt_lib.update_(opt_cfg, grads, state.opt,
                                               dict(model.named_parameters()))
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return TrainState(model, new_opt), metrics

    return train_step


def init_state(mdl, generator=None, device="cuda") -> TrainState:
    """A fresh state: ``mdl.init``'s parameters (on the generator's device,
    else ``device``), made trainable, and zero moments."""
    model = trainable(mdl.init(generator, device))
    return TrainState(model, opt_lib.init(dict(model.named_parameters())))


def state_pspecs(pspecs: dict) -> TrainState:
    """The train state's specs: the moments mirror the parameters (by
    name), the step is replicated."""
    from repro_torch.distributed.sharding import P

    return TrainState(pspecs, opt_lib.OptState(pspecs, pspecs, P()))


def state_tree(state: TrainState) -> TrainState:
    """``state`` as a tree of tensors for ``training.checkpoint``: the
    model's parameters as a dict by name."""
    return TrainState({n: p.detach() for n, p in state.params.named_parameters()},
                      state.opt)


@torch.no_grad()
def restore_state(state: TrainState, tree: TrainState) -> TrainState:
    """``state`` holding ``tree`` (``state_tree``'s structure, as
    ``checkpoint.restore`` gives it): the parameters are copied into the
    model in place."""
    for n, p in state.params.named_parameters():
        p.copy_(tree.params[n])
    return TrainState(state.params, opt_lib.OptState(*tree.opt))


def from_jax_train_state(cfg, state) -> TrainState:
    """The port's ``TrainState``, on the CPU, holding a reference
    ``TrainState`` (numpy leaves): its params, float32 moments and step."""
    model = trainable(convert.from_jax_params(cfg, state.params))
    opt = opt_lib.OptState(convert.named_tensors(cfg, state.opt.mu, model, torch.float32),
                           convert.named_tensors(cfg, state.opt.nu, model, torch.float32),
                           torch.tensor(int(np.asarray(state.opt.step)), dtype=torch.int32))
    return TrainState(model, opt)
