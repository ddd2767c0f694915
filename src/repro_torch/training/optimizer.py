"""AdamW + schedules as plain functions on tensors.

The reference's arithmetic, operation for operation: float32 moments for
every parameter dtype, the global-norm clip first, the learning rate of
``step + 1``, bias correction as written, weight decay on every parameter
added to the step before the learning rate, the result cast back to the
parameter's dtype.  ``torch.optim.AdamW`` is not used: it keeps bfloat16
moments for bfloat16 parameters and orders the arithmetic differently.

Trees are dicts of tensors keyed by parameter name
(``Transformer.named_parameters()``).  ``update_`` is the reference's
``update`` done in place: it writes the new values into the parameters
and the state's moment dicts, one parameter at a time, so a model whose
moments and a second copy of them would not fit on the card (gemma2-2b:
20.8 GB of float32 moments) trains there.  ``update`` is the reference's
functional form: it copies its inputs and runs ``update_`` on the copies,
so both forms share one arithmetic path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class OptState(NamedTuple):
    mu: dict
    nu: dict
    step: torch.Tensor          # int32 scalar


def schedule(cfg: OptConfig, step):
    """Linear warmup to ``peak_lr``, then cosine decay to
    ``min_lr_ratio * peak_lr`` at ``decay_steps`` (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * \
        (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init(params: dict) -> OptState:
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    device = next(iter(params.values())).device if params else "cpu"
    return OptState(zeros, {n: z.clone() for n, z in zeros.items()},
                    torch.zeros((), dtype=torch.int32, device=device))


def global_norm(tree: dict):
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in tree.values()))


def _clip_scale(norm, max_norm):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: dict, max_norm):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


def _scalars(cfg: OptConfig, grads: dict, state: OptState):
    """(clip scale, grad norm, new step, its learning rate)."""
    norm = global_norm(grads)
    step = state.step + 1
    return _clip_scale(norm, cfg.grad_clip), norm, step, schedule(cfg, step)


def _leaf(cfg: OptConfig, g, mu, nu, p, lr, step32):
    """One parameter's (new value, mu, nu) for its clipped gradient ``g``."""
    b1, b2 = cfg.b1, cfg.b2
    g32 = g.float()
    mu_n = b1 * mu + (1 - b1) * g32
    nu_n = b2 * nu + (1 - b2) * g32 * g32
    mu_hat = mu_n / (1 - b1 ** step32)
    nu_hat = nu_n / (1 - b2 ** step32)
    delta = mu_hat / (torch.sqrt(nu_hat) + cfg.eps)
    delta = delta + cfg.weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), mu_n, nu_n


@torch.no_grad()
def update_(cfg: OptConfig, grads: dict, state: OptState, params: dict):
    """One AdamW step in place: each parameter tensor takes its new value
    and ``state``'s ``mu``/``nu`` dicts their new moments; ``grads`` is
    emptied as it is used.  Returns (new_state, metrics)."""
    scale, gnorm, step, lr = _scalars(cfg, grads, state)
    for n, p in params.items():
        g = grads.pop(n)
        g = g * scale.to(g.dtype)
        new_p, state.mu[n], state.nu[n] = _leaf(cfg, g, state.mu[n], state.nu[n], p, lr,
                                                step.float())
        p.copy_(new_p)
        del g, new_p
    return OptState(state.mu, state.nu, step), {"lr": lr, "grad_norm": gnorm}


def update(cfg: OptConfig, grads: dict, state: OptState, params: dict):
    """The reference's functional AdamW step: returns ``(new_params,
    new_state, metrics)`` and leaves ``grads``, ``state`` and ``params`` as
    they were (``update_`` on copies of them)."""
    new_params = {n: p.detach().clone() for n, p in params.items()}
    copy = OptState({n: m.clone() for n, m in state.mu.items()},
                    {n: m.clone() for n, m in state.nu.items()}, state.step.clone())
    new_state, metrics = update_(cfg, dict(grads), copy, new_params)
    return new_params, new_state, metrics
