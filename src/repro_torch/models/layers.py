"""Building blocks of the dense decoder as ``nn.Module``s.

Each module holds its parameters in PyTorch's layout (a linear weight is
``[d_out, d_in]``; the reference stores ``[d_in, d_out]``,
``models/convert.py`` transposes) and computes what the reference's
function of the same name computes:

* ``rmsnorm`` scales by ``1 + scale`` in float32 and casts back;
* RoPE rotates interleaved pairs ``x[..., ::2]`` / ``x[..., 1::2]``;
* ``mlp``'s GELU is the tanh approximation (``jax.nn.gelu``'s default).

Parameters are allocated on the module's device and filled by
``init_weights`` from an explicit ``torch.Generator``, with the
reference's truncated-normal scales (``layers.truncnorm``).  They are
made without ``requires_grad``, so serving builds no graph;
``training.train_loop.init_state`` turns gradients on for training.

Each module also carries its parameters' logical sharding specs, the
reference's ``PartitionSpec``s as tuples (``'model'`` the TP/EP axis, the
config's FSDP axis, None), in ``specs``: parameter name -> one entry a
dimension of the port's tensor (a linear weight's spec is the reference's
transposed, as the weight is).  ``param_specs`` collects them under the
model's parameter names.  On a mesh (``distributed/sharding``) the
parameters are DTensors laid out by those specs, and ``linear`` and the
embedding gather a weight's FSDP shards before use (``gather_fsdp``); on
one card nothing shards with them.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import gather_fsdp

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dt(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def truncnorm_(t: torch.Tensor, scale: float, generator) -> torch.Tensor:
    """Fill ``t`` with a standard normal truncated to [-2, 2], times
    ``scale``, drawn in float32 and cast to ``t``'s dtype."""
    x = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.copy_(x * scale)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


def param_specs(module: nn.Module) -> dict[str, tuple]:
    """Every parameter's logical spec (its module's ``specs``) under
    ``module.named_parameters()``'s name."""
    out = {}
    for prefix, m in module.named_modules():
        for name, spec in getattr(m, "specs", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = spec
    return out


class Linear(nn.Module):
    """``spec`` is the reference's spec of its ``w [d_in, d_out]``."""

    def __init__(self, d_in, d_out, dtype, device, bias=False, spec=(None, None)):
        super().__init__()
        self.weight = _param((d_out, d_in), dtype, device)
        self.bias = _param((d_out,), dtype, device) if bias else None
        self.specs = {"weight": (spec[1], spec[0])}
        if bias:
            self.specs["bias"] = (spec[1],)

    def init_weights(self, generator):
        truncnorm_(self.weight, self.weight.shape[1] ** -0.5, generator)
        if self.bias is not None:
            self.bias.zero_()


def linear(p: Linear, x):
    return F.linear(x, gather_fsdp(p.weight).to(x.dtype),
                    None if p.bias is None else gather_fsdp(p.bias).to(x.dtype))


class RMSNorm(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.scale = _param((d,), dtype, device)
        self.specs = {"scale": (None,)}

    def init_weights(self, generator=None):
        self.scale.zero_()


def rmsnorm(p: RMSNorm, x, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + p.scale.float())).to(x.dtype)


class Embedding(nn.Module):
    def __init__(self, vocab, d, dtype, device, fsdp=None):
        super().__init__()
        self.table = _param((vocab, d), dtype, device)
        self.specs = {"table": ("model", fsdp)}

    def init_weights(self, generator):
        truncnorm_(self.table, 1.0, generator)


def embed_lookup(p: Embedding, tokens, scale=False):
    """Rows of the table for ``tokens``, as the reference's ``jnp.take``:
    an id in [-V, -1] wraps to ``id + V``, and any id outside [-V, V) gives
    a row of NaN.  The gather reads clamped ids only, so an out-of-range id
    never indexes past the table (on the card that would be a device-side
    assert, which leaves the CUDA context unusable)."""
    t = gather_fsdp(p.table)
    V = t.shape[0]
    tokens = torch.as_tensor(tokens, device=t.device)
    inside = (tokens >= -V) & (tokens < V)
    ids = torch.where(tokens < 0, tokens + V, tokens).clamp(0, V - 1)
    # on a mesh, F.embedding takes DTensor's vocab-parallel lookup (a masked
    # gather and one all-reduce) where indexing would gather the table
    y = F.embedding(ids, t) if isinstance(t, DTensor) else t[ids]
    y = torch.where(inside[..., None], y, torch.full((), float("nan"), dtype=t.dtype,
                                                     device=t.device))
    if scale:   # sqrt(d) rounded to the table's dtype first, as the reference
        y = y * float(torch.tensor(t.shape[1] ** 0.5, dtype=y.dtype))
    return y


def embed_logits(p: Embedding, x, softcap=None):
    logits = x @ gather_fsdp(p.table).to(x.dtype).T
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# --- rotary embeddings ------------------------------------------------------
@functools.lru_cache(maxsize=16)
def _rope_freqs(rot: int, theta: float, device: torch.device) -> torch.Tensor:
    """The rotation frequencies, computed on the CPU and copied to
    ``device`` once, so the card and the CPU rotate by the same float32
    frequencies and no layer waits on a copy.  Fake positions (a dry run
    under a ``FakeTensorMode``) take them uncached: a fake tensor must not
    stay in the cache for a real run, nor a real one reach a fake run."""
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32),
                      -torch.arange(0, rot, 2, dtype=torch.float32) / rot)
    return freqs.to(device)


def rope_angles(positions, hd, fraction=1.0, theta=10_000.0):
    """cos/sin tables [..., hd_rot/2] for the rotated fraction of hd."""
    rot = int(hd * fraction) // 2 * 2
    freqs = _rope_freqs.__wrapped__ if isinstance(positions, FakeTensor) else _rope_freqs
    ang = positions[..., None].float() * freqs(rot, float(theta), positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, fraction=1.0):
    """x [..., S, H, hd]; cos/sin [..., S, rot/2] broadcast over heads."""
    hd = x.shape[-1]
    rot = int(hd * fraction) // 2 * 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr, xp], dim=-1) if rot < hd else yr


# --- MLP ---------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, d, ff, dtype, device, fsdp=None):
        super().__init__()
        self.gate = Linear(d, ff, dtype, device, spec=(fsdp, "model"))
        self.up = Linear(d, ff, dtype, device, spec=(fsdp, "model"))
        self.down = Linear(ff, d, dtype, device, spec=("model", fsdp))

    def init_weights(self, generator):
        for lin in (self.gate, self.up, self.down):
            lin.init_weights(generator)


def mlp(p: MLP, x, act="silu"):
    a = F.silu if act == "silu" else (lambda y: F.gelu(y, approximate="tanh"))
    return linear(p.down, a(linear(p.gate, x)) * linear(p.up, x))
