"""Carry the reference's parameters over to the port.

``from_jax_params(cfg, params)`` takes the reference's param tree of a
dense decoder as numpy arrays (``transformer.init``'s tree: ``blk{i}``
stacked over the pattern's repetitions, linear weights ``[d_in, d_out]``)
and returns the port's ``Transformer`` with the same values: layer
``rep * len(pattern) + i`` is ``blk{i}[rep]``, and each linear weight is
transposed to PyTorch's ``[d_out, d_in]``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers, transformer


def _tensor(a, like: torch.Tensor) -> torch.Tensor:
    a = np.asarray(a)
    if a.shape != tuple(like.shape):
        raise ValueError(f"shape {a.shape} != the port's {tuple(like.shape)}")
    # numpy has no bfloat16: go through float32, which holds it exactly
    t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
    return t.to(like.dtype)


def _linear(lin: layers.Linear, tree, rep=None):
    w = tree["w"] if rep is None else tree["w"][rep]
    lin.weight.copy_(_tensor(np.swapaxes(w, -1, -2), lin.weight))
    if lin.bias is not None:
        lin.bias.copy_(_tensor(tree["b"] if rep is None else tree["b"][rep], lin.bias))


def _norm(norm: layers.RMSNorm, tree, rep=None):
    s = tree["scale"] if rep is None else tree["scale"][rep]
    norm.scale.copy_(_tensor(s, norm.scale))


@torch.no_grad()
def from_jax_params(cfg, params) -> transformer.Transformer:
    """The port's model, on the CPU, holding the reference's ``params``."""
    model = transformer.Transformer(cfg, "cpu")
    pattern = transformer.pattern_of(cfg)
    model.embed.table.copy_(_tensor(params["embed"]["table"], model.embed.table))
    for layer, blk in enumerate(model.blocks):
        rep, i = divmod(layer, len(pattern))
        tree = params[f"blk{i}"]
        for name in ("ln1", "ln2") + (("ln1b", "ln2b") if cfg.post_norms else ()):
            _norm(getattr(blk, name), tree[name], rep)
        for name in ("wq", "wk", "wv", "wo"):
            _linear(getattr(blk.attn, name), tree["attn"][name], rep)
        for name in ("gate", "up", "down"):
            _linear(getattr(blk.ffn, name), tree["ffn"][name], rep)
    _norm(model.ln_f, params["ln_f"])
    if model.head is not None:
        _linear(model.head, params["head"])
    return model
