"""Carry the reference's parameters, and trees shaped like them, over to
the port.

The reference keeps a decoder's parameters as a tree
(``transformer.init``'s: ``blk{i}`` stacked over the pattern's
repetitions, linear weights ``[d_in, d_out]``), and so do its optimizer
moments and gradients.  ``named_arrays(cfg, tree)`` maps any such tree to
the port's parameter names (``Transformer.named_parameters()``): layer
``rep * len(pattern) + i`` is ``blk{i}[rep]``, and each linear weight is
transposed to PyTorch's ``[d_out, d_in]``.  An MoE layer's ``ffn`` is
``router [d, e]``, ``w_gate`` / ``w_up [e, d, ffe]`` and ``w_down [e, ffe,
d]`` in the reference's layout, which is the port's (``torch.bmm`` takes
it as it is: no transpose), and ``shared.{gate,up,down}``, linear weights
transposed as any other; a VLM's ``patch_proj`` is a linear weight.  ``from_jax_params`` builds the
port's model from reference params, ``named_tensors`` gives a tree as
tensors of the model's shapes (``train_loop.from_jax_train_state`` carries
the moments so).  Leaves are numpy arrays (``jax.tree.map(np.asarray,
tree)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer

_NORMS = ("ln1", "ln2")
_POST_NORMS = ("ln1b", "ln2b")
_EXPERTS = ("router", "w_gate", "w_up", "w_down")    # kept as they are


def named_arrays(cfg, tree) -> dict[str, np.ndarray]:
    """The leaves of ``tree`` (shaped like the reference's params of
    ``cfg``) by the port's parameter names, in the port's layout."""
    pattern = transformer.pattern_of(cfg)

    def linear(prefix, lin, rep=None):
        w = lin["w"] if rep is None else lin["w"][rep]
        out[f"{prefix}.weight"] = np.swapaxes(np.asarray(w), -1, -2)
        if "b" in lin:
            out[f"{prefix}.bias"] = np.asarray(lin["b"] if rep is None else lin["b"][rep])

    out = {"embed.table": np.asarray(tree["embed"]["table"])}
    for layer in range(cfg.n_layers):
        rep, i = divmod(layer, len(pattern))
        blk, pre = tree[f"blk{i}"], f"blocks.{layer}"
        for name in _NORMS + (_POST_NORMS if cfg.post_norms else ()):
            out[f"{pre}.{name}.scale"] = np.asarray(blk[name]["scale"][rep])
        for name in ("wq", "wk", "wv", "wo"):
            linear(f"{pre}.attn.{name}", blk["attn"][name], rep)
        ffn = blk["ffn"]
        if pattern[i] == "moe":
            for name in _EXPERTS:
                out[f"{pre}.ffn.{name}"] = np.asarray(ffn[name][rep])
            ffn, ffn_pre = ffn.get("shared"), f"{pre}.ffn.shared"
        else:
            ffn_pre = f"{pre}.ffn"
        if ffn is not None:
            for name in ("gate", "up", "down"):
                linear(f"{ffn_pre}.{name}", ffn[name], rep)
    out["ln_f.scale"] = np.asarray(tree["ln_f"]["scale"])
    if not cfg.tie_embeddings:
        linear("head", tree["head"])
    if cfg.family == "vlm":
        linear("patch_proj", tree["patch_proj"])
    return out


def _tensor(a, like: torch.Tensor, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.shape != tuple(like.shape):
        raise ValueError(f"shape {a.shape} != the port's {tuple(like.shape)}")
    # numpy has no bfloat16: go through float32, which holds it exactly
    t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
    return t.to(like.dtype if dtype is None else dtype)


def _same_names(arrays: dict, model: torch.nn.Module) -> None:
    names = {n for n, _ in model.named_parameters()}
    if set(arrays) != names:
        raise ValueError(f"the tree's leaves {sorted(set(arrays) ^ names)} do not "
                         f"match the port's parameters")


@torch.no_grad()
def from_jax_params(cfg, params) -> transformer.Transformer:
    """The port's model, on the CPU, holding the reference's ``params``."""
    model = transformer.Transformer(cfg, "cpu")
    arrays = named_arrays(cfg, params)
    _same_names(arrays, model)
    for name, p in model.named_parameters():
        p.copy_(_tensor(arrays[name], p))
    return model


def named_tensors(cfg, tree, model: torch.nn.Module,
                 dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """``named_arrays`` as CPU tensors of ``model``'s shapes, in ``dtype``
    (default: each parameter's)."""
    arrays = named_arrays(cfg, tree)
    _same_names(arrays, model)
    return {name: _tensor(arrays[name], p, dtype) for name, p in model.named_parameters()}
