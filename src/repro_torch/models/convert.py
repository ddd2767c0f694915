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

The xLSTM family's tree stacks each pattern position's blocks ``blk{i}``
over ``n_rep`` repetitions (layer ``rep * len(pattern) + i``); an sLSTM's
recurrent ``r [4, H, dh, dh]`` is kept as it is.  The hybrid family's
stacks its Mamba2 layers ``mamba [n_groups, every]`` (layer ``g * every +
i``; ``conv_w [K, conv]``, ``conv_b``, ``a_log``, ``d_skip`` and
``dt_bias`` kept as they are) and its shared blocks ``shared
[n_shared_attn_blocks]``.  The encoder-decoder family's stacks ``enc
[n_enc_layers]`` and ``dec [n_dec_layers]`` (a decoder layer adds
``ln_x`` and ``xattn``) become ``enc.{i}`` and ``dec.{i}``, beside
``ln_enc``, ``ln_f`` and the tied ``embed``, carried once.  Linear weights
are transposed in every family.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import model as model_lib
from repro_torch.models import transformer, xlstm, zamba

_NORMS = ("ln1", "ln2")
_POST_NORMS = ("ln1b", "ln2b")
_EXPERTS = ("router", "w_gate", "w_up", "w_down")    # kept as they are


def _at(a, idx):
    a = np.asarray(a)
    return a[idx] if idx is not None else a


def _linear(out, prefix, lin, idx=None):
    out[f"{prefix}.weight"] = np.swapaxes(_at(lin["w"], idx), -1, -2)
    if "b" in lin:
        out[f"{prefix}.bias"] = _at(lin["b"], idx)


def _xlstm_arrays(cfg, tree, out) -> None:
    pattern = xlstm.pattern_of(cfg)
    for layer in range(cfg.n_layers):
        rep, i = divmod(layer, len(pattern))
        blk, pre = tree[f"blk{i}"], f"blocks.{layer}"
        for name in ("ln", "hn"):
            out[f"{pre}.{name}.scale"] = _at(blk[name]["scale"], rep)
        lins = ("wq", "wk", "wv", "wz", "wg", "wo") if pattern[i] == "m" else ("wx", "wo")
        for name in lins:
            _linear(out, f"{pre}.{name}", blk[name], rep)
        if pattern[i] == "s":
            out[f"{pre}.r"] = _at(blk["r"], rep)


def _zamba_arrays(cfg, tree, out) -> None:
    _, every = zamba._groups(cfg)
    for layer in range(cfg.n_layers):
        idx, mb, pre = divmod(layer, every), tree["mamba"], f"mamba.{layer}"
        for name in ("ln", "hn"):
            out[f"{pre}.{name}.scale"] = _at(mb[name]["scale"], idx)
        for name in ("in_proj", "out_proj"):
            _linear(out, f"{pre}.{name}", mb[name], idx)
        for name in ("conv_w", "conv_b", "a_log", "d_skip", "dt_bias"):
            out[f"{pre}.{name}"] = _at(mb[name], idx)
    sh = tree["shared"]
    for j in range(cfg.n_shared_attn_blocks):
        pre = f"shared.{j}"
        for name in ("ln1", "ln2"):
            out[f"{pre}.{name}.scale"] = _at(sh[name]["scale"], j)
        for name in ("wq", "wk", "wv", "wo"):
            _linear(out, f"{pre}.attn.{name}", sh["attn"][name], j)
        for name in ("gate", "up", "down"):
            _linear(out, f"{pre}.mlp.{name}", sh["mlp"][name], j)
        _linear(out, f"{pre}.down", sh["down"], j)


def _encdec_arrays(cfg, tree, out) -> None:
    for side, n in (("enc", cfg.n_enc_layers), ("dec", cfg.n_dec_layers)):
        st = tree[side]
        norms, attns = (("ln1", "ln2", "ln_x"), ("attn", "xattn")) if side == "dec" \
            else (("ln1", "ln2"), ("attn",))
        for i in range(n):
            pre = f"{side}.{i}"
            for name in norms:
                out[f"{pre}.{name}.scale"] = _at(st[name]["scale"], i)
            for a in attns:
                for name in ("wq", "wk", "wv", "wo"):
                    _linear(out, f"{pre}.{a}.{name}", st[a][name], i)
            for name in ("gate", "up", "down"):
                _linear(out, f"{pre}.mlp.{name}", st["mlp"][name], i)
    out["ln_enc.scale"] = np.asarray(tree["ln_enc"]["scale"])


_FAMILY_ARRAYS = {"xlstm": _xlstm_arrays, "hybrid": _zamba_arrays, "encdec": _encdec_arrays}


def named_arrays(cfg, tree) -> dict[str, np.ndarray]:
    """The leaves of ``tree`` (shaped like the reference's params of
    ``cfg``) by the port's parameter names, in the port's layout."""
    out = {"embed.table": np.asarray(tree["embed"]["table"])}
    if cfg.family in _FAMILY_ARRAYS:
        _FAMILY_ARRAYS[cfg.family](cfg, tree, out)
        out["ln_f.scale"] = np.asarray(tree["ln_f"]["scale"])
        return out
    pattern = transformer.pattern_of(cfg)

    def linear(prefix, lin, rep=None):
        _linear(out, prefix, lin, rep)

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
def from_jax_params(cfg, params) -> torch.nn.Module:
    """The port's model of ``cfg``'s family, on the CPU, holding the
    reference's ``params``."""
    model = model_lib.MODULES[cfg.family](cfg, "cpu")
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
