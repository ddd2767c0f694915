"""Explicit PartitionSpecs for batches and decode caches, per family.

Parameter specs come from the model's modules (``layers.param_specs``);
these cover the *other* step inputs.  ``batch_axes`` is ``('pod',
'data')`` on the multi-pod mesh, ``('data',)`` single-pod, and every axis
with TP off.  The caches follow the port's layout (``model.init_caches``:
a list by layer where the reference stacks layers on a leading axis), so
each spec is the reference's with its stacked-layer leading Nones dropped;
an attention cache's ``pos`` is a host int and takes ``P()``.
"""
from __future__ import annotations

from torch.utils._pytree import tree_map

from repro_torch.distributed.sharding import P, param_shardings
from repro_torch.models import ssm_common


def batch_axes_of(mesh, cfg=None) -> tuple:
    axes = ("pod", "data") if cfg is None or cfg.tp_internals \
        else ("pod", "data", "model")   # TP off: pure wide DP
    return tuple(a for a in axes if a in mesh.mesh_dim_names)


def _batch_entry(mesh, cfg):
    ba = batch_axes_of(mesh, cfg)
    return ba if len(ba) > 1 else (ba[0] if ba else None)


def batch_pspecs(cfg, batch_tree, mesh):
    """Every batch input sharded on its leading (batch) dim."""
    b = _batch_entry(mesh, cfg)
    return tree_map(lambda t: P(b, *([None] * (t.ndim - 1))), batch_tree)


def _attn_cache_spec(b, mode="heads") -> dict:
    """KV cache layout [B, S, Hkv, hd]: shard heads over 'model' (classic
    TP) or the SEQUENCE dim ('seq': flash-decode style, the softmax over
    the sharded dim turns into small stat reductions instead of a gather
    of the cache)."""
    if mode == "seq":
        return {"k": P(b, "model", None, None), "v": P(b, "model", None, None),
                "pos": P()}
    return {"k": P(b, None, "model", None), "v": P(b, None, "model", None), "pos": P()}


def cache_pspecs(cfg, caches, mesh):
    """Spec tree matching ``model.init_caches``' output for each family."""
    b = _batch_entry(mesh, cfg)
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return [_attn_cache_spec(b, cfg.decode_kv_shard) for _ in caches]
    if fam == "xlstm":
        tp = "model" if cfg.tp_internals else None
        out = []
        for reps in caches:
            specs = []
            for c in reps:
                if isinstance(c, ssm_common.ScanState):
                    specs.append(ssm_common.ScanState(P(b, None, None, tp), P(b, None, None)))
                else:  # slstm dict h/c/n/m: [B, H, dh]
                    specs.append({k: P(b, None, tp) for k in c})
            out.append(specs)
        return tuple(out)
    if fam == "hybrid":
        mamba = (P(b, None, "model"),                                   # conv state
                 ssm_common.ScanState(P(b, "model", None, None), P(b, "model", None)))
        return {"mamba": [[mamba for _ in group] for group in caches["mamba"]],
                "attn": [_attn_cache_spec(b, cfg.decode_kv_shard) for _ in caches["attn"]]}
    if fam == "encdec":
        return {"attn": [_attn_cache_spec(b, cfg.decode_kv_shard) for _ in caches["attn"]],
                "memory": P(b, None, None)}
    raise ValueError(fam)


def to_shardings(mesh, spec_tree, struct_tree=None):
    """Spec tree -> ``NamedSharding`` tree, sanitized against the struct
    shapes when given."""
    return param_shardings(mesh, spec_tree, struct_tree)
