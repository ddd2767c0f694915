"""The global screen's table merge over patient shards, and the LM
parameters' FSDP axis.

The reference's axis rules, ``constrain`` and ``param_shardings`` are the
LM side's tensor parallelism and wait for its port (ROADMAP.md queue 1
item 17.5); ``fsdp_axis_for`` names the axis the models' logical specs
(``models/layers.param_specs``) carry already.
"""
from __future__ import annotations

import torch

from repro_torch.core.encoding import as_tensor


def merge_sharded_counts(tables, mesh=None) -> torch.Tensor:
    """Global screen table from per-shard bucket-count tables.

    Per-shard sketch tables count distinct (patient, sequence) pairs over
    *disjoint* patient sets, so the global table is their elementwise sum
    (the reference's psum over the ``('data',)`` mesh).  Every table moves
    to ``mesh[0]`` (or to the first table's device without a mesh) with
    ``.to()``, device to device, and the sum runs there in int32."""
    tables = [as_tensor(t, torch.int32) for t in tables]
    dev = mesh[0] if mesh is not None else tables[0].device
    return torch.stack([t.to(dev) for t in tables]).sum(0, dtype=torch.int32)


def fsdp_axis_for(cfg):
    """The mesh axis (or axes) the FSDP dimension of a weight shards over:
    None without ``cfg.fsdp``; ``'data'``, or with TP off ``('data',
    'model')`` (the idle TP axis folded into FSDP)."""
    if not cfg.fsdp:
        return None
    return "data" if cfg.tp_internals else ("data", "model")
