"""Delta mining: pair only *new* events against stored history.

The batch miner (core/mining) fills the dense ``[P, E, E]`` pair matrix;
after appending ``d`` events to an ``n``-event history only the last ``d``
columns are new, so the streaming hot loop computes the ``[P, E, D]`` slab

    seq[p, i, j] = pack(phenx[p, i], new_phenx[p, j])
    valid iff     i < n_old[p] + j   and   j < n_new[p]

where the i-axis spans the *updated* history planes (delta already written
at the cursors) — new-x-new pairs are the ``i >= n_old`` rows of the same
slab.  ``delta_mine`` dispatches between the plain version below and the
kernel wrapper (kernels/tspm_delta), with ``mining.mine``'s backend rule.
"""
from __future__ import annotations

import torch

from repro_torch.core import encoding, mining
from repro_torch.core.encoding import as_tensor
from repro_torch.core.mining import Mined
from repro_torch.kernels.tspm_delta.ref import delta_planes_ref


def delta_mine_torch(
    phenx, date, n_old, n_new, new_phenx, new_date, codec: str = "bit",
    fuse_duration: bool = False, bucket_days: int = 30,
) -> Mined:
    """Plain-torch delta mining to the dense [P, E, D] slab — the plain
    version of the ``tspm_delta`` kernel."""
    s, e, dur, mask = delta_planes_ref(
        phenx, date, n_old, n_new, new_phenx, new_date)
    seq = encoding.pack(torch.clamp(s, min=0), torch.clamp(e, min=0), codec)
    if fuse_duration:
        seq = encoding.fuse_duration(
            seq, encoding.bucket_duration(dur, bucket_days))
    return Mined(torch.where(mask, seq, encoding.SENTINEL), dur, mask)


def delta_mine(
    phenx, date, n_old, n_new, new_phenx, new_date, codec: str = "bit",
    fuse_duration: bool = False, bucket_days: int = 30,
    backend: str = "auto",
) -> Mined:
    """Mine the new-pair slab.  backend: 'kernel' | 'torch' | 'auto'.

    'kernel' goes through the ``tspm_delta`` wrapper (the CUDA kernel for
    CUDA tensors, its plain version for CPU tensors); 'torch' is the plain
    version, for CPU tensors only (it raises on CUDA input); 'auto' takes
    'kernel' for CUDA input and 'torch' otherwise (``mining.resolve_backend``).
    Every call records its slab shape ``(B, Ew, D)`` in ``delta_mine.shapes``
    (the shape specializations ``obs.RetraceTracker`` counts)."""
    phenx = as_tensor(phenx, torch.int32)
    delta_mine.shapes.add((phenx.shape[0], phenx.shape[1],
                           as_tensor(new_phenx, torch.int32).shape[1]))
    if mining.resolve_backend(backend, phenx.device) == "kernel":
        from repro_torch.kernels.tspm_delta import ops as delta_ops

        return delta_ops.delta_pairgen(
            phenx, date, n_old, n_new, new_phenx, new_date, codec=codec,
            fuse_duration=fuse_duration, bucket_days=bucket_days)
    return delta_mine_torch(phenx, date, n_old, n_new, new_phenx, new_date,
                            codec, fuse_duration, bucket_days)


delta_mine.shapes = set()


def count_delta_pairs(n_old, n_new) -> torch.Tensor:
    """Closed-form new-pair count: sum_p [ d*n_old + d(d-1)/2 ] — the
    O(delta * n) streaming cost (vs the batch n(n-1)/2 re-mine)."""
    n_old = as_tensor(n_old, torch.int64)
    d = as_tensor(n_new, torch.int64)
    return torch.sum(d * n_old + torch.div(d * (d - 1), 2, rounding_mode="floor"))
