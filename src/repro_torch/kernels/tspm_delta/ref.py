"""Plain PyTorch version of the delta pair-generation kernel ([P, E, D] slab).

``delta_planes_ref`` gives the TPU kernel's four planes; the packed
``Mined`` slab the CUDA kernel writes is ``stream.delta.delta_mine_torch``,
these planes plus the wrapper's packing.
"""
from __future__ import annotations

import torch

from repro_torch.core.encoding import as_tensor


def delta_planes_ref(phenx, date, n_old, n_new, new_phenx, new_date):
    """Reference (start, end, duration, mask) planes, each [P, E, D]."""
    phenx = as_tensor(phenx, torch.int32)
    date = as_tensor(date, torch.int32)
    n_old = as_tensor(n_old, torch.int32)
    n_new = as_tensor(n_new, torch.int32)
    new_phenx = as_tensor(new_phenx, torch.int32)
    new_date = as_tensor(new_date, torch.int32)
    E = phenx.shape[-1]
    D = new_phenx.shape[-1]
    gi = torch.arange(E, dtype=torch.int32, device=phenx.device)[None, :, None]
    gj = torch.arange(D, dtype=torch.int32, device=phenx.device)[None, None, :]
    mask = (gi < n_old[:, None, None] + gj) & (gj < n_new[:, None, None])
    minus_one = torch.tensor(-1, dtype=torch.int32, device=phenx.device)
    zero = torch.tensor(0, dtype=torch.int32, device=phenx.device)
    s = torch.where(mask, phenx[:, :, None], minus_one)
    e = torch.where(mask, new_phenx[:, None, :], minus_one)
    dur = torch.where(mask, new_date[:, None, :] - date[:, :, None], zero)
    return s, e, dur, mask
