"""Transitive sequence mining (the tSPM/tSPM+ core loop) in PyTorch.

For every patient, every ordered pair of events ``(i, j)`` with ``i < j`` in
(date-sorted) position order becomes one sequence:

    seq_id   = pack(phenx[i], phenx[j])       (64-bit, see encoding.py)
    duration = date[j] - date[i]              (days; >= 0 by the sort)

yielding exactly ``n(n-1)/2`` sequences per patient with ``n`` events —
the paper's count.  The C++ version grows thread-local vectors; here the
output is a *statically shaped, masked* tensor instead:

  * ``mine_triangular`` — packed upper-triangular ``[P, T]``, T = E(E-1)/2
    (plain torch; memory-lean);
  * ``mine_dense`` — dense ``[P, E, E]`` layout, masked below the diagonal
    (what the pair-generation kernel writes, and its plain version).

``mine(...)`` dispatches to the kernel wrapper (kernels/tspm_pairgen) or
the triangular plain version.  Every function returns tensors on the
device of its input.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import encoding
from repro_torch.core.encoding import as_tensor

BACKENDS = ("kernel", "torch", "auto")


class Mined(NamedTuple):
    """Masked mined sequences.  ``seq`` is int64 (optionally duration-fused),
    ``dur`` int32 days, ``mask`` marks real (non-padding) pairs.
    Patient identity is the leading row index (+ chunk offset)."""

    seq: torch.Tensor   # [P, T] or [P, E, E] int64
    dur: torch.Tensor   # int32
    mask: torch.Tensor  # bool

    @property
    def n_mined(self) -> torch.Tensor:
        return torch.sum(self.mask)


@functools.lru_cache(maxsize=64)
def pair_indices(E: int) -> tuple[np.ndarray, np.ndarray]:
    """Static upper-triangular (i, j) index pair table for E events."""
    i, j = np.triu_indices(E, k=1)
    return i.astype(np.int32), j.astype(np.int32)


def n_pairs(E: int) -> int:
    return E * (E - 1) // 2


def _inputs(phenx, date, nevents):
    return (as_tensor(phenx, torch.int32), as_tensor(date, torch.int32),
            as_tensor(nevents, torch.int32))


def _fuse(seq, dur, fuse_duration: bool, bucket_days: int):
    if not fuse_duration:
        return seq
    return encoding.fuse_duration(seq, encoding.bucket_duration(dur, bucket_days))


def mine_triangular(
    phenx, date, nevents, codec: str = "bit",
    fuse_duration: bool = False, bucket_days: int = 30,
) -> Mined:
    """Plain-torch mining to the packed-triangular [P, T] layout."""
    phenx, date, nevents = _inputs(phenx, date, nevents)
    i_np, j_np = pair_indices(phenx.shape[-1])
    i_idx = torch.from_numpy(i_np).to(device=phenx.device, dtype=torch.int64)
    j_idx = torch.from_numpy(j_np).to(device=phenx.device, dtype=torch.int64)
    seq = encoding.pack(phenx[:, i_idx], phenx[:, j_idx], codec)
    dur = date[:, j_idx] - date[:, i_idx]
    mask = j_idx[None, :] < nevents[:, None]
    seq = _fuse(seq, dur, fuse_duration, bucket_days)
    return Mined(torch.where(mask, seq, encoding.SENTINEL), dur * mask, mask)


def mine_dense(
    phenx, date, nevents, codec: str = "bit",
    fuse_duration: bool = False, bucket_days: int = 30,
) -> Mined:
    """Plain-torch mining to the dense [P, E, E] layout — the plain version
    of the pair-generation kernel."""
    phenx, date, nevents = _inputs(phenx, date, nevents)
    E = phenx.shape[-1]
    seq = encoding.pack(phenx[:, :, None], phenx[:, None, :], codec)
    dur = date[:, None, :] - date[:, :, None]
    ar = torch.arange(E, dtype=torch.int32, device=phenx.device)
    upper = ar[:, None] < ar[None, :]
    mask = upper[None] & (ar[None, None, :] < nevents[:, None, None])
    seq = _fuse(seq, dur, fuse_duration, bucket_days)
    return Mined(torch.where(mask, seq, encoding.SENTINEL), dur * mask, mask)


def resolve_backend(backend: str, device: torch.device | str) -> str:
    """'auto' -> 'kernel' on a CUDA device, else 'torch'.

    'torch' on a CUDA device raises: it would mine on the card without the
    pair-generation kernel, and a plain version runs only for CPU tensors.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    on_cuda = torch.device(device).type == "cuda"
    if backend == "auto":
        return "kernel" if on_cuda else "torch"
    if backend == "torch" and on_cuda:
        raise ValueError("backend 'torch' is the plain version for CPU tensors; "
                         "CUDA tensors take 'kernel' (or 'auto')")
    return backend


def mine(
    phenx, date, nevents, codec: str = "bit", fuse_duration: bool = False,
    bucket_days: int = 30, backend: str = "auto",
) -> Mined:
    """Mine transitive sequences.  backend: 'kernel' | 'torch' | 'auto'.

    'kernel' goes through the pair-generation kernel wrapper (dense
    layout): the CUDA kernel for CUDA tensors, its plain version for CPU
    tensors.  'torch' is the packed-triangular plain version, for CPU
    tensors only (it raises on CUDA input).  'auto' takes 'kernel' for CUDA
    input and 'torch' otherwise.
    """
    phenx, date, nevents = _inputs(phenx, date, nevents)
    if resolve_backend(backend, phenx.device) == "kernel":
        from repro_torch.kernels.tspm_pairgen import ops as pairgen_ops

        return pairgen_ops.pairgen(
            phenx, date, nevents, codec=codec, fuse_duration=fuse_duration,
            bucket_days=bucket_days)
    return mine_triangular(phenx, date, nevents, codec, fuse_duration, bucket_days)


def flatten(mined: Mined, patient_offset: int = 0):
    """[P, ...] masked layout -> flat (seq, dur, patient, mask) tensors."""
    P = mined.seq.shape[0]
    T = int(np.prod(mined.seq.shape[1:]))
    pat = (torch.arange(P, dtype=torch.int32, device=mined.seq.device)
           + patient_offset)[:, None].expand(P, T).reshape(-1)
    return (
        mined.seq.reshape(-1),
        mined.dur.reshape(-1),
        pat,
        mined.mask.reshape(-1),
    )


def count_sequences(nevents) -> torch.Tensor:
    """Closed-form total: sum_p n_p (n_p - 1) / 2 (the paper's count)."""
    n = as_tensor(nevents, torch.int64)
    return torch.sum(n * (n - 1) // 2)
