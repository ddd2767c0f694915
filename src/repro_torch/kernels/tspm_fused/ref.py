"""Plain PyTorch versions of the fused mine+screen bucket counting.

``block_bucket_counts`` is the semantic contract of ``kernels/tspm_fused``:
mine a patient block to the dense pair layout, then fold it into the
[2^H] hash-bucket table with one contribution per distinct (patient, id)
— ``sparsity.local_bucket_counts`` applied to ``mining.mine_dense``.
``fused_bucket_counts_ref`` is the block loop over it (counts add over
disjoint patient blocks), and the CPU branch of ``ops.fused_bucket_counts``.

``fused_table_ref`` is the plain version of the CUDA kernel's own
algorithm, which never forms the corpus: a pair ``(i, j)`` of a row counts
iff ``i < j < nevents``, ``i`` is the first occurrence of ``x_i`` in the
row, and no occurrence of ``x_j`` lies strictly between ``i`` and ``j``.
With ``prev[k]`` the last position before ``k`` holding ``x_k`` (-1 when
none), that is ``prev[i] < 0 and prev[j] <= i``: exactly one pair per
distinct value pair ``(x_i, x_j)`` of the row, ``x_i == x_j`` included.
The kernel is held against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import encoding, mining, sparsity
from repro_torch.core.encoding import as_tensor

# patients per step of fused_table_ref's loop: bounds its [block, E, E]
# compare and id planes
_TABLE_REF_BLOCK = 256


def block_bucket_counts(phenx, date, nevents, codec: str = "bit",
                        fuse_duration: bool = False, bucket_days: int = 30,
                        n_buckets_log2: int = 20) -> torch.Tensor:
    """[2^H] int32 distinct-patient bucket counts of one patient block."""
    m = mining.mine_dense(phenx, date, nevents, codec, fuse_duration,
                          bucket_days)
    P = m.seq.shape[0]
    return sparsity.local_bucket_counts(
        m.seq.reshape(P, -1), m.mask.reshape(P, -1), n_buckets_log2)


def fused_bucket_counts_ref(phenx, date, nevents, codec: str = "bit",
                            fuse_duration: bool = False, bucket_days: int = 30,
                            n_buckets_log2: int = 20,
                            block_patients: int = 256) -> torch.Tensor:
    """Whole-cohort table: block loop over :func:`block_bucket_counts`.

    Each distinct (patient, id) contributes once, to the same bucket,
    whichever block its patient lands in, so any block size gives the
    single-shot table."""
    phenx = as_tensor(phenx, torch.int32)
    P = phenx.shape[0] if phenx.dim() == 2 else 0
    counts = torch.zeros(1 << n_buckets_log2, dtype=torch.int32,
                         device=phenx.device)
    for s in range(0, P, block_patients):
        e = s + block_patients
        counts += block_bucket_counts(
            phenx[s:e], as_tensor(date, torch.int32)[s:e],
            as_tensor(nevents, torch.int32)[s:e], codec, fuse_duration,
            bucket_days, n_buckets_log2)
    return counts


def lookback(phenx) -> torch.Tensor:
    """[P, E] int32 ``prev``: the last position before each one holding the
    same code in its row, -1 when there is none."""
    phenx = as_tensor(phenx, torch.int32)
    E = phenx.shape[-1]
    if E == 0:
        return torch.zeros_like(phenx)
    k = torch.arange(E, dtype=torch.int32, device=phenx.device)
    # earlier[p, i, k]: position k < i holds the code at position i
    earlier = (phenx[:, None, :] == phenx[:, :, None]) & (k[None, :] < k[:, None])
    return torch.where(earlier, k, -1).amax(dim=2)


def fused_table_ref(phenx, nevents, n_buckets_log2: int,
                    codec: str = "bit") -> torch.Tensor:
    """[2^H] int32 bucket counts by the kernel's algorithm (unfused ids)."""
    phenx = as_tensor(phenx, torch.int32)
    nevents = as_tensor(nevents, torch.int32).reshape(-1)
    counts = torch.zeros(1 << n_buckets_log2, dtype=torch.int32,
                         device=phenx.device)
    if phenx.dim() != 2 or 0 in phenx.shape:
        return counts
    E = phenx.shape[1]
    k = torch.arange(E, dtype=torch.int32, device=phenx.device)
    for s in range(0, phenx.shape[0], _TABLE_REF_BLOCK):
        x, n = phenx[s:s + _TABLE_REF_BLOCK], nevents[s:s + _TABLE_REF_BLOCK]
        prev = lookback(x)
        i, j = k[None, :, None], k[None, None, :]
        counted = ((i < j) & (j < n[:, None, None])
                   & (prev[:, :, None] < 0) & (prev[:, None, :] <= i))
        ids = encoding.pack(x[:, :, None], x[:, None, :], codec)
        h = sparsity.hash_bucket(ids[counted], n_buckets_log2).to(torch.int64)
        counts += torch.bincount(h, minlength=1 << n_buckets_log2).to(torch.int32)
    return counts
