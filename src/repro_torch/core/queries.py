"""Sequence utility queries (the paper's C++ helper functions).

The library "facilitates tasks such as extracting [sequences] with given
start phenX, end phenX or specified minimum durations.  Another function
combines these ... all sequences that end with a phenX which is an end phenX
of all sequences with a given start phenX" — the transitive expansion used
by the Post-COVID vignette.  All masks compose with the mining mask.

Duration-fused ids (``encoding.fuse_duration``) carry the bucketed duration
in the low ``DUR_BITS``; every helper takes ``fused=True`` to strip it
before unpacking — unpacking a fused id raw would read garbage phenX codes.
"""
from __future__ import annotations

import torch

from repro_torch.core import encoding
from repro_torch.core.encoding import SENTINEL, as_tensor
from repro_torch.core.sparsity import run_starts, stable_order

_INT32_MAX = 2**31 - 1


def unpack_seq(seq, codec: str = "bit", fused: bool = False):
    """(start, end) phenX of a sequence id, stripping a fused duration
    bucket first when ``fused``."""
    seq = as_tensor(seq, torch.int64)
    if fused:
        seq, _ = encoding.split_duration(seq)
    return encoding.unpack(seq, codec)


def starts_with(seq, phenx_id, codec: str = "bit", fused: bool = False):
    s, _ = unpack_seq(seq, codec, fused)
    return s == int(phenx_id)


def ends_with(seq, phenx_id, codec: str = "bit", fused: bool = False):
    _, e = unpack_seq(seq, codec, fused)
    return e == int(phenx_id)


def min_duration(dur, days: int):
    return as_tensor(dur, torch.int32) >= int(days)


def _membership(values, table_sorted):
    """value in sorted sentinel-padded table (vectorized binary search)."""
    idx = torch.searchsorted(table_sorted, values)
    idx = torch.clamp(idx, 0, table_sorted.shape[0] - 1)
    return table_sorted[idx] == values


def end_set(seq, mask, start_phenx_id, codec: str = "bit", max_set: int | None = None,
            fused: bool = False):
    """Sorted, sentinel-padded set of end-phenX over sequences starting with
    ``start_phenx_id``.  ``max_set`` bounds the output size."""
    seq = as_tensor(seq, torch.int64).reshape(-1)
    mask = as_tensor(mask, torch.bool).reshape(-1)
    s, e = unpack_seq(seq, codec, fused)
    sel = mask & (s == int(start_phenx_id))
    ends = torch.sort(torch.where(sel, e.to(torch.int64), SENTINEL)).values
    ends = torch.sort(torch.where(run_starts(ends), ends, SENTINEL)).values
    if max_set is not None:
        ends = ends[:max_set]
    return ends


def transitive_ends_with(seq, mask, start_phenx_id, codec: str = "bit",
                         max_set: int | None = None, fused: bool = False):
    """Mask of sequences whose END phenX is an end of any sequence that
    STARTS with ``start_phenx_id`` (the paper's combined helper)."""
    table = end_set(seq, mask, start_phenx_id, codec, max_set, fused)
    _, e = unpack_seq(seq, codec, fused)
    return _membership(e.to(torch.int64), table) & as_tensor(mask, torch.bool)


def per_patient_pair_stats(seq, dur, patient, mask, n_patients: int, n_pairs: int):
    """For each (patient, sequence-id) group: occurrence count, min/max
    duration.  Grouping key = (patient, seq id); returns sorted keys
    plus stats aligned to the sorted layout.  Used by the Post-COVID rules
    ("occurs only once", "max duration spread < 2 buckets")."""
    seq = as_tensor(seq, torch.int64).reshape(-1)
    dur = as_tensor(dur, torch.int32).reshape(-1)
    patient = as_tensor(patient, torch.int32).reshape(-1)
    mask = as_tensor(mask, torch.bool).reshape(-1)
    n = seq.numel()
    key = torch.where(mask, seq, SENTINEL)
    # lexicographic (patient, seq) grouping; sentinel rows sort to the end
    pkey = torch.where(mask, patient, _INT32_MAX)
    order = stable_order(pkey, key)
    pkey, key, dur = pkey[order], key[order], dur[order]
    change = run_starts(key) | run_starts(pkey)
    seg = torch.cumsum(change, 0) - 1
    real = key != SENTINEL
    cnt = torch.zeros(n, dtype=torch.int32, device=seq.device)
    cnt.index_add_(0, seg, real.to(torch.int32))
    dmin = torch.full((n,), _INT32_MAX, dtype=torch.int32, device=seq.device)
    dmin.scatter_reduce_(0, seg, torch.where(real, dur, _INT32_MAX), "amin")
    dmax = torch.full((n,), -_INT32_MAX - 1, dtype=torch.int32, device=seq.device)
    dmax.scatter_reduce_(0, seg, torch.where(real, dur, -1), "amax")
    return pkey, key, seg, cnt[seg], dmin[seg], dmax[seg], change
