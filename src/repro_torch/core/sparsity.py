"""Sparsity screening — sort-based (paper-faithful) and hash-based (scalable).

The paper screens sequences by *patient support*: a sequence is sparse when
it occurs for fewer than ``threshold`` distinct patients.  Its C++ recipe:

  1. parallel-sort all sequences by id (ips4o);
  2. linear pass: run boundaries -> per-sequence patient counts;
  3. mark sparse entries by writing UINT_MAX into the key;
  4. one more sort; truncate at the first sentinel.

``screen_sorted`` is that recipe on tensors (stable sorts + shifted
compare + segment sum + sentinel re-sort; "truncate" returns a
valid-prefix length instead of shrinking).  A stable sort on two keys is
two stable ``torch.sort`` passes, the secondary key first.

``screen_hash`` is the hash variant: per-patient dedupe, multiply-shift
hash into 2^H buckets, a histogram.  Collisions merge counts, so the error
is one-sided — a sparse sequence may survive, a non-sparse one is NEVER
dropped.  On a CUDA tensor the histogram is the ``seq_hist`` kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed import _functional_collectives as funcol

from repro_torch.core.encoding import SENTINEL, as_tensor
from repro_torch.distributed.sharding import current_rules
from repro_torch.kernels.seq_hist import ops as hist_ops

# ids per patient block of local_bucket_counts' row sort (512 MB of int64)
BLOCK_ELEMENTS = 1 << 26

# multiply-shift hash constant (odd; splitmix64's golden-gamma), as an
# unsigned Python int, and as the signed int64 with the same bits that the
# tensor arithmetic takes (the two must stay equal mod 2^64)
HASH_MULT = 0x9E3779B97F4A7C15
_HASH_K = -7046029254386353131


class Screened(NamedTuple):
    """Sort-compacted screening result (paper's post-truncate layout).

    Tensors are full length; the first ``n_kept`` entries are the surviving
    sequences in sorted-id order, the rest carry the SENTINEL key."""

    seq: torch.Tensor      # [N] int64, sorted, kept-prefix
    dur: torch.Tensor      # [N] int32
    patient: torch.Tensor  # [N] int32
    support: torch.Tensor  # [N] int32 distinct-patient support (0 on sentinel)
    n_kept: torch.Tensor   # scalar int64


def _flat(seq, patient, mask):
    return (as_tensor(seq, torch.int64).reshape(-1),
            as_tensor(patient, torch.int32).reshape(-1),
            as_tensor(mask, torch.bool).reshape(-1))


def stable_order(*keys: torch.Tensor) -> torch.Tensor:
    """Permutation that sorts lexicographically by ``keys`` (first key most
    significant), stable: ties keep their input order."""
    order = torch.arange(keys[0].numel(), device=keys[0].device)
    for k in reversed(keys):
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def run_starts(x: torch.Tensor) -> torch.Tensor:
    """[True, x[1:] != x[:-1]] — run starts of a sorted 1-D tensor."""
    return torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                      x[1:] != x[:-1]])


def _run_flags(keys, patients):
    """(new-sequence, new-(sequence,patient)) flags on sorted tensors."""
    seq_change = run_starts(keys)
    return seq_change, run_starts(patients) | seq_change


def _segment_support(seq_change, pat_change):
    n = seq_change.numel()
    seg = torch.cumsum(seq_change, 0) - 1
    seg_support = torch.zeros(n, dtype=torch.int32, device=seg.device)
    seg_support.index_add_(0, seg, pat_change.to(torch.int32))
    return seg_support[seg]


def support_counts(seq, patient, mask):
    """Distinct-patient support per element + unique table.

    Returns (sorted keys, sorted patients, per-element support, unique ids
    (sentinel-padded, sorted, compacted to front), unique supports,
    n_unique).
    """
    seq, patient, mask = _flat(seq, patient, mask)
    keys = torch.where(mask, seq, SENTINEL)
    order = stable_order(keys, patient)
    keys, patient = keys[order], patient[order]
    seq_change, pat_change = _run_flags(keys, patient)
    support = torch.where(keys != SENTINEL,
                          _segment_support(seq_change, pat_change), 0)
    first = seq_change & (keys != SENTINEL)
    u_key = torch.where(first, keys, SENTINEL)
    u_order = torch.sort(u_key, stable=True).indices
    u_support = torch.where(first, support, 0)[u_order]
    return keys, patient, support, u_key[u_order], u_support, torch.sum(first)


def screen_sorted(seq, dur, patient, mask, threshold) -> Screened:
    """Paper-faithful sort/mark/re-sort/truncate sparsity screen (exact)."""
    seq, patient, mask = _flat(seq, patient, mask)
    dur = as_tensor(dur, torch.int32).reshape(-1)

    keys = torch.where(mask, seq, SENTINEL)
    order = stable_order(keys, patient)
    keys, patient, dur = keys[order], patient[order], dur[order]
    seq_change, pat_change = _run_flags(keys, patient)
    support = _segment_support(seq_change, pat_change)
    keep = (support >= threshold) & (keys != SENTINEL)

    # the paper's marking trick: sparse entries get the sentinel key, one
    # more sort pushes them to the tail, n_kept is the truncation point.
    marked = torch.where(keep, keys, SENTINEL)
    order = stable_order(marked, patient)
    return Screened(marked[order], dur[order], patient[order],
                    torch.where(keep, support, 0)[order], torch.sum(keep))


# --- hash-based screen (beyond paper) ------------------------------------------
def hash_bucket(seq, n_buckets_log2: int) -> torch.Tensor:
    """Multiply-shift hash of int64 sequence ids into [0, 2^H).

    The int64 product wraps mod 2^64; after the mask an arithmetic and a
    logical right shift agree."""
    seq = as_tensor(seq, torch.int64)
    h = (seq * _HASH_K) >> (64 - n_buckets_log2)
    return (h & ((1 << n_buckets_log2) - 1)).to(torch.int32)


def row_first_flags(sorted_rows: torch.Tensor) -> torch.Tensor:
    """First-occurrence flags on row-wise sorted sentinel-padded id rows —
    the per-patient dedup step of the distinct-(patient, sequence) support."""
    first = torch.cat(
        [torch.ones((sorted_rows.shape[0], 1), dtype=torch.bool,
                    device=sorted_rows.device),
         sorted_rows[:, 1:] != sorted_rows[:, :-1]], dim=1)
    return first & (sorted_rows != SENTINEL)


def local_bucket_counts(seq, mask, n_buckets_log2: int,
                        block_elements: int = BLOCK_ELEMENTS) -> torch.Tensor:
    """Distinct-patient bucket counts (int32 [2^H]) for row-major [P, ...]
    input.

    Rows are patients; dedupes (patient, sequence) by a row-wise sort before
    counting, matching the paper's distinct-patient support semantics.  The
    rows are sorted, flagged and counted in patient blocks of at most
    ``block_elements`` ids (one row at least), so the sort's scratch is one
    block, not the whole slab; counts add over disjoint patients, so the
    table does not depend on the block.  The count itself is ``kernels/seq_hist`` (the
    CUDA kernel on the card, one launch per block).
    """
    seq = as_tensor(seq, torch.int64)
    mask = as_tensor(mask, torch.bool)
    P = seq.shape[0]
    n_buckets = 1 << n_buckets_log2
    counts = torch.zeros(n_buckets, dtype=torch.int32, device=seq.device)
    if P == 0:
        return counts
    seq, mask = seq.reshape(P, -1), mask.reshape(P, -1)
    blk = max(1, block_elements // max(seq.shape[1], 1))
    for s in range(0, P, blk):
        flat = torch.where(mask[s:s + blk], seq[s:s + blk], SENTINEL)
        srt = torch.sort(flat, dim=1).values
        del flat
        counts += hist_ops.hist(hash_bucket(srt, n_buckets_log2),
                                row_first_flags(srt), n_buckets)
        del srt     # before the next block's sort, whose scratch it would join
    return counts


def screen_hash(seq, mask, threshold, n_buckets_log2: int = 20,
                axis_names: tuple[str, ...] | None = None) -> torch.Tensor:
    """Keep-mask for [P, T] mined rows; one all-reduce when patient-sharded.

    Inside ``sharding.local_call`` pass ``axis_names`` (e.g. ``('pod',
    'data')``): the local bucket table (int32) is summed over the process
    group of each of those dimensions of the rules' mesh, as the
    reference's ``psum``, before it is applied to the local rows.
    One-sided error under collisions (false-keep only)."""
    counts = local_bucket_counts(seq, mask, n_buckets_log2)
    if axis_names:
        mesh, _ = current_rules()
        for axis in axis_names:
            counts = funcol.all_reduce(counts, "sum", mesh.get_group(axis))
    keep = counts[hash_bucket(seq, n_buckets_log2).to(torch.int64)] >= threshold
    return keep & as_tensor(mask, torch.bool)


def merge_bucket_counts(*counts):
    """Merge of per-chunk bucket count tables (chunked pipeline)."""
    out = counts[0]
    for c in counts[1:]:
        out = out + c
    return out


def screen_hash_from_counts(seq, mask, counts, threshold,
                            n_buckets_log2: int) -> torch.Tensor:
    """Apply a pre-merged global bucket-count table to a chunk (on the
    device of ``seq``)."""
    seq = as_tensor(seq, torch.int64)
    counts = as_tensor(counts, torch.int32).to(seq.device)
    h = hash_bucket(seq, n_buckets_log2).to(torch.int64)
    return (counts[h] >= threshold) & as_tensor(mask, torch.bool).to(seq.device)


def screen_survivors(seq, dur, patient, counts, threshold,
                     n_buckets_log2: int, mask=None):
    """Host-compacted survivors of the hash screen (corpus-free path).

    The materialization half of ``screen="fused"``: given the global
    bucket-count table from the corpus-free counting pass, keep only the
    rows (of ``mask``, default: every non-SENTINEL id) whose bucket clears
    ``threshold``, select them on the tensors' own device and copy only
    them to host numpy arrays.  Keeping is per-id, so supports, re-screens
    and the canonical order of the survivors are byte-identical to
    screening the materialized corpus with the same table.
    """
    seq = as_tensor(seq, torch.int64).reshape(-1)
    mask = (seq != SENTINEL if mask is None
            else as_tensor(mask, torch.bool).reshape(-1))
    keep = screen_hash_from_counts(seq, mask, counts, threshold, n_buckets_log2)
    idx = torch.nonzero(keep).squeeze(1)
    return tuple(as_tensor(a, dt).reshape(-1)[idx].cpu().numpy()
                 for a, dt in ((seq, torch.int64), (dur, torch.int32),
                               (patient, torch.int32)))
