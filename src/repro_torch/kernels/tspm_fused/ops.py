"""Wrapper of the fused mine+screen kernel: corpus-free [2^H] bucket counts.

``fused_bucket_counts`` equals ``sparsity.local_bucket_counts`` over the
mined corpus, without the corpus.  Dispatch follows the tensor's device:

  * a CUDA tensor with unfused ids launches ``csrc/tspm_fused.cu`` over
    the cohort in rounds of consecutive patients (:func:`fused_rounds`),
    each round's pairs, as the host reckons them from ``nevents``, within
    the plan's ``round_pairs`` (``analysis.roofline.mining_tile_plan``, or
    the caller's): above 2^15 buckets the kernel bins each counted pair
    through a scratch of 2 B a pair, so the rounds bound the pass's memory;
    every round adds into the one table;
  * a CUDA tensor with fused-duration ids, whose dedup depends on the
    duration and so does not follow the kernel's per-row lookbacks, takes
    the blocked materializing path on the card: ``tspm_pairgen`` then
    ``local_bucket_counts`` (``seq_hist``) per patient block of the plan;
  * a CPU tensor takes the plain version, ``ref.fused_bucket_counts_ref``,
    round by round for unfused ids.

Any other device raises.  ``fused_bucket_counts.launches`` counts calls of
the ``tspm_fused`` C entry point: one per round.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.analysis import roofline
from repro_torch.core import encoding, mining, sparsity
from repro_torch.core.encoding import as_tensor
from repro_torch.kernels import _build
from repro_torch.kernels import bucket_count as bc
from repro_torch.kernels.tspm_fused import ref

_NAME = "tspm_fused"
MAX_LOG2 = 30


def _kernel():
    fn = _build.load(_NAME).tspm_fused
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def row_pairs(nevents, max_events: int) -> np.ndarray:
    """int64 n(n-1)/2 of each patient, n = nevents clipped to [0, E]: the
    most pairs its row can count."""
    n = np.clip(np.asarray(nevents, np.int64).reshape(-1), 0, max_events)
    return n * (n - 1) // 2


def fused_rounds(nevents, max_events: int, cap_pairs: int) -> list[tuple[int, int, int]]:
    """(start, stop, pairs) of each round: consecutive patients, every
    patient once and in order, whose pairs (:func:`row_pairs`) sum to at
    most ``cap_pairs``; a patient over the cap alone is a round of its own.
    An empty cohort has no round."""
    pairs = row_pairs(nevents, max_events)
    total = np.concatenate([[0], np.cumsum(pairs)])
    rounds, start = [], 0
    while start < len(pairs):
        # the most patients from start whose pairs fit, one at least
        stop = max(start + 1, int(np.searchsorted(total, total[start] + cap_pairs,
                                                  side="right")) - 1)
        rounds.append((start, stop, int(total[stop] - total[start])))
        start = stop
    return rounds


def round_scratch_bytes(rounds, n_buckets_log2: int, grid: int) -> int:
    """The scratch every round of ``rounds`` fits (0 for a shared table)."""
    parts = bc.n_partitions(1 << n_buckets_log2)
    if parts == 1 or not rounds:
        return 0
    return bc.scratch_bytes(max(r[2] for r in rounds), parts, grid)


def fused_bucket_counts(phenx, date, nevents, codec: str = "bit",
                        fuse_duration: bool = False, bucket_days: int = 30,
                        n_buckets_log2: int = 20, backend: str = "auto",
                        block_patients: int | None = None,
                        round_pairs: int | None = None) -> torch.Tensor:
    """Corpus-free [2^H] int32 bucket counts == local_bucket_counts(mine(...)).

    ``backend`` follows ``mining.mine``: 'torch' (the plain branch) raises
    for a CUDA tensor; otherwise the tensor's device decides.
    ``block_patients`` overrides the plan's patient block of the
    materializing paths and ``round_pairs`` its pairs a round (the table
    depends on neither)."""
    phenx = as_tensor(phenx, torch.int32)
    date = as_tensor(date, torch.int32)
    nevents = as_tensor(nevents, torch.int32).reshape(-1)
    H = n_buckets_log2
    dev = phenx.device
    mining.resolve_backend(backend, dev)
    if codec not in encoding.CODECS:
        raise ValueError(f"unknown codec {codec!r}; expected one of {encoding.CODECS}")
    if not 1 <= H <= MAX_LOG2:
        raise ValueError(f"n_buckets_log2 must be in [1, {MAX_LOG2}], got {H}")
    P, E = phenx.shape if phenx.dim() == 2 else (0, 0)
    if P == 0 or E == 0:
        # zero-width guard: no events, empty table
        return torch.zeros(1 << H, dtype=torch.int32, device=dev)
    plan = roofline.mining_tile_plan(E, H, device=dev)
    blk = int(block_patients or plan.block_patients)
    if dev.type == "cpu":
        if fuse_duration:
            return ref.fused_bucket_counts_ref(phenx, date, nevents, codec, True,
                                               bucket_days, H, blk)
        counts = torch.zeros(1 << H, dtype=torch.int32)
        for a, b, _ in fused_rounds(nevents.numpy(), E, round_pairs or plan.round_pairs):
            counts += ref.fused_bucket_counts_ref(phenx[a:b], date[a:b], nevents[a:b],
                                                  codec, False, bucket_days, H, blk)
        return counts
    if dev.type != "cuda":
        raise ValueError(f"fused_bucket_counts runs on CUDA or CPU tensors, not {dev}")
    if date.shape != phenx.shape or nevents.shape != (P,) or \
            date.device != dev or nevents.device != dev:
        raise ValueError(f"shapes phenx {tuple(phenx.shape)}, date "
                         f"{tuple(date.shape)}, nevents {tuple(nevents.shape)} "
                         "on one device")
    if fuse_duration:
        return _blocked_counts(phenx, date, nevents, codec, bucket_days, H, blk)
    return fused_table(phenx, nevents, H, codec, plan, round_pairs)


def _blocked_counts(phenx, date, nevents, codec, bucket_days, H, blk):
    """Fused-duration ids on the card: one dense [blk, E, E] slab at a time
    through the pair-generation and histogram kernels."""
    from repro_torch.kernels.tspm_pairgen import ops as pairgen_ops

    counts = torch.zeros(1 << H, dtype=torch.int32, device=phenx.device)
    for s in range(0, phenx.shape[0], blk):
        e = s + blk
        m = pairgen_ops.pairgen(phenx[s:e], date[s:e], nevents[s:e], codec=codec,
                                fuse_duration=True, bucket_days=bucket_days)
        rows = m.seq.shape[0]
        counts += sparsity.local_bucket_counts(
            m.seq.reshape(rows, -1), m.mask.reshape(rows, -1), H)
        del m
    return counts


def fused_table(phenx, nevents, n_buckets_log2: int, codec: str = "bit",
                plan: roofline.MiningTilePlan | None = None,
                round_pairs: int | None = None) -> torch.Tensor:
    """The CUDA kernel over a [P, E] cohort on the card, round by round
    (:func:`fused_rounds`): [2^H] int32 counts of unfused ids
    (== ``ref.fused_table_ref``)."""
    phenx = as_tensor(phenx, torch.int32).contiguous()
    nevents = as_tensor(nevents, torch.int32).reshape(-1).contiguous()
    H = n_buckets_log2
    if phenx.device.type != "cuda" or nevents.device != phenx.device:
        raise ValueError(f"fused_table launches on CUDA tensors, got phenx on "
                         f"{phenx.device} and nevents on {nevents.device}")
    if phenx.dim() != 2 or nevents.shape != phenx.shape[:1]:
        raise ValueError(f"shapes phenx {tuple(phenx.shape)}, nevents "
                         f"{tuple(nevents.shape)}")
    if codec not in encoding.CODECS:
        raise ValueError(f"unknown codec {codec!r}; expected one of {encoding.CODECS}")
    if not 1 <= H <= MAX_LOG2:
        raise ValueError(f"n_buckets_log2 must be in [1, {MAX_LOG2}], got {H}")
    P, E = phenx.shape
    dev = phenx.device
    plan = plan or roofline.mining_tile_plan(E, H, device=dev)
    if plan.smem_bytes > bc.SMEM_PER_BLOCK:
        raise ValueError(f"E={E} at H={H} needs {plan.smem_bytes} B of shared "
                         f"memory per block, over {bc.SMEM_PER_BLOCK}")
    out = torch.zeros(1 << H, dtype=torch.int32, device=dev)
    if not (P and E):
        return out
    rounds = fused_rounds(nevents.cpu().numpy(), E, round_pairs or plan.round_pairs)
    if max(r[2] for r in rounds) >= 2**32:
        raise ValueError("a patient's pairs exceed the kernel's 32-bit offsets")
    sms = bc.sm_count(dev)
    max_grid = sms * plan.blocks_per_sm
    scratch_len = round_scratch_bytes(rounds, H, max_grid)
    scratch = torch.empty(scratch_len, dtype=torch.uint8, device=dev)
    parts = bc.n_partitions(1 << H)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for a, b, pairs in rounds:
            rc = _kernel()(phenx[a].data_ptr(), nevents[a].data_ptr(), out.data_ptr(),
                           b - a, E, encoding.CODECS.index(codec), H,
                           scratch.data_ptr() if scratch_len else None, scratch_len,
                           pairs, min(b - a, max_grid),
                           bc.part_blocks(parts, sms, pairs), plan.threads, stream)
            _build.check(_NAME, rc)
            fused_bucket_counts.launches += 1
    return out


fused_bucket_counts.launches = 0
