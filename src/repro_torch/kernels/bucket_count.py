"""Host mirror of ``csrc/bucket_count.cuh``, the counting layout that
``seq_hist`` and ``tspm_fused`` share, and of the card's per-SM limits it
is sized against.

A table of at most 2^15 buckets is a private shared-memory table a block;
a larger one is cut into partitions of 2^15 buckets, binned through a
scratch of uint16 local buckets (2 B an id) and each block's offsets, and
counted partition by partition.  Everything here is pure arithmetic of the
sizes, read by both wrappers, ``analysis.roofline`` and ``core.chunking``.
"""
from __future__ import annotations

import functools

import torch

PART_LOG2 = 15
MAX_SHARED_BUCKETS = 1 << PART_LOG2    # a 128 KB int32 table per block
GROUP_PARTS = 64                       # partitions one pipeline pass takes
WARP_BIN_IDS = 4096                    # a warp's bins of uint16 local buckets
MAX_GRID = 1024                        # bounds the offsets' scratch
# stage (b): a block a partition for every 4 Mi ids it may count, up to
# one block on every SM (a few ids count faster in one block a partition,
# whose plain adds skip the flush's global atomics)
COUNT_IDS_PER_BLOCK = 1 << 22

# Hopper (sm_90): 2,048 threads and 228 KB of shared memory an SM, at most
# 227 KB a block, 1 KB of it reserved a block
MAX_THREADS_PER_SM = 2048
SMEM_PER_SM = 228 * 1024
SMEM_PER_BLOCK = 227 * 1024
SMEM_RESERVED_PER_BLOCK = 1024


def stage_bytes(warps: int) -> int:
    """``bucket_count::stage_bytes``: the block's offsets of a group, then
    each warp's bins and its count of each partition of a group."""
    return GROUP_PARTS * 4 + warps * (WARP_BIN_IDS * 2 + GROUP_PARTS * 4)


def n_partitions(n_buckets: int) -> int:
    """1 when the table fits one block's shared memory, else the number of
    2^15-bucket partitions."""
    if n_buckets <= MAX_SHARED_BUCKETS:
        return 1
    return -(-n_buckets // MAX_SHARED_BUCKETS)


def scratch_bytes(cap_ids: int, partitions: int, grid: int) -> int:
    """``bucket_count::scratch_bytes``: uint16 ids, padded to 16 B, then one
    uint32 offset per (partition of a group, block) and the total."""
    return -(-2 * cap_ids // 16) * 16 + 4 * (min(partitions, GROUP_PARTS) * grid + 1)


def blocks_per_sm(smem_bytes: int, threads: int) -> int:
    """Blocks of ``threads`` using ``smem_bytes`` of shared memory each
    that one SM holds at once (one at least)."""
    return max(1, min(MAX_THREADS_PER_SM // threads,
                      SMEM_PER_SM // (smem_bytes + SMEM_RESERVED_PER_BLOCK)))


def part_blocks(partitions: int, sms: int, ids: int) -> int:
    """Stage (b)'s blocks a partition for at most ``ids`` counted ids."""
    return max(1, min(sms // min(partitions, GROUP_PARTS), ids // COUNT_IDS_PER_BLOCK))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The SMs of CUDA ``device``."""
    device = torch.device(device)
    return _sms(device.index if device.index is not None else torch.cuda.current_device())
