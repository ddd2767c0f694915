"""Block and launch plan of the fused mine+screen kernel on Hopper.

The reference's ``mining_tile_plan`` fits 128-lane tiles and a bucket-tile
accumulator into 16 MB of TPU VMEM.  None of that carries over: the CUDA
kernel (``csrc/tspm_fused.cu``) has no tiles, holds one patient row (and,
for tables of up to 2^15 buckets, a private table) in shared memory, and
loops a persistent grid over patients.  What stays is the patient block of
the counting pass where pairs are materialized: fused-duration ids on the
card (``tspm_pairgen`` + ``local_bucket_counts`` per block) and the plain
version on the CPU, each of which holds one dense ``[block, E, E]`` slab.

The block is sized from the device's total memory on the card and from a
fixed default on the CPU, never from the memory free at that moment, so a
plan is the same from run to run.
"""
from __future__ import annotations

import dataclasses

import torch

# dense block working set of the materializing counting pass: 8 B seq +
# 4 B dur + 1 B mask, x2 for the row sort's scratch (chunking.BYTES_PER_PAIR)
FUSED_BLOCK_BYTES_PER_PAIR = 26
CPU_BLOCK_BYTES = 8 << 20          # the plain version's slab on the CPU
DEVICE_MEMORY_SHARE = 16           # the card's slab: total memory / 16
PAD_MULTIPLE = 8                   # the dbmart's row padding

# the kernel's launch shape on Hopper (sm_90: 2,048 threads, 228 KB of
# shared memory per SM, at most 227 KB per block, 1 KB reserved per block)
THREADS = 256
MAX_THREADS_PER_SM = 2048
SMEM_PER_SM = 228 * 1024
SMEM_PER_BLOCK = 227 * 1024
SMEM_RESERVED_PER_BLOCK = 1024
MAX_SHARED_BUCKETS = 1 << 15       # a 128 KB int32 table per block


@dataclasses.dataclass(frozen=True)
class MiningTilePlan:
    """How the fused counting pass runs for one (E, H).

    ``block_patients`` bounds the dense slab of the materializing pass at
    ``block_bytes``; ``threads``, ``blocks_per_sm``, ``shared_table`` and
    ``smem_bytes`` are the CUDA kernel's launch shape (a persistent grid of
    ``blocks_per_sm`` blocks on every SM)."""

    block_patients: int
    block_bytes: int
    threads: int
    blocks_per_sm: int
    shared_table: bool
    smem_bytes: int


def _block_bytes(device) -> int:
    device = torch.device(device)
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        return int(props.total_memory) // DEVICE_MEMORY_SHARE
    return CPU_BLOCK_BYTES


def mining_tile_plan(max_events: int, n_buckets_log2: int, *,
                     device) -> MiningTilePlan:
    """The plan for rows of ``max_events`` and a 2^``n_buckets_log2`` table
    on ``device``."""
    e = max(-(-max(int(max_events), 1) // PAD_MULTIPLE) * PAD_MULTIPLE, 1)
    block_bytes = _block_bytes(device)
    blk = max(1, block_bytes // (e * e * FUSED_BLOCK_BYTES_PER_PAIR))
    shared = (1 << n_buckets_log2) <= MAX_SHARED_BUCKETS
    smem = ((1 << n_buckets_log2) if shared else 0) * 4 + 2 * e * 4
    blocks = min(MAX_THREADS_PER_SM // THREADS,
                 max(1, SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK)))
    return MiningTilePlan(block_patients=blk, block_bytes=block_bytes,
                          threads=THREADS, blocks_per_sm=blocks,
                          shared_table=shared, smem_bytes=smem)
