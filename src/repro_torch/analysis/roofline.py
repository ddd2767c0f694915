"""Block, launch and round plan of the fused mine+screen kernel on Hopper.

The reference's ``mining_tile_plan`` fits 128-lane tiles and a bucket-tile
accumulator into 16 MB of TPU VMEM.  None of that carries over: the CUDA
kernel (``csrc/tspm_fused.cu``) has no tiles, holds one patient row in
shared memory (its codes and lookbacks, or for a long row the lookbacks
alone; beside it, for tables of up to 2^15 buckets, a private table, and
above that the staging bins of ``csrc/bucket_count.cuh``) and loops a
persistent grid over patients.  What stays is the patient block of the
counting pass where pairs are materialized: fused-duration ids on the
card (``tspm_pairgen`` + ``local_bucket_counts`` per block) and the plain
version on the CPU, each of which holds one dense ``[block, E, E]`` slab.
New here is ``round_pairs``: above 2^15 buckets the kernel bins every
counted pair through 2 B of scratch, so the cohort runs in rounds of at
most that many pairs (``FUSED_SCRATCH_BYTES`` of scratch).

The block is sized from the device's total memory on the card and from a
fixed default on the CPU, and the rounds from a fixed scratch, never from
the memory free at that moment, so a plan is the same from run to run.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import bucket_count as bc

# dense block working set of the materializing counting pass: 8 B seq +
# 4 B dur + 1 B mask, x2 for the row sort's scratch (chunking.BYTES_PER_PAIR)
FUSED_BLOCK_BYTES_PER_PAIR = 26
CPU_BLOCK_BYTES = 8 << 20          # the plain version's slab on the CPU
DEVICE_MEMORY_SHARE = 16           # the card's slab: total memory / 16
PAD_MULTIPLE = 8                   # the dbmart's row padding

# the kernel's block on Hopper (the SM's limits: kernels/bucket_count.py)
THREADS = 256
# the counting pass's pair scratch a round, 2 B a pair: 134,217,728 pairs,
# so Table 2's 590,101,929 take 5 rounds and the pass stays far under 1 GB
FUSED_SCRATCH_BYTES = 256 << 20


@dataclasses.dataclass(frozen=True)
class MiningTilePlan:
    """How the fused counting pass runs for one (E, H).

    ``block_patients`` bounds the dense slab of the materializing pass at
    ``block_bytes``; ``threads``, ``blocks_per_sm``, ``shared_table``,
    ``compact_row`` and ``smem_bytes`` are the CUDA kernel's launch shape
    (a persistent grid of ``blocks_per_sm`` blocks on every SM);
    ``round_pairs`` bounds the pairs of one round of the kernel (its
    scratch at 2 B a pair)."""

    block_patients: int
    block_bytes: int
    threads: int
    blocks_per_sm: int
    shared_table: bool
    compact_row: bool
    smem_bytes: int
    round_pairs: int


def _block_bytes(device) -> int:
    device = torch.device(device)
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        return int(props.total_memory) // DEVICE_MEMORY_SHARE
    return CPU_BLOCK_BYTES


def set_slots(max_events: int) -> int:
    """``tspm_fused.cu``'s set of positions: a power of two, at least twice
    the events and at least 4."""
    cap = 4
    while cap < 2 * max_events:
        cap *= 2
    return cap


def row_bytes(max_events: int, compact: bool = False) -> int:
    """``tspm_fused.cu``'s ``row_bytes``, rounded up to 16 B: the full
    layout holds a row's codes, 4 B an event, and the set of positions
    (the lookbacks over it), 4 B a slot; the compact layout the lookbacks
    alone (its codes stay in global memory)."""
    raw = 4 * max_events + (0 if compact else 4 * set_slots(max_events))
    return -(-raw // 16) * 16


def mining_tile_plan(max_events: int, n_buckets_log2: int, *,
                     device) -> MiningTilePlan:
    """The plan for rows of ``max_events`` and a 2^``n_buckets_log2`` table
    on ``device``.  Its row takes the full layout where that fits beside
    the table or the stage in one block's shared memory, else the compact
    one; ``smem_bytes`` over ``bucket_count.SMEM_PER_BLOCK`` means the
    kernel cannot take such rows."""
    e = max(-(-max(int(max_events), 1) // PAD_MULTIPLE) * PAD_MULTIPLE, 1)
    block_bytes = _block_bytes(device)
    blk = max(1, block_bytes // (e * e * FUSED_BLOCK_BYTES_PER_PAIR))
    shared = (1 << n_buckets_log2) <= bc.MAX_SHARED_BUCKETS
    beside = (1 << n_buckets_log2) * 4 if shared else bc.stage_bytes(THREADS // 32)
    compact = row_bytes(e) + beside > bc.SMEM_PER_BLOCK
    smem = row_bytes(e, compact) + beside
    return MiningTilePlan(block_patients=blk, block_bytes=block_bytes,
                          threads=THREADS, blocks_per_sm=bc.blocks_per_sm(smem, THREADS),
                          shared_table=shared, compact_row=compact, smem_bytes=smem,
                          round_pairs=FUSED_SCRATCH_BYTES // 2)
