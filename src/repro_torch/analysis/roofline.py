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

The LM half (``Roofline``, ``count_params``, ``model_flops``,
``shape_bytes``, ``format_table``) is the reference's three-term roofline
of a dry-run cell, priced at the card's spec-sheet peaks:

  compute    = FLOPs            / (chips * PEAK_FLOPS)
  memory     = HBM bytes        / (chips * HBM_BW)
  collective = collective bytes / (chips * NVLINK_BW)

``launch/dryrun`` fills it from ``analysis/costmodel``'s FLOPs and bytes,
over one card or a production mesh.  The reference's ``collective_bytes``
parses XLA's HLO; its twin here counts what the traced step issues:
``count_collective`` reads one op of ``torch.ops._c10d_functional`` (the
collectives DTensor issues) as the reference reads one HLO line, and
``launch/dryrun.RankCounts`` sums them by kind (``COLLECTIVES``), per
device, beside rank 0's FLOPs and peak bytes.  A
16-wide 'model' axis spans two 8-card NVLink domains, so pricing every
byte at ``NVLINK_BW`` makes ``t_collective`` a lower bound.
``fused_kernel_vmem`` prices TPU VMEM and has no twin.  MODEL_FLOPS (6*N*D train, 2*N*D inference;
active params for MoE) over the FLOPs measures the useful share.
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


# --- the LM roofline -------------------------------------------------------
# NVIDIA H100 SXM5 80GB, 700 W (NVIDIA's data sheet, dense rates)
PEAK_FLOPS = 989e12      # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12         # device-memory bytes/s
NVLINK_BW = 450e9        # NVLink bytes/s each way, one card to the others of its host
HBM_BYTES = 80e9         # device memory

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}


COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# the functional collectives' names (DTensor's, and torch's older spelling)
# -> the reference's kinds
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


def count_collective(func, args) -> tuple[str, int] | None:
    """(kind, operand bytes per device) of one op, or None when it is no
    collective.  The operand is the op's input, which is the reference's
    ``_line_collective`` convention: an all-gather's operand is its output
    over the group, a reduce-scatter's its output times the group."""
    ns, _, name = func._schema.name.partition("::")
    kind = _FUNCTIONAL.get(name) if ns in _NAMESPACES else None
    if kind is None:
        return None
    operand = args[0]
    tensors = operand if isinstance(operand, (list, tuple)) else [operand]
    return kind, sum(t.numel() * t.element_size() for t in tensors)


def shape_bytes(dtype: str, dims: str) -> int:
    """Bytes of a ``dtype[dims]`` shape in HLO's spelling (``"bf16"``,
    ``"2,3"``); an unknown dtype counts 4 bytes an element."""
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: dict
    model_flops: float
    bytes_per_device: float | None = None

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * NVLINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """model-useful compute time over the achievable step time
        (max of the three terms = the bound the step cannot beat)."""
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        useful = self.model_flops / (self.chips * PEAK_FLOPS)
        return useful / max(bound, 1e-12)

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "coll_breakdown": self.coll_breakdown,
            "bytes_per_device": self.bytes_per_device,
        }


def count_params(cfg) -> tuple[int, int]:
    """(total, active) parameter counts of ``cfg``'s model, built on the
    meta device (nothing allocated, nothing drawn)."""
    from repro_torch.models import model as model_lib

    module, _ = model_lib.abstract_init(model_lib.build(cfg))
    total = sum(p.numel() for p in module.parameters())
    active = total
    if cfg.n_experts:
        expert = 3 * cfg.d_model * cfg.moe_d_ff  # gate/up/down per expert
        n_moe_layers = cfg.n_layers // cfg.moe_interleave
        routed_all = n_moe_layers * cfg.n_experts * expert
        routed_active = n_moe_layers * cfg.experts_per_token * expert
        active = total - routed_all + routed_active
    return total, active


def model_flops(cfg, shape, active_params: int, embed_params: int = 0) -> float:
    """6*N*D for training; 2*N*D for prefill; 2*N*B for one decode step."""
    n = active_params - embed_params
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def format_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | t_compute | t_memory | t_coll | dominant | "
           "useful | roofline-frac |")
    sep = "|" + "---|" * 8
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.3e} | "
            f"{r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} | "
            f"{r['dominant']} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} |")
    return "\n".join(lines)
