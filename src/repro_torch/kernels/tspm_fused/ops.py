"""Wrapper of the fused mine+screen kernel: corpus-free [2^H] bucket counts.

``fused_bucket_counts`` equals ``sparsity.local_bucket_counts`` over the
mined corpus, without the corpus.  Dispatch follows the tensor's device:

  * a CUDA tensor with unfused ids launches ``csrc/tspm_fused.cu`` once
    over the whole cohort, with the launch shape of
    ``analysis.roofline.mining_tile_plan`` (any table size: a shared-memory
    table up to 2^15 buckets, global atomics above);
  * a CUDA tensor with fused-duration ids, whose dedup depends on the
    duration and so does not follow the kernel's per-row lookbacks, takes
    the blocked materializing path on the card: ``tspm_pairgen`` then
    ``local_bucket_counts`` (``seq_hist``) per patient block of the plan;
  * a CPU tensor takes the plain version, ``ref.fused_bucket_counts_ref``.

Any other device raises.  ``fused_bucket_counts.launches`` counts launches
of the ``tspm_fused`` kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis import roofline
from repro_torch.core import encoding, mining, sparsity
from repro_torch.core.encoding import as_tensor
from repro_torch.kernels import _build
from repro_torch.kernels.tspm_fused import ref

_NAME = "tspm_fused"
MAX_LOG2 = 30


def _kernel():
    fn = _build.load(_NAME).tspm_fused
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_bucket_counts(phenx, date, nevents, codec: str = "bit",
                        fuse_duration: bool = False, bucket_days: int = 30,
                        n_buckets_log2: int = 20, backend: str = "auto",
                        block_patients: int | None = None) -> torch.Tensor:
    """Corpus-free [2^H] int32 bucket counts == local_bucket_counts(mine(...)).

    ``backend`` follows ``mining.mine``: 'torch' (the plain branch) raises
    for a CUDA tensor; otherwise the tensor's device decides.
    ``block_patients`` overrides the plan's patient block of the
    materializing paths (the table does not depend on it)."""
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
        return ref.fused_bucket_counts_ref(phenx, date, nevents, codec,
                                           fuse_duration, bucket_days, H, blk)
    if dev.type != "cuda":
        raise ValueError(f"fused_bucket_counts runs on CUDA or CPU tensors, not {dev}")
    if date.shape != phenx.shape or nevents.shape != (P,) or \
            date.device != dev or nevents.device != dev:
        raise ValueError(f"shapes phenx {tuple(phenx.shape)}, date "
                         f"{tuple(date.shape)}, nevents {tuple(nevents.shape)} "
                         "on one device")
    if fuse_duration:
        return _blocked_counts(phenx, date, nevents, codec, bucket_days, H, blk)
    return fused_table(phenx, nevents, H, codec, plan)


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
                plan: roofline.MiningTilePlan | None = None) -> torch.Tensor:
    """One launch of the CUDA kernel over a [P, E] cohort on the card:
    [2^H] int32 counts of unfused ids (== ``ref.fused_table_ref``)."""
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
    if E * E >= 2**31:
        raise ValueError(f"E={E} events per patient exceed the kernel's int32 pair index")
    plan = plan or roofline.mining_tile_plan(E, H, device=phenx.device)
    if plan.smem_bytes > roofline.SMEM_PER_BLOCK:
        raise ValueError(f"E={E} at H={H} needs {plan.smem_bytes} B of shared "
                         f"memory per block, over {roofline.SMEM_PER_BLOCK}")
    dev = phenx.device
    out = torch.zeros(1 << H, dtype=torch.int32, device=dev)
    if P and E:
        with torch.cuda.device(dev):
            rc = _kernel()(phenx.data_ptr(), nevents.data_ptr(), out.data_ptr(),
                           P, E, encoding.CODECS.index(codec), H,
                           int(plan.shared_table), plan.threads,
                           plan.blocks_per_sm,
                           torch.cuda.current_stream(dev).cuda_stream)
        _build.check(_NAME, rc)
        fused_bucket_counts.launches += 1
    return out


fused_bucket_counts.launches = 0
