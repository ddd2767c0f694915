"""Wrapper of the histogram kernel: int32 bucket counts of masked ids.

``hist(h, mask, n_buckets)`` is the contract of the TPU kernel: for a CUDA
tensor it launches ``csrc/seq_hist.cu``; for a CPU tensor it takes the
plain version (``ref.hist_ref``).  Any other device raises.  It is the
counting step of ``core/sparsity.local_bucket_counts`` and of the stream
sketch; the per-patient sort and first-occurrence flags stay torch ops
there.

The kernel has three routes, picked by :func:`route` from the sizes alone:

  * ``shared``: a table of at most 2^15 buckets, a private copy in each
    block's shared memory;
  * ``partitioned`` (``csrc/bucket_count.cuh``): larger tables over at
    least ``GLOBAL_MAX_ELEMENTS`` elements, cut into partitions of 2^15
    buckets binned through a scratch of 2 B an element (sized for every
    element, since the mask is not read on the host) and counted in
    shared memory: no counted id is a global atomic;
  * ``global``: larger tables over fewer elements (the stream's ticks, the
    chunked engine's pieces), a global atomic a counted id, where its one
    launch beats the partitioned route's four (the crossover is measured
    beside ``GLOBAL_MAX_ELEMENTS``).

:func:`count_plan` is the host arithmetic of a launch (route, grid, blocks
a partition, scratch bytes), a pure function of the sizes and the card's
SM count (the layout's arithmetic is ``kernels/bucket_count.py``).
``hist.launches`` counts calls of the C entry point, one per
``hist`` call on a CUDA tensor with elements, and ``hist.route_launches``
the same by route.  ``bucket_counts`` is the reference's entry over mined
``[P, T]`` ids (row dedupe, hash, ``hist``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.encoding import as_tensor
from repro_torch.kernels import _build
from repro_torch.kernels import bucket_count as bc
from repro_torch.kernels.seq_hist import ref

_NAME = "seq_hist"
ROUTES = ("shared", "global", "partitioned")     # csrc/seq_hist.cu kRoute*
# the partitioned route's least input: below it the global route is as
# fast or faster.  Measured on an H100 80GB HBM3 at 700 W (card_probe.py
# count, leading runs of a Table 1 fit block's ids, H = 20, CUDA events
# over whole calls in turns): partitioned vs global 0.074 vs 0.048 ms at
# 2^23 elements, 0.086 vs 0.083 at 2^24, 0.143 vs 0.158 at 2^25, 0.252 vs
# 0.304 at 2^26
GLOBAL_MAX_ELEMENTS = 1 << 25
GLOBAL_THREADS = 512
GLOBAL_BLOCKS_PER_SM = 16
THREADS = 256
WARPS = THREADS // 32
STEP = THREADS * 16                    # elements a block takes a step
STAGE_BYTES = bc.stage_bytes(WARPS)


@dataclasses.dataclass(frozen=True)
class CountPlan:
    """One launch of the count: its ``route``, the ``partitions`` of 2^15
    buckets (1: the private shared table), ``grid`` blocks over the input,
    ``part_blocks`` blocks counting each partition in stage (b) and the
    ``scratch_bytes`` the wrapper allocates (0 but on the partitioned
    route)."""

    route: str
    partitions: int
    grid: int
    part_blocks: int
    scratch_bytes: int

    @property
    def shared_table(self) -> bool:
        return self.route == "shared"


def route(n: int, n_buckets: int) -> str:
    """The route of ``n`` elements into ``n_buckets`` (see the module)."""
    if n_buckets <= bc.MAX_SHARED_BUCKETS:
        return "shared"
    return "global" if n < GLOBAL_MAX_ELEMENTS else "partitioned"


def count_plan(n: int, n_buckets: int, sms: int, force_route: str | None = None) -> CountPlan:
    """The launch of ``hist`` over ``n`` elements into ``n_buckets``
    (``force_route``: another route that takes the table, for timing)."""
    chosen = force_route or route(n, n_buckets)
    parts = bc.n_partitions(n_buckets)
    want = max(1, -(-n // STEP))
    if chosen == "shared":
        grid = min(want, sms * bc.blocks_per_sm(4 * n_buckets, THREADS))
        return CountPlan("shared", 1, grid, 1, 0)
    if chosen == "global":
        grid = min(max(1, -(-n // GLOBAL_THREADS)), sms * GLOBAL_BLOCKS_PER_SM)
        return CountPlan("global", parts, grid, 1, 0)
    grid = min(want, sms * bc.blocks_per_sm(STAGE_BYTES, THREADS), bc.MAX_GRID)
    return CountPlan("partitioned", parts, grid, bc.part_blocks(parts, sms, n),
                     bc.scratch_bytes(n, parts, grid))


@functools.cache
def _kernel():
    fn = _build.load(_NAME).seq_hist
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hist(h, mask, n_buckets: int) -> torch.Tensor:
    """Bucket counts [n_buckets] int32 of ids ``h`` under ``mask``."""
    h = as_tensor(h, torch.int32)
    mask = as_tensor(mask, torch.bool)
    if h.device.type == "cpu":
        return ref.hist_ref(h, mask, n_buckets)
    if h.device.type != "cuda":
        raise ValueError(f"hist runs on CUDA or CPU tensors, not {h.device}")
    if mask.shape != h.shape or mask.device != h.device:
        raise ValueError(f"mask {tuple(mask.shape)} on {mask.device} does not "
                         f"match h {tuple(h.shape)} on {h.device}")
    if not 1 <= n_buckets < 2**31:
        raise ValueError(f"n_buckets must be in [1, 2^31), got {n_buckets}")
    if h.numel() >= 2**32:
        raise ValueError(f"{h.numel()} elements exceed the kernel's 32-bit offsets")
    out = torch.zeros(n_buckets, dtype=torch.int32, device=h.device)
    if h.numel():
        chosen = _launch(h, mask, out)
        hist.launches += 1
        hist.route_launches[chosen] += 1
    return out


def bucket_counts(seq, mask, n_buckets_log2: int) -> torch.Tensor:
    """Distinct-patient bucket counts (int32 ``[2^n_buckets_log2]``) of
    mined ``[P, T]`` ids under ``mask``: each row's ids deduplicated by a
    sort, hashed and counted with :func:`hist`, which is
    ``core/sparsity.local_bucket_counts``.  (The reference's ``interpret``
    and ``force_kernel`` choose between its TPU kernel and a scatter; the
    card's kernel takes every table size.)"""
    from repro_torch.core import sparsity

    return sparsity.local_bucket_counts(seq, mask, n_buckets_log2)


def _launch(h, mask, out, force_route: str | None = None) -> str:
    """Adds the counts of CUDA ``h`` under ``mask`` into ``out`` by the
    plan of :func:`count_plan` and returns its route (``force_route``
    times another route that takes the table)."""
    h = h.reshape(-1).contiguous()
    mask = mask.reshape(-1).contiguous()
    plan = count_plan(h.numel(), out.numel(), bc.sm_count(h.device), force_route)
    scratch = (torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=h.device)
               if plan.scratch_bytes else None)
    with torch.cuda.device(h.device):
        rc = _kernel()(h.data_ptr(), mask.data_ptr(), h.numel(), out.data_ptr(),
                       out.numel(), scratch.data_ptr() if scratch is not None else None,
                       plan.scratch_bytes, plan.grid, plan.part_blocks,
                       ROUTES.index(plan.route),
                       torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(_NAME, rc)
    return plan.route


hist.launches = 0
hist.route_launches = {r: 0 for r in ROUTES}
