"""Wrapper of the histogram kernel: int32 bucket counts of masked ids.

``hist(h, mask, n_buckets)`` is the contract of the TPU kernel: for a CUDA
tensor it launches ``csrc/seq_hist.cu`` (shared-memory atomics up to
``MAX_SHARED_BUCKETS``, global atomics above, any table size); for a CPU
tensor it takes the plain version (``ref.hist_ref``).  Any other device
raises.  It is the counting step of ``core/sparsity.local_bucket_counts``;
the per-patient sort and first-occurrence flags stay torch ops there.
``hist.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.encoding import as_tensor
from repro_torch.kernels import _build
from repro_torch.kernels.seq_hist import ref

_NAME = "seq_hist"
MAX_SHARED_BUCKETS = 1 << 15   # a 128 KB int32 table per block


def _kernel():
    fn = _build.load(_NAME).seq_hist
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
    out = torch.zeros(n_buckets, dtype=torch.int32, device=h.device)
    if h.numel():
        _launch(h, mask, out, shared=n_buckets <= MAX_SHARED_BUCKETS)
        hist.launches += 1
    return out


def _launch(h, mask, out, shared: bool) -> None:
    """Adds the counts of CUDA ``h`` under ``mask`` into ``out`` on the
    shared-memory path or the global-atomics path.  ``hist`` picks the path
    from the table size; the smoke script times both at one size."""
    h = h.reshape(-1).contiguous()
    mask = mask.reshape(-1).contiguous()
    with torch.cuda.device(h.device):
        rc = _kernel()(h.data_ptr(), mask.data_ptr(), h.numel(), out.data_ptr(),
                       out.numel(), int(shared),
                       torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(_NAME, rc)


hist.launches = 0
