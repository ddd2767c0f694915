"""Wrapper of the delta pair-generation kernel: the [P, E, D] ``Mined`` slab.

For a CUDA tensor it launches ``csrc/tspm_delta.cu``, which writes the
packed int64 ids (``SENTINEL`` on invalid slots, the fused duration bucket
when asked), the int32 durations and the bool mask in one pass.  For a CPU
tensor it takes the plain version (``stream.delta.delta_mine_torch``:
``ref.delta_planes_ref`` plus the packing).  Any other device raises.

The stream service hands in ``[B, Ew]`` row gathers of the store planes,
which are new contiguous tensors; the wrapper makes every input contiguous
(a no-op for those) and the kernel takes no strides.
``delta_pairgen.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.encoding import CODECS, as_tensor
from repro_torch.core.mining import Mined
from repro_torch.kernels import _build

_NAME = "tspm_delta"


def _kernel():
    fn = _build.load(_NAME).tspm_delta
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def delta_pairgen(phenx, date, n_old, n_new, new_phenx, new_date,
                  codec: str = "bit", fuse_duration: bool = False,
                  bucket_days: int = 30) -> Mined:
    """Kernel-backed delta mining to the [P, E, D] slab (== delta_mine_torch)."""
    phenx, date, new_phenx, new_date, n_old, n_new = (
        as_tensor(a, torch.int32).contiguous()
        for a in (phenx, date, new_phenx, new_date, n_old, n_new))
    if phenx.device.type == "cpu":
        from repro_torch.stream.delta import delta_mine_torch

        return delta_mine_torch(phenx, date, n_old, n_new, new_phenx,
                                new_date, codec, fuse_duration, bucket_days)
    if phenx.device.type != "cuda":
        raise ValueError(f"delta_pairgen runs on CUDA or CPU tensors, not {phenx.device}")
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}; expected one of {CODECS}")
    if phenx.dim() != 2 or date.shape != phenx.shape or new_phenx.dim() != 2 \
            or new_date.shape != new_phenx.shape \
            or new_phenx.shape[0] != phenx.shape[0] \
            or n_old.shape != phenx.shape[:1] or n_new.shape != phenx.shape[:1]:
        raise ValueError(
            f"shapes phenx {tuple(phenx.shape)}, date {tuple(date.shape)}, "
            f"n_old {tuple(n_old.shape)}, n_new {tuple(n_new.shape)}, new_phenx "
            f"{tuple(new_phenx.shape)}, new_date {tuple(new_date.shape)}")
    if any(a.device != phenx.device for a in (date, n_old, n_new, new_phenx, new_date)):
        raise ValueError("every input of delta_pairgen must lie on one device")
    P, E = phenx.shape
    D = new_phenx.shape[1]
    if E * D >= 2**31:
        raise ValueError(f"E={E} x D={D} exceed the kernel's int32 plane index")
    if fuse_duration and bucket_days < 1:
        raise ValueError(f"bucket_days must be >= 1, got {bucket_days}")
    dev = phenx.device
    seq = torch.empty((P, E, D), dtype=torch.int64, device=dev)
    dur = torch.empty((P, E, D), dtype=torch.int32, device=dev)
    mask = torch.empty((P, E, D), dtype=torch.bool, device=dev)
    if P == 0 or E == 0 or D == 0:
        # zero-width slab: every plane is empty, nothing to launch
        return Mined(seq, dur, mask)
    _launch((phenx, date, n_old, n_new, new_phenx, new_date), (seq, dur, mask),
            CODECS.index(codec), int(fuse_duration), int(bucket_days))
    delta_pairgen.launches += 1
    return Mined(seq, dur, mask)


def _launch(inputs, outputs, codec: int, fuse: int, bucket_days: int) -> None:
    """Launch the kernel on checked, contiguous CUDA ``inputs`` (phenx,
    date, n_old, n_new, new_phenx, new_date) into allocated ``outputs``
    (seq, dur, mask).  ``delta_pairgen`` checks and allocates; the smoke
    script times this alone, where the wrapper's own host work per call
    would be as long as the kernel."""
    P, E, D = outputs[0].shape
    dev = outputs[0].device
    with torch.cuda.device(dev):
        rc = _kernel()(*(a.data_ptr() for a in (*inputs, *outputs)), P, E, D,
                       codec, fuse, bucket_days,
                       torch.cuda.current_stream(dev).cuda_stream)
    _build.check(_NAME, rc)


delta_pairgen.launches = 0
