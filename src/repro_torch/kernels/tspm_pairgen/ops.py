"""Wrapper of the pair-generation kernel: dense [P, E, E] ``Mined``.

For a CUDA tensor it launches ``csrc/tspm_pairgen.cu``, which writes the
packed int64 ids (``SENTINEL`` on invalid pairs, the fused duration bucket
when asked), the int32 durations and the bool mask in one pass.  For a CPU
tensor it takes the plain version (``ref.pairgen_ref``).  Any other device
raises.  ``pairgen.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.encoding import CODECS, as_tensor
from repro_torch.core.mining import Mined
from repro_torch.kernels import _build
from repro_torch.kernels.tspm_pairgen import ref

_NAME = "tspm_pairgen"


def _kernel():
    fn = _build.load(_NAME).tspm_pairgen
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pairgen(phenx, date, nevents, codec: str = "bit",
            fuse_duration: bool = False, bucket_days: int = 30) -> Mined:
    """Kernel-backed mining to the dense [P, E, E] layout (== mine_dense)."""
    phenx = as_tensor(phenx, torch.int32).contiguous()
    date = as_tensor(date, torch.int32).contiguous()
    nevents = as_tensor(nevents, torch.int32).contiguous()
    if phenx.device.type == "cpu":
        return ref.pairgen_ref(phenx, date, nevents, codec, fuse_duration,
                               bucket_days)
    if phenx.device.type != "cuda":
        raise ValueError(f"pairgen runs on CUDA or CPU tensors, not {phenx.device}")
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}; expected one of {CODECS}")
    if phenx.dim() != 2 or date.shape != phenx.shape or \
            nevents.shape != phenx.shape[:1]:
        raise ValueError(f"shapes phenx {tuple(phenx.shape)}, date "
                         f"{tuple(date.shape)}, nevents {tuple(nevents.shape)}")
    if date.device != phenx.device or nevents.device != phenx.device:
        raise ValueError("phenx, date and nevents must share one device")
    P, E = phenx.shape
    if E * E >= 2**31:
        raise ValueError(f"E={E} events per patient exceed the kernel's int32 plane index")
    if fuse_duration and bucket_days < 1:
        raise ValueError(f"bucket_days must be >= 1, got {bucket_days}")
    dev = phenx.device
    seq = torch.empty((P, E, E), dtype=torch.int64, device=dev)
    dur = torch.empty((P, E, E), dtype=torch.int32, device=dev)
    mask = torch.empty((P, E, E), dtype=torch.bool, device=dev)
    if P and E:
        with torch.cuda.device(dev):
            rc = _kernel()(
                phenx.data_ptr(), date.data_ptr(), nevents.data_ptr(),
                seq.data_ptr(), dur.data_ptr(), mask.data_ptr(), P, E,
                CODECS.index(codec), int(fuse_duration), int(bucket_days),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(_NAME, rc)
        pairgen.launches += 1
    return Mined(seq, dur, mask)


pairgen.launches = 0
