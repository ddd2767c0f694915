"""Wrapper of the flash-attention kernel: ``q [B, Hq, Sq, D]``,
``k/v [B, Hkv, Skv, D]`` -> ``o [B, Hq, Sq, D]``.

For a CUDA tensor it launches ``csrc/flash_attention.cu`` (float32 or
bfloat16, D in ``HEAD_DIMS``, causal mask, sliding window, tanh softcap,
GQA by head group, any Sq and Skv); for a CPU tensor it takes the plain
version (``ref.attention_ref``).  Any other device raises, and so does
anything the kernel does not take: there is no fallback.
``attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

_NAME = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)      # the C entry's dtype codes 0, 1
_INT32_MAX = 2**31 - 1


def _kernel():
    fn = _build.load(_NAME).flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              softcap: float | None = None):
    """Blocked attention with scale ``D ** -0.5``; the result is
    ``ref.attention_ref``'s."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected [B,Hq,Sq,D] and [B,Hkv,Skv,D]")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if Skv == 0:
        raise ValueError("attention over zero keys (Skv == 0)")
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on CUDA or CPU tensors, not {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel "
                         f"takes one of {DTYPES} for all three")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if max(B * Hq, B * Hkv, Sq, Skv) > _INT32_MAX \
            or B * Hq * -(-Sq // 64) > _INT32_MAX:
        raise ValueError(f"shape q {tuple(q.shape)} k {tuple(k.shape)} exceeds "
                         "the kernel's int32 grid")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    q, k, v = (_aligned(t) for t in (q, k, v))
    _launch(q, k, v, out, causal=causal, window=window, softcap=softcap)
    attention.launches += 1
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, starting on a 16-byte boundary (the kernel loads 32-bit
    words; a view may start at an odd bfloat16 element)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, out, *, causal, window, softcap) -> None:
    """Launch the kernel on checked, contiguous CUDA tensors into ``out``.
    ``attention`` checks and allocates; the smoke script times this alone."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    w = 0 if window is None else max(min(int(window), _INT32_MAX), -_INT32_MAX)
    with torch.cuda.device(q.device):
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                       B, Hq, Hkv, Sq, Skv, D, DTYPES.index(q.dtype), D ** -0.5,
                       int(bool(causal)), int(window is not None), w,
                       int(softcap is not None),
                       0.0 if softcap is None else float(softcap),
                       torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_NAME, rc)


attention.launches = 0
