"""Wrapper of the flash-attention kernels: ``q [B, Hq, Sq, D]``,
``k/v [B, Hkv, Skv, D]`` -> ``o [B, Hq, Sq, D]``.

For a CUDA tensor it launches one of the two routes of
``csrc/flash_attention.cu`` (causal mask, sliding window, tanh softcap, GQA
by head group, any Sq and Skv), chosen by ``route(dtype, D)`` alone:
``"wgmma"`` for bfloat16 at D in ``WGMMA_HEAD_DIMS`` (tensor cores fed by
TMA, warp-specialized), ``"ffma"`` for float32 at every D in ``HEAD_DIMS``
and bfloat16 at D 16 and 32.  For a CPU tensor it takes the plain version
(``ref.attention_ref``).  Any other device raises, and so does anything the
kernels do not take: there is no fallback, from one route to the other
either.  ``attention.launches`` counts kernel launches and
``attention.route_launches`` counts them by route.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

_NAME = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)
ROUTES = ("ffma", "wgmma")
TILE_ROWS = {"ffma": 64, "wgmma": 128}        # query rows of a block
DTYPES = (torch.float32, torch.bfloat16)      # the ffma entry's dtype codes 0, 1
_INT32_MAX = 2**31 - 1


def route(dtype: torch.dtype, D: int) -> str:
    """The kernel that computes attention for ``dtype`` at head width ``D``:
    ``"wgmma"`` for bfloat16 at D in ``WGMMA_HEAD_DIMS``, else ``"ffma"``."""
    return "wgmma" if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS else "ffma"


_SHAPE_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6   # q, k, v, o, B..D
_MASK_ARGS = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_float]                                # scale .. softcap


@functools.cache
def _kernel(r: str):
    """The C entry of route ``r``."""
    lib = _build.load(_NAME)
    if r == "wgmma":
        fn = lib.flash_attention_wgmma
        fn.argtypes = _SHAPE_ARGS + _MASK_ARGS + [ctypes.c_int, ctypes.c_void_p]
    else:
        fn = lib.flash_attention
        fn.argtypes = _SHAPE_ARGS + [ctypes.c_int] + _MASK_ARGS + [ctypes.c_void_p]
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
    Hq, Hkv, Skv = q.shape[1], k.shape[1], k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if Skv == 0:
        raise ValueError("attention over zero keys (Skv == 0)")
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on CUDA or CPU tensors, not {q.device}")
    r = kernel_route(q, k, v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    q, k, v = (_aligned(t) for t in (q, k, v))
    _launch(q, k, v, out, causal=causal, window=window, softcap=softcap)
    attention.launches += 1
    attention.route_launches[r] += 1
    return out


def kernel_route(q, k, v) -> str:
    """The route that takes ``q, k, v`` (shapes already checked); raises
    for devices, dtypes, head widths and grids the kernels do not take.
    It reads shapes, dtypes and devices only."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel "
                         f"takes one of {DTYPES} for all three")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    r = route(q.dtype, D)
    if max(B * Hq, B * Hkv, Sq, Skv) > _INT32_MAX \
            or B * Hq * -(-Sq // TILE_ROWS[r]) > _INT32_MAX:
        raise ValueError(f"shape q {tuple(q.shape)} k {tuple(k.shape)} exceeds "
                         f"the {r} kernel's int32 grid")
    return r


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, starting on a 16-byte boundary (the ffma route loads
    32-bit words, the wgmma route's TMA maps need 16 bytes; a view may
    start at an odd bfloat16 element)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, out, *, causal, window, softcap, p_terms: int = 2) -> None:
    """Launch the route's kernel on checked, contiguous CUDA tensors into
    ``out``.  ``attention`` checks and allocates; the smoke script times
    this alone.  ``p_terms=1`` (wgmma route only) adds P to O as one
    bfloat16 term instead of hi + lo: card_probe.py measures it, nothing
    serves with it."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    w = 0 if window is None else max(min(int(window), _INT32_MAX), -_INT32_MAX)
    mask = [D ** -0.5, int(bool(causal)), int(window is not None), w,
            int(softcap is not None), 0.0 if softcap is None else float(softcap)]
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv, Sq, Skv, D]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route(q.dtype, D) == "wgmma":
            rc = _kernel("wgmma")(*ptrs, *mask, p_terms, stream)
        else:
            rc = _kernel("ffma")(*ptrs, DTYPES.index(q.dtype), *mask, stream)
    _build.check(_NAME, rc)


attention.launches = 0
attention.route_launches = dict.fromkeys(ROUTES, 0)
