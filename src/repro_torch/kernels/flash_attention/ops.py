"""Wrapper of the flash-attention kernels: ``q [B, Hq, Sq, D]``,
``k/v [B, Hkv, Skv, D]`` -> ``o [B, Hq, Sq, D]``.

For a CUDA tensor it launches one of the three routes of
``csrc/flash_attention.cu`` (causal mask, sliding window, tanh softcap, GQA
by head group, any Sq and Skv), chosen by ``route(dtype, D)`` alone:
``"wgmma"`` for bfloat16 at D in ``WGMMA_HEAD_DIMS`` (tensor cores fed by
TMA, warp-specialized), ``"tf32x3"`` for float32 at D in
``TF32X3_HEAD_DIMS`` (the same skeleton on TF32 tensor cores, each operand
split into TF32 hi + lo, three products; a pre-pass writes k's and v's
split operands into scratch that the wrapper allocates), ``"ffma"`` for
the rest: float32 at D 16/32/128/256 and bfloat16 at D 16 and 32.  For a CPU tensor
it takes the plain version (``ref.attention_ref``).  Any other device
raises, and so does anything the kernels do not take: there is no
fallback, from one route to another either.  ``attention.launches`` counts
calls that launch (a tf32x3 call is its pre-pass and main kernel, one
count) and ``attention.route_launches`` counts them by route.
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
# float32 at D 128 would need 256 KB of shared memory for its tiles (Q and
# a K/V stage of hi + lo at 128 KB each): it stays on ffma
TF32X3_HEAD_DIMS = (64,)
ROUTES = ("ffma", "wgmma", "tf32x3")
TILE_ROWS = {"ffma": 64, "wgmma": 128, "tf32x3": 128}   # query rows of a block
DTYPES = (torch.float32, torch.bfloat16)      # the ffma entry's dtype codes 0, 1
_INT32_MAX = 2**31 - 1


def route(dtype: torch.dtype, D: int) -> str:
    """The kernel that computes attention for ``dtype`` at head width ``D``:
    ``"wgmma"`` for bfloat16 at D in ``WGMMA_HEAD_DIMS``, ``"tf32x3"`` for
    float32 at D in ``TF32X3_HEAD_DIMS``, else ``"ffma"``."""
    if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS:
        return "wgmma"
    if dtype == torch.float32 and D in TF32X3_HEAD_DIMS:
        return "tf32x3"
    return "ffma"


_SHAPE_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6   # q, k, v, o, B..D
_MASK_ARGS = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_float]                                # scale .. softcap
# each route's C entry and its argument types (the tf32x3 entry takes the
# scratch after the shape, the ffma entry the dtype code)
ENTRIES = {
    "wgmma": ("flash_attention_wgmma", _SHAPE_ARGS + _MASK_ARGS + [ctypes.c_void_p]),
    "tf32x3": ("flash_attention_tf32x3",
               _SHAPE_ARGS + [ctypes.c_void_p] + _MASK_ARGS + [ctypes.c_void_p]),
    "ffma": ("flash_attention", _SHAPE_ARGS + [ctypes.c_int] + _MASK_ARGS + [ctypes.c_void_p]),
}


@functools.cache
def _kernel(r: str):
    """The C entry of route ``r``."""
    name, argtypes = ENTRIES[r]
    fn = getattr(_build.load(_NAME), name)
    fn.argtypes = argtypes
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
    32-bit words, the wgmma route's TMA maps and the tf32x3 pre-pass's
    16-byte loads need 16 bytes; a view may start at an odd element)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def tf32x3_scratch_elems(k_shape) -> int:
    """float32 elements of the tf32x3 route's scratch: k as TF32 hi and lo
    planes, and V transposed as hi and lo planes with its keys padded to a
    multiple of 8 (``ref.tf32x3_operands``'s two tensors)."""
    B, Hkv, Skv, D = k_shape
    return 2 * D * B * Hkv * (Skv + -(-Skv // 8) * 8)


def entry_args(q, k, v, out, *, causal, window, softcap) -> tuple[list, list]:
    """The C entries' shape arguments (pointers, B, Hq, Hkv, Sq, Skv, D) and
    mask arguments (scale, causal, use_window, window, use_softcap,
    softcap)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    w = 0 if window is None else max(min(int(window), _INT32_MAX), -_INT32_MAX)
    mask = [D ** -0.5, int(bool(causal)), int(window is not None), w,
            int(softcap is not None), 0.0 if softcap is None else float(softcap)]
    return [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv, Sq, Skv,
            D], mask


def _launch(q, k, v, out, *, causal, window, softcap, force_route: str | None = None,
            scratch=None) -> None:
    """Launch a route's kernel on checked, contiguous CUDA tensors into
    ``out``.  ``attention`` checks and allocates; the smoke script times
    this alone.  ``force_route="ffma"`` launches the ffma route where
    another takes the dtype and D (chip_smoke.py and card_probe.py time it
    beside tf32x3 at float32 D = 64; nothing serves with it).  ``scratch``
    is the tf32x3 pre-pass's output, allocated here when not given."""
    D = q.shape[3]
    r = force_route or route(q.dtype, D)
    if r != route(q.dtype, D) and not (r == "ffma" and q.dtype in DTYPES
                                         and D in HEAD_DIMS):
        raise ValueError(f"route {r!r} does not take {q.dtype} at D={D}")
    ptrs, mask = entry_args(q, k, v, out, causal=causal, window=window, softcap=softcap)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if r == "wgmma":
            rc = _kernel("wgmma")(*ptrs, *mask, stream)
        elif r == "tf32x3":
            if scratch is None:
                scratch = torch.empty(tf32x3_scratch_elems(k.shape),
                                      dtype=torch.float32, device=q.device)
            rc = _kernel("tf32x3")(*ptrs, scratch.data_ptr(), *mask, stream)
        else:
            rc = _kernel("ffma")(*ptrs, DTYPES.index(q.dtype), *mask, stream)
    _build.check(_NAME, rc)


attention.launches = 0
attention.route_launches = dict.fromkeys(ROUTES, 0)
