"""Wrapper of the flash-attention kernels: ``q [B, Hq, Sq, D]``,
``k/v [B, Hkv, Skv, D]`` -> ``o [B, Hq, Sq, D]``.

For a CUDA tensor it launches one of the three routes of
``csrc/flash_attention.cu`` (causal mask, sliding window, tanh softcap, GQA
by head group, any Sq and Skv), chosen by ``route(dtype, D)`` alone:
``"wgmma"`` for bfloat16 at D in ``WGMMA_HEAD_DIMS`` (tensor cores fed by
TMA, warp-specialized, each consumer's softmax run while its own value
product is on the tensor cores), ``"tf32x3"`` for float32 at D in
``TF32X3_HEAD_DIMS`` (the same skeleton on TF32 tensor cores, each operand
split into TF32 hi + lo, three products; a pre-pass writes k's and v's
split operands into scratch that the wrapper allocates), ``"ffma"`` for
the rest: float32 at D 16/32/128/160/256 and bfloat16 at D 16 and 32.
D 160 (zamba2-2.7b's shared attention) loads its rows as three 64-column
boxes on the wgmma route (the source's hazard 7).  For a CPU tensor
it takes the plain version (``ref.attention_ref``).  Any other device
raises, and so does anything the kernels do not take: there is no
fallback, from one route to another either.  ``attention.launches`` counts
calls that launch (a tf32x3 call is its pre-pass and main kernel, one
count) and ``attention.route_launches`` counts them by route.

The log-sum-exp.  ``attention(..., return_lse=True)`` also returns each
row's log-sum-exp (float32 ``[B, Hq, Sq]``, natural-log units over the
scores after scale, softcap and mask, +inf for a row that sees no key):
every route writes it in its epilogue when given the pointer, and leaves
``o`` byte-identical; a call without it (serving) passes a null pointer.

Gradients.  On a CUDA tensor, with gradients enabled and q, k or v
requiring one, ``attention`` asks the forward op for the log-sum-exp, and
the op's autograd formula (``_Attention``) saves it and launches
``csrc/flash_attention_bwd.cu`` through ``attention_bwd``, which takes
that log-sum-exp and never recomputes it.  The backward's route follows
``bwd_route(dtype, D)`` alone, as the forward's: ``"wgmma"`` for bfloat16
at D in ``BWD_WGMMA_HEAD_DIMS`` (a delta pre-pass, then one launch of
tensor-core CTAs for dq, dk and dv, P and dS as bfloat16 hi + lo),
``"tf32x3"`` for float32 at D in ``BWD_TF32X3_HEAD_DIMS`` (a pre-pass that
writes delta, the log-sum-exp in log2 units and q, do, k, v and the
transposed q, do and k as TF32 hi + lo into scratch the wrapper allocates,
then the wgmma route's skeleton on TF32 tensor cores, three products each
way, P and dS as TF32 hi + lo), ``"ffma"`` for the rest (a delta
pre-pass, a dq and a dk/dv kernel on FFMA); none uses atomics.  The
backward takes D in ``BWD_HEAD_DIMS``, the forward's widths: at D 160
(zamba2-2.7b's shared attention) the wgmma route pads its rows to three
64-column boxes as the forward does (``csrc/flash_attention_bwd.cu``'s
hazard 7), and float32 runs ffma, as at D 16, 32, 128 and 256.
Without a gradient to take the path and its launches are the same, so
serving does not change.  On a CPU tensor
autograd differentiates the plain version.  ``attention_bwd.launches``
counts backward calls that launch (all their kernels, one count) and
``attention_bwd.route_launches`` the same by route.

The binding.  Both launches are ``torch.library.custom_op``s,
``repro_torch::flash_attention_fwd`` (``(o, lse)``; ``lse`` empty unless
asked for) and ``repro_torch::flash_attention_bwd`` (``(dq, dk, dv)``):
their CUDA implementation is the ``ctypes`` launch above, their CPU one
the plain version, and any other device raises.  Each registers a fake
implementation (the outputs' shapes and dtypes, after the same checks of
shapes, dtypes, head widths and grids the card makes, for any tensor not
on the CPU: a fake ``cuda`` tensor, or a meta tensor standing for one), so
a step traces on fake tensors through the card's route without allocating
(``launch/dryrun``),
and a FLOP formula for ``torch.utils.flop_counter.FlopCounterMode``: the
forward ``4 B Hq Sq Skv D`` (``analysis/costmodel``'s convention: the full
``Sq x Skv`` rectangle, masked pairs included, as
``scaled_dot_product_attention``'s formula counts), the backward ``10 B
Hq Sq Skv D`` (PyTorch's convention for the attention backward: S
recomputed, dP, dV, dQ and dK, five products).  A fake output has the real
one's size; what a launch allocates beside its outputs and frees before it
returns (``launch_scratch_bytes``) is counted apart.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

_NAME = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128, 160, 256)
WGMMA_HEAD_DIMS = (64, 128, 160, 256)
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


_SHAPE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6   # q, k, v, o, lse, B..D
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


_BWD_NAME = "flash_attention_bwd"
BWD_ROUTES = ("ffma", "wgmma", "tf32x3")      # the C info entry's route codes 0, 1, 2
# the backward's head widths: the forward's
BWD_HEAD_DIMS = HEAD_DIMS
BWD_WGMMA_HEAD_DIMS = WGMMA_HEAD_DIMS
# float32 on TF32 tensor cores: at D 64 the resident tiles (hi + lo of two
# operands) and two stages of three streamed operands fill 225 KB of the
# 227 KB a CTA has; wider rows stay on ffma
BWD_TF32X3_HEAD_DIMS = (64,)
# q, k, v, o, do, lse, dq, dk, dv, scratch, B..D; the ffma entry takes the dtype code
_BWD_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
BWD_ENTRIES = {
    "ffma": ("flash_attention_bwd", _BWD_ARGS + [ctypes.c_int] + _MASK_ARGS + [ctypes.c_void_p]),
    "wgmma": ("flash_attention_bwd_wgmma", _BWD_ARGS + _MASK_ARGS + [ctypes.c_void_p]),
    "tf32x3": ("flash_attention_bwd_tf32x3", _BWD_ARGS + _MASK_ARGS + [ctypes.c_void_p]),
}
# rows of the backward's query-major tiles and of its smallest key-major
# tile (tf32x3: its 32-row streamed tiles, which also bound the pre-pass's
# grid of 64-row tiles of q, do, k and v)
BWD_TILE_ROWS = {"ffma": (64, 32), "wgmma": (128, 128), "tf32x3": (32, 32)}
BWD_KERNELS = {"ffma": ("prepass", "dq", "dkv"), "wgmma": ("prepass", "bwd_wgmma"),
               "tf32x3": ("tf32x3_bwd_split", "bwd_tf32x3")}
BWD_LSE_ROWS = ref.LSE_ROWS    # the tensor-core routes pad their lse and delta rows to this


def bwd_route(dtype: torch.dtype, D: int) -> str:
    """The kernel that computes attention's gradient for ``dtype`` at head
    width ``D``: ``"wgmma"`` for bfloat16 at D in ``BWD_WGMMA_HEAD_DIMS``,
    ``"tf32x3"`` for float32 at D in ``BWD_TF32X3_HEAD_DIMS``, else
    ``"ffma"``; raises for a dtype or width no backward takes."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype}: the backward takes one of {DTYPES}")
    if D not in BWD_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the backward's {BWD_HEAD_DIMS}")
    if dtype == torch.bfloat16 and D in BWD_WGMMA_HEAD_DIMS:
        return "wgmma"
    if dtype == torch.float32 and D in BWD_TF32X3_HEAD_DIMS:
        return "tf32x3"
    return "ffma"


def bwd_scratch_elems(r: str, B: int, Hq: int, Sq: int, Hkv: int | None = None,
                      Skv: int | None = None) -> int:
    """float32 elements of the backward's scratch on route ``r``: delta
    (``ffma``); the log-sum-exp in log2 units and delta with each row
    padded to a multiple of ``BWD_LSE_ROWS`` (``wgmma``); those and the
    TF32 hi + lo operands (``tf32x3``, ``ref.tf32x3_bwd_operands``' parts,
    which need k's ``Hkv`` and ``Skv`` too)."""
    if r == "ffma":
        return B * Hq * Sq
    lse_delta = 2 * B * Hq * -(-Sq // BWD_LSE_ROWS) * BWD_LSE_ROWS
    if r == "wgmma":
        return lse_delta
    if Hkv is None or Skv is None:
        raise ValueError("the tf32x3 backward's scratch needs k's Hkv and Skv")
    D = BWD_TF32X3_HEAD_DIMS[0]
    sq8, skv8 = -(-Sq // 8) * 8, -(-Skv // 8) * 8
    return lse_delta + 4 * B * Hq * D * (Sq + sq8) + 2 * B * Hkv * D * (2 * Skv + skv8)


@functools.cache
def _bwd_kernel(r: str):
    """The C entry of the backward's route ``r``."""
    name, argtypes = BWD_ENTRIES[r]
    fn = getattr(_build.load(_BWD_NAME), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def bwd_kernel_info(dtype: torch.dtype, D: int, r: str | None = None) -> dict:
    """Registers a thread, local (spill) bytes, dynamic shared memory and
    key rows of a tile of each kernel of the backward's route ``r``
    (default ``bwd_route(dtype, D)``) at ``(dtype, D)`` (``BWD_KERNELS``),
    as the card's runtime reports them (``cudaFuncGetAttributes``)."""
    fn = _build.load(_BWD_NAME).flash_attention_bwd_info
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    r = r or bwd_route(dtype, D)
    out = {}
    for which, name in enumerate(BWD_KERNELS[r]):
        vals = (ctypes.c_int * 4)()
        _build.check(_BWD_NAME, fn(BWD_ROUTES.index(r), DTYPES.index(dtype), D, which,
                                   ctypes.addressof(vals)))
        out[name] = dict(zip(("registers", "local_bytes", "shared_bytes", "key_rows"), vals))
    return out


def kernel_info(dtype: torch.dtype, D: int, r: str | None = None) -> dict:
    """Registers a thread, local (spill) bytes, dynamic shared memory and key
    rows of a tile of the forward's kernel on route ``r`` (default
    ``route(dtype, D)``; the C entry's route codes are ``ROUTES``'
    indices) at ``(dtype, D)``, as the card's runtime reports them
    (``cudaFuncGetAttributes``)."""
    fn = _build.load(_NAME).flash_attention_info
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    vals = (ctypes.c_int * 4)()
    _build.check(_NAME, fn(ROUTES.index(r or route(dtype, D)), DTYPES.index(dtype), D,
                           ctypes.addressof(vals)))
    return dict(zip(("registers", "local_bytes", "shared_bytes", "key_rows"), vals))


@functools.cache
def _kernel(r: str):
    """The C entry of route ``r``."""
    name, argtypes = ENTRIES[r]
    fn = getattr(_build.load(_NAME), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              softcap: float | None = None, return_lse: bool = False):
    """Blocked attention with scale ``D ** -0.5``; the result is
    ``ref.attention_ref``'s (with ``return_lse``, ``(o, lse)``, which takes
    no gradient).  A CPU tensor takes the plain version directly (autograd
    differentiates it), a CUDA one the forward op."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu" and not _is_dtensor(q):
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, return_lse=return_lse)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention runs on CUDA or CPU tensors, not {q.device}")
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if grad and return_lse:
        raise ValueError("return_lse takes no gradient: call attention without it "
                         "under autograd")
    o, lse = flash_attention_fwd(q, k, v, causal, window, softcap, grad or return_lse)
    return (o, lse) if return_lse else o


def _no_lse(q) -> torch.Tensor:
    """The forward op's ``lse`` when none was asked for."""
    return torch.empty(0, dtype=torch.float32, device=q.device)


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                        window: Optional[int], softcap: Optional[float],
                        with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward op: ``(o, lse)``, ``lse`` empty unless ``with_lse``.  CUDA
    tensors launch the kernel (``_forward``), CPU tensors take the plain
    version; the caller has checked the shapes (``attention``)."""
    if q.device.type == "cpu":
        if with_lse:
            return ref.attention_ref(q, k, v, causal=causal, window=window,
                                     softcap=softcap, return_lse=True)
        o = ref.attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
        return o, _no_lse(q)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on CUDA or CPU tensors, not {q.device}")
    return _forward(q, k, v, causal=causal, window=window, softcap=softcap,
                    with_lse=with_lse)


@flash_attention_fwd.register_fake
def _(q, k, v, causal, window, softcap, with_lse):
    _check_shapes(q, k, v)
    if q.device.type != "cpu":      # the card's limits (a meta tensor stands for one)
        kernel_route(q, k, v)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if with_lse else _no_lse(q))
    return torch.empty_like(q, memory_format=torch.contiguous_format), lse


def _forward(q, k, v, *, causal, window, softcap, with_lse=False):
    """The forward launch on checked CUDA tensors, counted: ``(o, lse)``."""
    r = kernel_route(q, k, v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if with_lse else _no_lse(q))
    if out.numel():
        q, k, v = (_aligned(t) for t in (q, k, v))
        _launch(q, k, v, out, causal=causal, window=window, softcap=softcap,
                lse=lse if with_lse else None)
        attention.launches += 1
        attention.route_launches[r] += 1
    return out, lse


class _Attention:
    """The forward op's autograd formula: the forward saves its inputs, its
    output and its log-sum-exp (asked for under autograd), and the
    backward is ``attention_bwd`` on them."""

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, softcap, _ = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = dict(causal=causal, window=window, softcap=softcap)

    @staticmethod
    def backward(ctx, do, dlse=None):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, o, do.contiguous(), lse, **ctx.mask)
        return dq, dk, dv, None, None, None, None


flash_attention_fwd.register_autograd(_Attention.backward,
                                      setup_context=_Attention.setup_context)


def attention_bwd(q, k, v, o, do, lse, *, causal: bool = True, window: int | None = None,
                  softcap: float | None = None):
    """``(dq, dk, dv)`` of ``attention`` at ``q, k, v`` for its output ``o``,
    its log-sum-exp ``lse`` (``attention(..., return_lse=True)``; float32
    ``[B, Hq, Sq]``) and the output's gradient ``do`` (``[B, Hq, Sq, D]``):
    for CUDA tensors ``csrc/flash_attention_bwd.cu`` on the route
    ``bwd_route`` names, for CPU tensors ``ref.attention_bwd_ref``; any
    other device, and anything the kernels do not take, raises."""
    _check_shapes(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must have q's "
                         f"shape {tuple(q.shape)}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 of shape {tuple(q.shape[:3])}, not "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention_bwd runs on CUDA or CPU tensors, not {q.device}")
    return tuple(flash_attention_bwd(q, k, v, o, do, lse, causal, window, softcap))


def _check_bwd(q, k, v, o, do, lse) -> str:
    """The backward's route for checked CUDA tensors; raises for what its
    kernels do not take.  It reads shapes, dtypes and devices only."""
    kernel_route(q, k, v)
    B, Hq, Sq, D = q.shape
    r = bwd_route(q.dtype, D)
    if any(t.device != q.device or t.dtype != q.dtype for t in (o, do)) \
            or lse.device != q.device:
        raise ValueError("o and do must have q's device and dtype, lse its device")
    Hkv, Skv = k.shape[1], k.shape[2]
    rows_q, rows_k = BWD_TILE_ROWS[r]
    blocks = B * Hq * -(-Sq // rows_q) + 2 * B * Hkv * -(-Skv // rows_k)
    if blocks > _INT32_MAX:
        raise ValueError(f"shape q {tuple(q.shape)} k {tuple(k.shape)} exceeds the "
                         f"backward kernel's int32 grid")
    return r


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, causal: bool,
                        window: Optional[int], softcap: Optional[float],
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward op: ``(dq, dk, dv)``.  CUDA tensors launch the kernels
    (``_backward``, which checks what they take), CPU tensors take the
    plain version; the caller has checked the shapes (``attention_bwd``)."""
    if q.device.type == "cpu":
        return ref.attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=window,
                                     softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd runs on CUDA or CPU tensors, not {q.device}")
    return _backward(q, k, v, o, do, lse, causal=causal, window=window, softcap=softcap)


@flash_attention_bwd.register_fake
def _(q, k, v, o, do, lse, causal, window, softcap):
    if q.device.type != "cpu":
        _check_bwd(q, k, v, o, do, lse)
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in (q, k, v))


def _backward(q, k, v, o, do, lse, *, causal, window, softcap, force_route: str | None = None,
              scratch=None):
    """The backward launch on checked CUDA tensors, counted.
    ``force_route="ffma"`` launches the ffma route where another takes the
    dtype and D (chip_smoke.py and card_probe.py time it beside tf32x3 at
    float32 D = 64; nothing trains with it).  ``scratch`` is the route's
    float32 scratch (``bwd_scratch_elems``; the smoke reads the tf32x3
    pre-pass's output there), allocated here when not given."""
    r = _check_bwd(q, k, v, o, do, lse)
    B, Hq, Sq, D = q.shape
    if force_route is not None and force_route != r:
        if force_route != "ffma" or not (q.dtype == torch.float32 or D in (16, 32)):
            raise ValueError(f"backward route {force_route!r} does not take {q.dtype} at D={D}")
        r = force_route
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if dq.numel() == 0:         # no query: no key gets a gradient
        return dq, torch.zeros_like(k), torch.zeros_like(v)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    q, k, v, o, do, lse = (_aligned(t) for t in (q, k, v, o, do, lse))
    n = bwd_scratch_elems(r, B, Hq, Sq, k.shape[1], k.shape[2])
    if scratch is None:
        scratch = torch.empty(n, dtype=torch.float32, device=q.device)
    elif scratch.dtype != torch.float32 or scratch.numel() < n or scratch.device != q.device:
        raise ValueError(f"scratch must be float32 on {q.device} with {n} elements")
    ptrs, mask = entry_args(q, k, v, o, causal=causal, window=window, softcap=softcap)
    args = [*ptrs[:4], do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), scratch.data_ptr(), *ptrs[5:]]
    if r == "ffma":
        args.append(DTYPES.index(q.dtype))
    with torch.cuda.device(q.device):
        rc = _bwd_kernel(r)(*args, *mask, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_BWD_NAME, rc)
    attention_bwd.launches += 1
    attention_bwd.route_launches[r] += 1
    return dq, dk, dv


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected [B,Hq,Sq,D] and [B,Hkv,Skv,D]")
    Hq, Hkv, Skv = q.shape[1], k.shape[1], k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if Skv == 0:
        raise ValueError("attention over zero keys (Skv == 0)")


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


def entry_args(q, k, v, out, *, causal, window, softcap, lse=None) -> tuple[list, list]:
    """The C entries' shape arguments (pointers of q, k, v, out and ``lse``
    (null without one), B, Hq, Hkv, Sq, Skv, D) and mask arguments (scale,
    causal, use_window, window, use_softcap, softcap)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    w = 0 if window is None else max(min(int(window), _INT32_MAX), -_INT32_MAX)
    mask = [D ** -0.5, int(bool(causal)), int(window is not None), w,
            int(softcap is not None), 0.0 if softcap is None else float(softcap)]
    return [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Hq, Hkv, Sq, Skv, D], mask


def _launch(q, k, v, out, *, causal, window, softcap, force_route: str | None = None,
            scratch=None, lse=None) -> None:
    """Launch a route's kernel on checked, contiguous CUDA tensors into
    ``out`` (and, given float32 ``lse [B, Hq, Sq]``, each row's log-sum-exp
    into it).  ``attention`` checks and allocates; the smoke script times
    this alone.  ``force_route="ffma"`` launches the ffma route where
    another takes the dtype and D (chip_smoke.py and card_probe.py time it
    beside tf32x3 at float32 D = 64; nothing serves with it).  ``scratch``
    is the tf32x3 pre-pass's output, allocated here when not given."""
    D = q.shape[3]
    r = force_route or route(q.dtype, D)
    if r != route(q.dtype, D) and not (r == "ffma" and q.dtype in DTYPES
                                         and D in HEAD_DIMS):
        raise ValueError(f"route {r!r} does not take {q.dtype} at D={D}")
    ptrs, mask = entry_args(q, k, v, out, causal=causal, window=window, softcap=softcap,
                            lse=lse)
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


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _fwd_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    B, Hq, Sq, D = q_shape
    return 4 * B * Hq * Sq * k_shape[2] * D


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    B, Hq, Sq, D = q_shape
    return 10 * B * Hq * Sq * k_shape[2] * D


def _copies_bytes(*tensors) -> int:
    """Bytes of the contiguous copies ``_aligned`` makes of ``tensors``."""
    return sum(t.numel() * t.element_size() for t in tensors if not t.is_contiguous())


def launch_scratch_bytes(func, args) -> int:
    """Device bytes a launch of the op ``func`` (the forward's or the
    backward's ``.default``) on ``args`` allocates beside its outputs and
    frees before it returns: contiguous copies of the inputs that are not
    contiguous, and the tf32x3 route's (``tf32x3_scratch_elems``) or the
    backward's (``bwd_scratch_elems``) float32 scratch.  0 on the CPU and
    for any other op; a meta tensor stands for the card's, as in the fake
    implementations."""
    if func not in (torch.ops.repro_torch.flash_attention_fwd.default,
                    torch.ops.repro_torch.flash_attention_bwd.default):
        return 0
    q, k = args[0], args[1]
    if q.device.type == "cpu" or q.numel() == 0:
        return 0
    if func is torch.ops.repro_torch.flash_attention_fwd.default:
        tf32x3 = route(q.dtype, q.shape[3]) == "tf32x3"
        return _copies_bytes(*args[:3]) + (4 * tf32x3_scratch_elems(k.shape) if tf32x3 else 0)
    B, Hq, Sq, D = q.shape
    return _copies_bytes(*args[:6]) + 4 * bwd_scratch_elems(bwd_route(q.dtype, D), B, Hq, Sq,
                                                            k.shape[1], k.shape[2])


def _is_dtensor(t) -> bool:
    return torch.distributed.is_available() and isinstance(
        t, torch.distributed.tensor.DTensor)


def _sharding_rules():
    """DTensor sharding rules of both ops, one mesh dimension at a time:
    q, k and v sharded on the batch, or on the heads, give that placement
    to every output (``o``, ``lse`` (replicated when empty), ``dq``,
    ``dk``, ``dv``); heads shard only where ``Hq`` and ``Hkv`` both divide
    every mesh dimension, so a rank's GQA groups stay whole.  Any other
    layout is replicated, and DTensor gathers its inputs first."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    def dims(q, k):
        sizes = q.mesh.shape
        heads = all(q.shape[1] % n == 0 and k.shape[1] % n == 0 for n in sizes)
        return (0, 1) if heads else (0,)

    @register_sharding(torch.ops.repro_torch.flash_attention_fwd.default)
    def _(q, k, v, causal, window, softcap, with_lse):
        out = [([Replicate(), Replicate()], [Replicate()] * 3 + [None] * 4)]
        for d in dims(q, k):
            lse = Shard(d) if with_lse else Replicate()
            out.append(([Shard(d), lse], [Shard(d)] * 3 + [None] * 4))
        return out

    @register_sharding(torch.ops.repro_torch.flash_attention_bwd.default)
    def _(q, k, v, o, do, lse, causal, window, softcap):
        out = [([Replicate()] * 3, [Replicate()] * 6 + [None] * 3)]
        for d in dims(q, k):
            out.append(([Shard(d)] * 3, [Shard(d)] * 6 + [None] * 3))
        return out


if torch.distributed.is_available():
    _sharding_rules()

attention.launches = 0
attention.route_launches = dict.fromkeys(ROUTES, 0)
attention_bwd.launches = 0
attention_bwd.route_launches = dict.fromkeys(BWD_ROUTES, 0)
