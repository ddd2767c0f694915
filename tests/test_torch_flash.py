"""The flash-attention wrapper's plain version in the port against the reference.

Twin of tests/test_kernels_flash.py: at each of its cases the reference
runs its Pallas kernel ``flash_attention(..., interpret=True)`` and its
oracle ``ref.attention_ref``; the port runs ``ops.attention`` on CPU
tensors (its plain version).  Tolerances are that file's: 2e-5 for
float32, 2e-2 for bfloat16.  Ragged lengths, which the reference's kernel
refuses, are held against the reference's ``models.attention.blocked_sdpa``
(the path its models take off the TPU).  The CUDA kernels themselves are
held against the same plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 3); here the choice of kernel (``ops.route``), the
checks before a launch (``ops.kernel_route``), the wgmma route's
rounding of P and the tf32x3 route's 3xTF32 products (both emulated in
plain torch), and the tf32x3 pre-pass's plain version and key order are
held.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash as j_flash
from repro.kernels.flash_attention import ref as j_ref
from repro.models import attention as j_attention
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import attention

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(B, Hq, Hkv, Sq, Skv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D)), rng.standard_normal((B, Hkv, Skv, D)),
            rng.standard_normal((B, Hkv, Skv, D)))


def _f32(x) -> np.ndarray:
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _run(B, Hq, Hkv, Sq, Skv, D, dtype="float32", **kw):
    """(port, reference kernel, reference oracle) as float32 numpy."""
    jdt, tdt, _ = DTYPES[dtype]
    arrays = _inputs(B, Hq, Hkv, Sq, Skv, D)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrays)
    got = ops.attention(tq, tk, tv, **kw)
    assert got.dtype == tdt and got.shape == (B, Hq, Sq, D)
    kern = j_flash.flash_attention(jq, jk, jv, interpret=True, bq=min(128, Sq),
                                   bk=min(128, Skv), **kw)
    return _f32(got), _f32(kern), _f32(j_ref.attention_ref(jq, jk, jv, **kw))


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (1, 2, 2, 128, 64), (2, 4, 2, 256, 64), (1, 8, 1, 128, 128),
    (1, 2, 2, 384, 32),
])
def test_flash_causal(B, Hq, Hkv, S, D):
    got, kern, want = _run(B, Hq, Hkv, S, S, D, causal=True)
    _close(got, kern, 2e-5)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_dtypes(dtype):
    got, kern, want = _run(1, 4, 2, 256, 256, 64, dtype=dtype, causal=True)
    tol = DTYPES[dtype][2]
    _close(got, kern, tol)
    _close(got, want, tol)


def test_flash_sliding_window():
    got, kern, want = _run(1, 2, 2, 384, 384, 64, causal=True, window=128)
    _close(got, kern, 2e-5)
    _close(got, want, 2e-5)


def test_flash_softcap():
    got, kern, want = _run(1, 2, 2, 256, 256, 64, causal=True, softcap=50.0)
    _close(got, kern, 2e-5)
    _close(got, want, 2e-5)


def test_flash_non_causal_cross():
    got, kern, want = _run(1, 2, 2, 128, 256, 64, causal=False)
    _close(got, kern, 2e-5)
    _close(got, want, 2e-5)


def test_flash_gqa_groups_match_ref():
    got, kern, want = _run(2, 8, 2, 128, 128, 64, causal=True)
    _close(got, kern, 2e-5)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("Sq,Skv,kw", [
    (200, 200, dict(causal=True)),
    (200, 200, dict(causal=True, window=24, softcap=50.0)),
    (1, 1, dict(causal=True)),
    (129, 129, dict(causal=True, window=1)),
])
def test_ragged_lengths_match_blocked_sdpa(Sq, Skv, kw):
    """Lengths that are no multiple of the reference kernel's tile: the
    port's attention (layout [B,H,S,D]) and its blocked_sdpa (layout
    [B,S,H,D]) against the reference's blocked_sdpa."""
    q, k, v = _inputs(2, 6, 2, Sq, Skv, 32, seed=Sq)
    qs, ks, vs = (np.swapaxes(a, 1, 2) for a in (q, k, v))      # [B,S,H,D]
    want = _f32(j_attention.blocked_sdpa(*(jnp.asarray(a, jnp.float32)
                                           for a in (qs, ks, vs)), **kw))
    got = ops.attention(*(torch.from_numpy(a).float() for a in (q, k, v)), **kw)
    _close(np.swapaxes(_f32(got), 1, 2), want, 2e-5)
    got = attention.blocked_sdpa(*(torch.from_numpy(a).float() for a in (qs, ks, vs)),
                                 q_chunk=64, **kw)
    _close(_f32(got), want, 2e-5)


def test_rows_without_a_visible_key_give_zero():
    """Non-causal with a window and Sq > Skv: rows past Skv + window see
    no key and give 0, as the reference's oracle does."""
    q, k, v = _inputs(1, 4, 2, 96, 40, 64, seed=3)
    kw = dict(causal=False, window=16)
    got = _f32(ops.attention(*(torch.from_numpy(a).float() for a in (q, k, v)), **kw))
    want = _f32(j_ref.attention_ref(*(jnp.asarray(a, jnp.float32) for a in (q, k, v)),
                                    **kw))
    _close(got, want, 2e-5)
    assert (got[:, :, 40 + 16 - 1:] == 0).all() and np.abs(got[:, :, :40]).sum() > 0


@pytest.mark.parametrize("D", [16, 256])
def test_head_dims_at_the_kernel_edges(D):
    """The narrowest and widest head dims the kernel takes (scale D ** -0.5)."""
    got, kern, want = _run(1, 4, 2, 128, 128, D, causal=True)
    _close(got, kern, 2e-5)
    _close(got, want, 2e-5)


def test_edges_and_refusals():
    q = torch.zeros(2, 4, 8, 16)
    k = torch.zeros(2, 2, 0, 16)
    with pytest.raises(ValueError, match="zero keys"):
        ops.attention(q, k, k)
    with pytest.raises(ValueError, match="multiple"):
        ops.attention(q, torch.zeros(2, 3, 8, 16), torch.zeros(2, 3, 8, 16))
    empty = ops.attention(torch.zeros(0, 4, 8, 16), torch.zeros(0, 2, 8, 16),
                          torch.zeros(0, 2, 8, 16))
    assert empty.shape == (0, 4, 8, 16)
    meta = torch.zeros(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.attention(meta, meta, meta)
    assert ops.attention.launches == 0          # no launch on the CPU


def test_impl_follows_the_device():
    x = torch.zeros(1, 2)
    assert attention.resolve_impl("auto", x) == "torch"
    assert attention.resolve_impl("flash", x) == "flash"
    with pytest.raises(ValueError, match="CPU tensors only"):
        attention.resolve_impl("torch", torch.zeros(1, 2, device="meta"))
    with pytest.raises(ValueError, match="unknown"):
        attention.resolve_impl("xla", x)


def test_plain_version_is_the_reference_oracle():
    """ref.attention_ref alone (GQA, window, softcap, bfloat16)."""
    for dtype in DTYPES:
        jdt, tdt, tol = DTYPES[dtype]
        arrays = _inputs(1, 6, 3, 72, 72, 32, seed=7)
        kw = dict(causal=True, window=20, softcap=30.0)
        got = ref.attention_ref(*(torch.from_numpy(a).to(tdt) for a in arrays), **kw)
        want = j_ref.attention_ref(*(jnp.asarray(a, jdt) for a in arrays), **kw)
        _close(_f32(got), _f32(want), tol)


def test_route_follows_dtype_and_head_dim():
    """bfloat16 at D 64/128/256 takes the wgmma kernel, float32 at D 64 the
    tf32x3 kernel; float32 at D 16/32/128/256 and bfloat16 at D 16/32 the
    ffma kernel."""
    for D in ops.HEAD_DIMS:
        assert ops.route(torch.float32, D) == ("tf32x3" if D == 64 else "ffma")
        assert ops.route(torch.bfloat16, D) == ("wgmma" if D >= 64 else "ffma")
    assert set(ops.WGMMA_HEAD_DIMS) < set(ops.HEAD_DIMS)
    assert set(ops.TF32X3_HEAD_DIMS) == {64}
    assert set(ops.TILE_ROWS) == set(ops.ROUTES) == set(ops.attention.route_launches)
    assert ops.ROUTES == ("ffma", "wgmma", "tf32x3")


def test_kernel_checks_refuse_what_no_route_takes():
    """What the CUDA wrapper refuses before a launch, read from shapes alone
    (meta tensors): head widths, dtypes, mixed devices, each route's int32
    grid (64-row tiles for ffma, 128-row tiles for wgmma and tf32x3), and a
    measurement's route override that does not take the dtype or D."""
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    x = meta(1, 2, 8, 64)
    assert ops.kernel_route(x, x, x) == "wgmma"
    y = meta(1, 2, 8, 64, dtype=torch.float32)
    assert ops.kernel_route(y, y, y) == "tf32x3"
    z = meta(1, 2, 8, 32, dtype=torch.float32)
    assert ops.kernel_route(z, z, z) == "ffma"
    for route, t in (("wgmma", y), ("tf32x3", x), ("tf32x3", z)):
        with pytest.raises(ValueError, match=f"route '{route}' does not take"):
            ops._launch(t, t, t, t, causal=True, window=None, softcap=None,
                        force_route=route)
    with pytest.raises(ValueError, match="head dim"):
        ops.kernel_route(meta(1, 2, 8, 48), meta(1, 2, 8, 48), meta(1, 2, 8, 48))
    with pytest.raises(ValueError, match="dtypes"):
        h = meta(1, 2, 8, 64, dtype=torch.float16)
        ops.kernel_route(h, h, h)
    with pytest.raises(ValueError, match="dtypes"):
        ops.kernel_route(x, y, y)
    with pytest.raises(ValueError, match="one device"):
        ops.kernel_route(x, torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16), x)
    # 2^23 heads of 2^14 rows: 2^31 ffma tiles (refused), 2^30 wgmma tiles
    kv = meta(1, 1, 8, 64)
    big = meta(1, 2**23, 2**14, 64)
    assert ops.kernel_route(big, kv, kv) == "wgmma"
    with pytest.raises(ValueError, match="ffma kernel's int32 grid"):
        f = meta(1, 1, 8, 32, dtype=torch.float32)
        ops.kernel_route(meta(1, 2**23, 2**14, 32, dtype=torch.float32), f, f)
    with pytest.raises(ValueError, match="wgmma kernel's int32 grid"):
        ops.kernel_route(meta(1, 2**24, 2**14, 64), kv, kv)
    f = meta(1, 1, 8, 64, dtype=torch.float32)
    assert ops.kernel_route(meta(1, 2**23, 2**14, 64, dtype=torch.float32), f, f) == "tf32x3"
    with pytest.raises(ValueError, match="tf32x3 kernel's int32 grid"):
        ops.kernel_route(meta(1, 2**24, 2**14, 64, dtype=torch.float32), f, f)


# phase 3b's long case (chip_smoke.py): causal, window 4,096, S = 8,192, D = 64
P_CASE = dict(B=1, Hq=2, Hkv=1, S=8192, D=64, window=4096)
BF16_LIMIT = (2e-5, 2.0 ** -6)       # chip_smoke.py's 2e-5 + 2^-6 |want|


def _emulated_wgmma(q, k, v, *, window, p_terms, rows=512):
    """The wgmma route's numerics in plain torch, causal, a block of query
    rows at a time over the keys the block can see: fp32 QK^T, fp32
    p = exp(s - row max) with the row sum l taken from it, the value
    product from p rounded to bfloat16 (``p_terms=1``) or split into
    bfloat16 hi + lo (``p_terms=2``), o = acc / l rounded to bfloat16.
    The max is the row's final one; the kernel's running max rescales the
    fp32 accumulator instead, which does not change how p rounds."""
    B, Hq, S, D = q.shape
    group = Hq // k.shape[1]
    out = torch.empty(B, Hq, S, D)
    for b in range(B):
        for h in range(Hq):
            qf, kf, vf = q[b, h].float(), k[b, h // group].float(), v[b, h // group].float()
            for i0 in range(0, S, rows):
                lo, hi = max(0, i0 - window + 1), min(S, i0 + rows)
                s = qf[i0:i0 + rows] @ kf[lo:hi].T * D ** -0.5
                qi = torch.arange(i0, min(S, i0 + rows))[:, None]
                kj = torch.arange(lo, hi)[None, :]
                visible = (qi >= kj) & (qi - kj < window)
                s = torch.where(visible, s, ref.NEG_INF)
                p = torch.where(visible, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
                p_hi = p.bfloat16().float()
                pv = p_hi if p_terms == 1 else p_hi + (p - p_hi).bfloat16().float()
                out[b, h, i0:i0 + rows] = (pv @ vf[lo:hi]) / p.sum(-1, keepdim=True)
    return out.bfloat16()


@functools.cache
def _p_case():
    """The case's bfloat16 inputs and the reference's answer: its
    blocked_sdpa on the inputs widened to float32 (an fp32 oracle that
    never holds the [S, S] scores), rounded to bfloat16 as
    attention_ref rounds."""
    c = P_CASE
    arrays = _inputs(c["B"], c["Hq"], c["Hkv"], c["S"], c["S"], c["D"], seed=11)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrays)
    qs, ks, vs = (jnp.asarray(np.swapaxes(t.float().numpy(), 1, 2)) for t in (q, k, v))
    want = j_attention.blocked_sdpa(qs, ks, vs, causal=True, window=c["window"])
    want = torch.from_numpy(np.swapaxes(np.asarray(want), 1, 2).copy()).bfloat16()
    return q, k, v, want


@pytest.mark.parametrize("p_terms", [1, 2])
def test_wgmma_p_rounding_against_the_bf16_limit(p_terms):
    """Hazard 1 of the wgmma route: p rounded to bfloat16 alone breaks the
    smoke's bfloat16 limit where p spreads over thousands of keys; split
    into bfloat16 hi + lo (what the route ships) it holds it everywhere."""
    q, k, v, want = _p_case()
    got = _emulated_wgmma(q, k, v, window=P_CASE["window"], p_terms=p_terms)
    w = want.float()
    beyond = ((got.float() - w).abs() > BF16_LIMIT[0] + BF16_LIMIT[1] * w.abs()).sum().item()
    if p_terms == 1:
        assert beyond > 1000
    else:
        assert beyond == 0
    # the split's emulation agrees with the port's plain version too
    if p_terms == 2:
        plain = ref.attention_ref(q[:, :, :1024], k[:, :, :1024], v[:, :, :1024],
                                  causal=True, window=P_CASE["window"]).float()
        err = (got[:, :, :1024].float() - plain).abs()
        assert (err <= BF16_LIMIT[0] + BF16_LIMIT[1] * plain.abs()).all()


# ---- the tf32x3 route (float32 at D 64 on TF32 tensor cores)

F32_LIMIT = (2e-5, 2e-5)             # chip_smoke.py's 2e-5 + 2e-5 |want|


def _emulated_tf32x3(q, k, v, *, causal, window=None, products=3, rows=512):
    """The tf32x3 route's numerics in plain torch, a block of query rows at
    a time over the keys the block can see: q, k and v split into TF32 hi
    + lo (round to nearest, ties away: add 0x1000 to the bits, clear the
    low 13), S = q_hi k_lo^T + q_lo k_hi^T + q_hi k_hi^T in float32 (each
    product of two TF32 values is exact in float32), p = exp(s - row max)
    with the row sum l from the float32 p, p split into hi + lo the same
    way, o = (p_hi v_lo + p_lo v_hi + p_hi v_hi) / l.  ``products=1`` keeps
    q_hi k_hi^T and p_hi v_hi alone (one TF32 product each way)."""
    B, Hq, Sq, D = q.shape
    Skv = k.shape[2]
    group = Hq // k.shape[1]

    def mm(a, b):
        (a_hi, a_lo), (b_hi, b_lo) = a, b
        return a_hi @ b_hi if products == 1 else a_hi @ b_lo + a_lo @ b_hi + a_hi @ b_hi

    out = torch.empty(B, Hq, Sq, D)
    for b in range(B):
        for h in range(Hq):
            qs = ref.tf32_split(q[b, h])
            ks = ref.tf32_split(k[b, h // group])
            vs = ref.tf32_split(v[b, h // group])
            for i0 in range(0, Sq, rows):
                i1 = min(Sq, i0 + rows)
                lo = max(0, i0 - window + 1) if window is not None else 0
                hi = min(Skv, i1) if causal else Skv
                s = mm([t[i0:i1] for t in qs], [t[lo:hi].T for t in ks]) * D ** -0.5
                qi = torch.arange(i0, i1)[:, None]
                kj = torch.arange(lo, hi)[None, :]
                visible = (qi >= kj) if causal else torch.ones_like(qi >= kj)
                if window is not None:
                    visible = visible & (qi - kj < window)
                s = torch.where(visible, s, ref.NEG_INF)
                p = torch.where(visible, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
                o = mm(ref.tf32_split(p), [t[lo:hi] for t in vs])
                out[b, h, i0:i1] = o / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out


@functools.cache
def _f32_case(name):
    """(q, k, v, reference answer, options) in float32: phase 3b's long case
    (causal, window 4,096, S = 8,192, D = 64, two heads on one kv head) or
    a ragged causal GQA case; the answer is the reference's blocked_sdpa."""
    B, Hq, Hkv, S, kw = {"window_4096": (1, 2, 1, 8192, dict(causal=True, window=4096)),
                         "ragged": (2, 4, 2, 1000, dict(causal=True))}[name]
    arrays = _inputs(B, Hq, Hkv, S, S, 64, seed=11)
    q, k, v = (torch.from_numpy(a).float() for a in arrays)
    want = j_attention.blocked_sdpa(*(jnp.asarray(np.swapaxes(a, 1, 2), jnp.float32)
                                      for a in arrays), **kw)
    want = torch.from_numpy(np.swapaxes(np.asarray(want), 1, 2).copy())
    return q, k, v, want, kw


@pytest.mark.parametrize("name,products", [("window_4096", 3), ("window_4096", 1),
                                           ("ragged", 3)])
def test_tf32x3_products_against_the_float32_limit(name, products):
    """3xTF32 (what the route ships) holds the smoke's float32 limit where p
    spreads over thousands of keys and at a ragged causal GQA case; one
    TF32 product each way (the control) breaks it."""
    q, k, v, want, kw = _f32_case(name)
    got = _emulated_tf32x3(q, k, v, products=products, **kw)
    beyond = ((got - want).abs() > F32_LIMIT[0] + F32_LIMIT[1] * want.abs()).sum().item()
    if products == 1:
        assert beyond > 1000
    else:
        assert beyond == 0


def test_value_key_order_meets_the_fragment_k_index():
    """Hazard 2 of the tf32x3 route: the transposed V's key order is a
    bijection on each group of 8 keys, and it puts at each A-fragment
    k-index the key whose score the thread holds there (accumulator column
    2t + e goes to k-index t + 4e)."""
    order = ref.value_key_order(64)
    for g in range(0, 64, 8):
        assert sorted(order[g:g + 8].tolist()) == list(range(g, g + 8))
    # the thread that holds score column 2t + e (t = lane % 4) places it at
    # the TF32 A fragment's k-index t + 4e (CUTLASS's SM90 ALayout_64x8)
    cols = torch.arange(8)
    k_index = cols // 2 + 4 * (cols % 2)
    assert sorted(k_index.tolist()) == list(range(8))
    assert torch.equal(order[k_index], cols)
    assert k_index.tolist() == [0, 4, 1, 5, 2, 6, 3, 7]


def test_tf32x3_operands_are_the_split_inputs():
    """The pre-pass's plain version: k as TF32 hi then lo planes, V
    transposed with its keys in ``value_key_order`` and zero past Skv, and
    hi + lo within 2^-22 of each input (q's split, which the main kernel
    makes in shared memory, too); its size is the scratch the wrapper
    allocates."""
    q, k, v = (torch.from_numpy(a).float() for a in _inputs(2, 6, 2, 10, 13, 64, seed=5))
    ks, vts = ref.tf32x3_operands(k, v)
    assert ks.shape == (8, 13, 64) and vts.shape == (8, 64, 16)
    assert ks.numel() + vts.numel() == ops.tf32x3_scratch_elems(k.shape)
    for x, (hi, lo) in ((q, ref.tf32_split(q)), (k.reshape(4, 13, 64), ks.split(4))):
        assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
        assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()
        assert ((hi + lo - x).abs() <= 2.0 ** -22 * x.abs()).all()
        assert ((hi - x).abs() <= 2.0 ** -11 * x.abs()).all()
    inverse = torch.argsort(ref.value_key_order(16))
    vt_hi, vt_lo = (t[:, :, inverse] for t in vts.split(4))
    assert (vt_hi[:, :, 13:] == 0).all() and (vt_lo[:, :, 13:] == 0).all()
    want_hi, want_lo = ref.tf32_split(v.reshape(4, 13, 64).transpose(1, 2))
    assert torch.equal(vt_hi[:, :, :13], want_hi) and torch.equal(vt_lo[:, :, :13], want_lo)
    ties = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12])
    assert ref.tf32_round(ties).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]


# ---- the backward's plain version (csrc/flash_attention_bwd.cu's)

BWD_CASES = [
    (2, 4, 2, 33, 33, 16, dict(causal=True)),
    (1, 6, 2, 40, 40, 32, dict(causal=True, window=7, softcap=5.0)),
    (1, 4, 4, 20, 52, 16, dict(causal=True)),              # Sq < Skv
    (1, 4, 1, 52, 20, 16, dict(causal=False)),             # Sq > Skv, GQA 4
    (1, 4, 2, 48, 20, 16, dict(causal=False, window=8)),   # rows 27.. see no key
    (1, 2, 2, 1, 1, 64, dict(causal=True)),
]


def _bwd_inputs(B, Hq, Hkv, Sq, Skv, D, seed):
    q, k, v = _inputs(B, Hq, Hkv, Sq, Skv, D, seed=seed)
    do = np.random.default_rng(seed + 1).standard_normal((B, Hq, Sq, D))
    return [a.astype(np.float32) for a in (q, k, v, do)]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,kw", BWD_CASES)
def test_bwd_ref_matches_autograd_and_jax_grad(B, Hq, Hkv, Sq, Skv, D, kw):
    """``attention_bwd_ref``'s written-out gradients against
    ``torch.autograd`` of ``attention_ref`` and against ``jax.grad`` of the
    reference's ``attention_ref``; ``ops.attention`` on CPU tensors under
    autograd gives the same (its plain version, differentiated)."""
    import jax

    q, k, v, do = _bwd_inputs(B, Hq, Hkv, Sq, Skv, D, seed=Sq + Skv)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = ref.attention_ref(tq, tk, tv, return_lse=True, **kw)
    auto = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    got = ref.attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(), o.detach(),
                                torch.from_numpy(do), lse.detach(), **kw)
    _, vjp = jax.vjp(lambda a, b, c: j_ref.attention_ref(a, b, c, **kw),
                     *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq2, tk2, tv2 = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ops.attention(tq2, tk2, tv2, **kw).backward(torch.from_numpy(do))
    for name, g, a, j, t in zip(("dq", "dk", "dv"), got, auto, jgrads, (tq2, tk2, tv2)):
        assert g.dtype == torch.float32 and g.shape == a.shape
        _close(_f32(g), _f32(a), 2e-5)
        _close(_f32(g), _f32(j), 2e-5)
        assert torch.equal(t.grad, a), name
    if kw.get("window") == 8:        # rows past Skv + window - 1 give nothing
        assert (got[0][:, :, 20 + 8 - 1:] == 0).all()


def test_bwd_ref_in_bfloat16_and_float64():
    """bfloat16 inputs give bfloat16 gradients of the float32 arithmetic
    (within 2e-2, tests/test_kernels_flash.py's bfloat16 tolerance), and
    float64 inputs are differentiated in float64."""
    q, k, v, do = _bwd_inputs(1, 4, 2, 30, 30, 32, seed=5)
    kw = dict(causal=True, softcap=20.0)
    t64 = [torch.from_numpy(a).double() for a in (q, k, v, do)]
    want = ref.attention_bwd_ref(*t64[:3], ref.attention_ref(*t64[:3], **kw).double(),
                                 t64[3], ref.attention_lse_ref(*t64[:2], **kw), **kw)
    assert all(w.dtype == torch.float64 for w in want)
    tb = [t.to(torch.bfloat16) for t in t64]
    o, lse = ref.attention_ref(*tb[:3], return_lse=True, **kw)
    got = ref.attention_bwd_ref(*tb[:3], o, tb[3], lse, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close(_f32(g), _f32(w), 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,kw", BWD_CASES[1:4])
def test_bwd_limit_holds_the_plain_version_and_catches_a_dropped_row(dtype, B, Hq, Hkv, Sq,
                                                                    Skv, D, kw):
    """``attention_bwd_limit``, the bound the card tests and chip_smoke.py
    hold the backward kernel to: the plain version in the inputs' dtype
    lies within it, and one with the first query row's output gradient
    dropped (a kernel that skips a row) does not."""
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _bwd_inputs(B, Hq, Hkv, Sq, Skv, D, seed=Sq + D))
    o, lse = ref.attention_ref(q, k, v, return_lse=True, **kw)
    want64, want32, e32, limits = ref.attention_bwd_limit(q, k, v, o, do, **kw)
    assert all(w.dtype == torch.float64 for w in want64)
    assert all(e >= 0 for e in e32)
    for g, w64, limit in zip(ref.attention_bwd_ref(q, k, v, o, do, lse, **kw), want64,
                             limits):
        assert g.dtype == dtype and ((g.double() - w64).abs() <= limit).all()
    dropped = do.clone()
    dropped[:, :, 0] = 0
    fault = ref.attention_bwd_ref(q.double(), k.double(), v.double(), o.double(),
                                  dropped.double(), lse, **kw)
    assert any(((f - w64).abs() > limit).any() for f, w64, limit in zip(fault, want64, limits))


def test_bwd_wrapper_refusals():
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="q's shape"):
        ops.attention_bwd(q, k, k, q[:, :, :4], q, lse)
    with pytest.raises(ValueError, match="multiple"):
        ops.attention_bwd(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16), q, q, lse)
    with pytest.raises(ValueError, match="lse must be float32"):
        ops.attention_bwd(q, k, k, q, q, lse[:, :, :4])
    with pytest.raises(ValueError, match="lse must be float32"):
        ops.attention_bwd(q, k, k, q, q, lse.double())
    meta = torch.zeros(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.attention_bwd(meta, meta, meta, meta, meta, torch.zeros(1, 2, 8, device="meta"))
    before = ops.attention_bwd.launches, dict(ops.attention_bwd.route_launches)
    dq, dk, dv = ops.attention_bwd(q, k, k, q, q, lse)   # the plain version: no launch
    assert (ops.attention_bwd.launches, ops.attention_bwd.route_launches) == before
    assert dq.shape == q.shape


def test_bwd_route_follows_dtype_and_head_dim():
    """``ops.bwd_route``: the backward takes the forward's head widths; the
    wgmma backward takes bfloat16 at the wgmma forward's (D 160 among
    them), tf32x3 float32 at D 64, FFMA the rest (float32 at D 16, 32, 128,
    160 and 256, bfloat16 at D 16 and 32); dtypes and widths no backward
    takes raise."""
    assert ops.BWD_ROUTES == ("ffma", "wgmma", "tf32x3")
    assert ops.BWD_TF32X3_HEAD_DIMS == (64,)
    for D in ops.BWD_HEAD_DIMS:
        assert ops.bwd_route(torch.float32, D) == ("tf32x3" if D == 64 else "ffma")
        assert ops.bwd_route(torch.bfloat16, D) == ("wgmma" if D in ops.BWD_WGMMA_HEAD_DIMS
                                                    else "ffma")
    assert ops.BWD_WGMMA_HEAD_DIMS == (64, 128, 160, 256)
    assert ops.BWD_HEAD_DIMS == ops.HEAD_DIMS
    assert ops.bwd_route(torch.bfloat16, 160) == "wgmma"
    assert ops.bwd_route(torch.float32, 160) == "ffma"
    assert set(ops.BWD_KERNELS) == set(ops.BWD_ROUTES) == set(ops.BWD_ENTRIES) \
        == set(ops.BWD_TILE_ROWS) == set(ops.attention_bwd.route_launches)
    with pytest.raises(ValueError, match="head dim"):
        ops.bwd_route(torch.bfloat16, 96)
    with pytest.raises(ValueError, match="dtype"):
        ops.bwd_route(torch.float16, 64)
    # the wgmma route's scratch: log2-unit lse and delta, rows padded to 64
    assert ops.bwd_scratch_elems("wgmma", 2, 4, 65) == 2 * 2 * 4 * 128
    assert ops.bwd_scratch_elems("ffma", 2, 4, 65) == 2 * 4 * 65
    # tf32x3's: those, q and do as rows and transposed, k as rows and
    # transposed and v as rows, each TF32 hi + lo
    assert ops.bwd_scratch_elems("tf32x3", 2, 4, 65, 2, 30) == (
        2 * 2 * 4 * 128 + 4 * 2 * 4 * 64 * (65 + 72) + 2 * 2 * 2 * 64 * (2 * 30 + 32))
    with pytest.raises(ValueError, match="Hkv and Skv"):
        ops.bwd_scratch_elems("tf32x3", 2, 4, 65)


# ---- the tf32x3 backward (float32 at D 64 on TF32 tensor cores)

# (name, B, Hq, Hkv, Sq, Skv, options): tspm-mlho's training layer, then
# float32 D 64's edges: a GQA group of 3 under a window and softcap 50,
# Sq < Skv causal, and rows that see no key (non-causal, window, Sq > Skv)
TF32X3_BWD_CASES = [
    ("tspm_mlho", 8, 12, 4, 256, 256, dict(causal=True)),
    ("gqa3_window_softcap", 1, 6, 2, 129, 129, dict(causal=True, window=50, softcap=50.0)),
    ("sq_below_skv", 1, 6, 2, 100, 200, dict(causal=True)),
    ("rows_without_keys", 1, 6, 2, 200, 63, dict(causal=False, window=20)),
]


@functools.cache
def _tf32x3_bwd_case(name):
    """float32 inputs of a ``TF32X3_BWD_CASES`` case, the forward's output
    and log-sum-exp (the plain version's), and the backward's limit."""
    _, B, Hq, Hkv, Sq, Skv, kw = next(c for c in TF32X3_BWD_CASES if c[0] == name)
    q, k, v, do = (torch.from_numpy(a)
                   for a in _bwd_inputs(B, Hq, Hkv, Sq, Skv, 64, seed=Sq + Skv))
    o, lse = ref.attention_ref(q, k, v, return_lse=True, **kw)
    return (q, k, v, o, do, lse), kw, ref.attention_bwd_limit(q, k, v, o, do, **kw)


def _emulated_tf32x3_bwd(q, k, v, o, do, lse, *, products, causal, window=None,
                         softcap=None):
    """The tf32x3 backward's numerics in plain torch: q, k, v and do split
    into TF32 hi + lo (``ref.tf32_split``), S and dP as a_hi b_lo + a_lo b_hi
    + a_hi b_hi in float32 (each product of two TF32 values exact), P =
    2^(S scale log2(e) - lse log2(e)) (the softcap's tanh between), dS = P
    (dP - delta) dcap in float32, then dQ = dS K, dK = dS^T Q and dV = P^T
    dO with dS and P split into TF32 hi + lo as well and the same three
    products.  ``products=1`` keeps a_hi b_hi alone (one TF32 product each
    way); ``products="f_hi"`` keeps all three but takes dS and P as one
    TF32 each (F unsplit)."""
    G, scale = q.shape[1] // k.shape[1], q.shape[3] ** -0.5
    kq, vq = (t.repeat_interleave(G, 1) for t in (k, v))
    qs, ks, vs, dos = (ref.tf32_split(t) for t in (q, kq, vq, do))

    def mm(eq, a, b):
        (a_hi, a_lo), (b_hi, b_lo) = a, b
        if products == 1:
            return torch.einsum(eq, a_hi, b_hi)
        return (torch.einsum(eq, a_hi, b_lo) + torch.einsum(eq, a_lo, b_hi)) \
            + torch.einsum(eq, a_hi, b_hi)

    s = mm("bhqd,bhkd->bhqk", qs, ks)
    dp = mm("bhqd,bhkd->bhqk", dos, vs)
    _, mask, _ = ref._scores(q[..., :1], k[..., :1], causal=causal, window=window)
    if softcap is None:
        u, dcap = s * (scale * ref.LOG2E), 1.0
    else:
        th = torch.tanh(s * (scale / softcap))
        u, dcap = softcap * ref.LOG2E * th, 1 - th * th
    p = torch.where(mask, torch.exp2(u - (lse * ref.LOG2E)[..., None]), 0.0)
    ds = torch.where(mask, p * (dp - (do * o).sum(-1, keepdim=True)) * dcap, 0.0)

    def operand(x):
        hi, lo = ref.tf32_split(x)
        return (hi, torch.zeros_like(lo)) if products == "f_hi" else (hi, lo)

    def per_kv_head(x):
        return x.reshape(x.shape[0], k.shape[1], G, *x.shape[2:]).sum(2)

    ds, p = operand(ds), operand(p)
    dq = mm("bhqk,bhkd->bhqd", ds, ks) * scale
    dk = per_kv_head(mm("bhqk,bhqd->bhkd", ds, qs)) * scale
    dv = per_kv_head(mm("bhqk,bhqd->bhkd", p, dos))
    return dq, dk, dv


@pytest.mark.parametrize("products", [3, 1, "f_hi"])
@pytest.mark.parametrize("name", [c[0] for c in TF32X3_BWD_CASES])
def test_tf32x3_bwd_products_against_the_float32_limit(name, products):
    """The tf32x3 backward's hazard: TF32 keeps ~11 bits of each operand.
    With q, k, v, do, P and dS split into TF32 hi + lo and three products
    each way (what the route ships) every gradient holds
    ``ref.attention_bwd_limit`` (``BWD_ERR_FACTOR`` 16 x the float32 plain
    version's error) at tspm-mlho's training layer and float32 D 64's edge
    cases, with room: at most a fifth of it.  One TF32 product each way
    breaks it by more than 10x at every case, and so does taking P and dS
    as one TF32 each (why F is split too)."""
    args, kw, (want64, _, _, limits) = _tf32x3_bwd_case(name)
    got = _emulated_tf32x3_bwd(*args, products=products, **kw)
    ratios = [((g.double() - w64).abs() / limit).max().item()
              for g, w64, limit in zip(got, want64, limits)]
    if products == 3:
        assert max(ratios) <= 0.2, ratios
    else:
        assert max(ratios) > 10, ratios
        beyond = sum(((g.double() - w64).abs() > limit).sum().item()
                     for g, w64, limit in zip(got, want64, limits))
        assert beyond > 1000, beyond


def test_tf32x3_bwd_operands_are_the_split_inputs():
    """The tf32x3 backward pre-pass's plain version
    (``ref.tf32x3_bwd_operands``): hi + lo rebuild each input within
    2^-22 |x| (hi within 2^-11, both with their low 13 bits clear); the
    transposed q, do and k are the row operands transposed, their rows in
    ``value_key_order`` (a bijection on each group of 8) and zero past S;
    lse2 is lse in log2 units and delta rowsum(do * o), +inf and 0 on the
    rows padded to 64; the parts' sizes add up to the scratch the wrapper
    allocates (``ops.bwd_scratch_elems``)."""
    B, Hq, Hkv, Sq, Skv = 2, 6, 2, 13, 21
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(B, Hq, Hkv, Sq, Skv, 64, seed=3))
    o, lse = ref.attention_ref(q, k, v, return_lse=True, causal=False, window=4)
    lse[0, 0, 0] = torch.inf                          # a row that sees no key
    parts = ref.tf32x3_bwd_operands(q, k, v, o, do, lse)
    lse2, delta, qs, dos, qt, dot, ks, vs, kt = parts
    assert sum(p.numel() for p in parts) == ops.bwd_scratch_elems("tf32x3", B, Hq, Sq, Hkv, Skv)
    assert all(p.dtype == torch.float32 for p in parts)
    assert lse2.shape == delta.shape == (B * Hq, 64)
    assert torch.equal(lse2[:, :Sq], lse.reshape(-1, Sq) * torch.tensor(ref.LOG2E))
    assert lse2[0, 0] == torch.inf and (lse2[:, Sq:] == torch.inf).all()
    want = (do.double() * o.double()).sum(-1).reshape(-1, Sq)
    assert ((delta[:, :Sq].double() - want).abs() <= 2.0 ** -23 * want.abs() + 1e-12).all()
    assert (delta[:, Sq:] == 0).all()
    order = ref.value_key_order(24)
    for g in range(0, 24, 8):
        assert sorted(order[g:g + 8].tolist()) == list(range(g, g + 8))
    for x, rows, cols, S, S8 in ((q, qs, qt, Sq, 16), (do, dos, dot, Sq, 16),
                                 (k, ks, kt, Skv, 24), (v, vs, None, Skv, 24)):
        x = x.reshape(-1, S, 64)
        assert rows.shape == (2 * x.shape[0], S, 64)
        hi, lo = rows.split(x.shape[0])
        assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
        assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()
        assert ((hi + lo - x).abs() <= 2.0 ** -22 * x.abs()).all()
        assert ((hi - x).abs() <= 2.0 ** -11 * x.abs()).all()
        if cols is None:
            continue
        assert cols.shape == (2 * x.shape[0], 64, S8)
        inverse = torch.argsort(ref.value_key_order(S8))
        t_hi, t_lo = (t[:, :, inverse] for t in cols.split(x.shape[0]))
        assert torch.equal(t_hi[:, :, :S], hi.transpose(1, 2))
        assert torch.equal(t_lo[:, :, :S], lo.transpose(1, 2))
        assert (t_hi[:, :, S:] == 0).all() and (t_lo[:, :, S:] == 0).all()


def test_tf32x3_bwd_fake_and_scratch_at_tspm_mlho():
    """What a dry run of tspm-mlho's training step reads of the tf32x3
    backward, on meta tensors standing for the card's at its training
    layer (q [8, 12, 256, 64], k/v [8, 4, 256, 64], float32): the route
    the launch takes (``_check_bwd``, which the fake implementation runs
    too), the fake outputs, the FLOP count, and ``launch_scratch_bytes``
    equal to the pre-pass's parts (``ref.tf32x3_bwd_operands`` at the
    same shapes) with a contiguous copy of a transposed input beside them;
    the fake refuses the grid the card refuses, in 32-row tiles."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config

    cfg = get_config("tspm-mlho")
    assert (cfg.dtype, cfg.hd) == ("float32", 64) and cfg.n_layers == 12
    B, Hq, Hkv, S = 8, cfg.n_heads, cfg.n_kv_heads, 256
    meta = [torch.empty(B, H, S, 64, device="meta") for H in (Hq, Hkv, Hkv, Hq, Hq)]
    q, k, v, o, do = meta
    lse = torch.empty(B, Hq, S, device="meta")
    assert ops._check_bwd(q, k, v, o, do, lse) == "tf32x3"
    with FlopCounterMode(display=False) as counter:
        dq, dk, dv = ops.flash_attention_bwd(q, k, v, o, do, lse, True, None, None)
    assert [t.shape for t in (dq, dk, dv)] == [q.shape, k.shape, v.shape]
    assert dq.device.type == "meta" and counter.get_total_flops() == 10 * B * Hq * S * S * 64
    small = [torch.zeros(B, H, S, 64) for H in (Hq, Hkv, Hkv, Hq, Hq)]
    parts = ref.tf32x3_bwd_operands(*small, torch.zeros(B, Hq, S))
    scratch = 4 * sum(p.numel() for p in parts)
    bwd = torch.ops.repro_torch.flash_attention_bwd.default
    args = (q, k, v, o, do, lse, True, None, None)
    assert ops.launch_scratch_bytes(bwd, args) == scratch
    strided = torch.empty(B, S, Hq, 64, device="meta").transpose(1, 2)
    assert ops.launch_scratch_bytes(bwd, (strided, *args[1:])) == scratch + 4 * q.numel()
    over = torch.empty(1, 2**21, 2**16, 64, device="meta")      # 2^32 tiles of 32 rows
    kv = torch.empty(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="int32 grid") as card:
        ops._check_bwd(over, kv, kv, over, over, torch.empty(over.shape[:3], device="meta"))
    with pytest.raises(ValueError) as fake:
        ops.flash_attention_bwd(over, kv, kv, over, over,
                                torch.empty(over.shape[:3], device="meta"), True, None, None)
    assert str(fake.value) == str(card.value)


# ---- the forward's log-sum-exp (written by every route when asked)

LSE_CASES = [
    (1, 4, 2, 40, 40, 16, dict(causal=True, softcap=5.0)),
    (1, 2, 1, 33, 60, 32, dict(causal=False, window=9)),
    (2, 4, 4, 48, 20, 16, dict(causal=False, window=8)),     # rows 27.. see no key
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,kw", LSE_CASES)
def test_lse_ref_against_float64_and_blocked_sdpa(B, Hq, Hkv, Sq, Skv, D, kw):
    """The plain log-sum-exp (``attention_ref(..., return_lse=True)``, what
    ``ops.attention`` returns on CPU tensors) against a float64
    ``logsumexp`` over the visible scores, +inf on a row that sees no key;
    ``o`` is the call's without it, and sum_j exp(s - lse) v reproduces the
    reference's ``blocked_sdpa`` on the same inputs."""
    arrays = _inputs(B, Hq, Hkv, Sq, Skv, D, seed=Sq)
    q, k, v = (torch.from_numpy(a).float() for a in arrays)
    o, lse = ops.attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, ops.attention(q, k, v, **kw))
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, Sq)
    s, mask, _ = ref._scores(q.double(), k.double(), ct=torch.float64, **kw)
    want = torch.logsumexp(torch.where(mask, s, -torch.inf), -1)
    seen = mask.any(-1).expand_as(want)
    assert torch.equal(torch.isinf(lse), ~seen) and (lse[~seen] > 0).all()
    np.testing.assert_allclose(lse[seen].numpy(), want[seen].numpy(), rtol=2e-6, atol=2e-6)
    assert torch.equal(ref.attention_lse_ref(q.double(), k.double(), **kw), want.where(
        seen, torch.inf))
    p = torch.where(mask, torch.exp(s - lse.double()[..., None]), 0.0)
    o_lse = torch.einsum("bhqk,bhkd->bhqd", p, v.double().repeat_interleave(Hq // Hkv, 1))
    jq, jk, jv = (jnp.asarray(np.swapaxes(a, 1, 2), jnp.float32) for a in arrays)
    blocked = np.swapaxes(np.asarray(j_attention.blocked_sdpa(jq, jk, jv, q_chunk=Sq, **kw)),
                          1, 2)
    _close(o_lse.float().numpy(), blocked, 2e-5)


# ---- the wgmma backward's roundings (bfloat16 at D 64/128/256)

BWD_LONG = dict(B=1, Hq=2, Hkv=1, S=2048, D=256,
                kw=dict(causal=True, window=4096, softcap=50.0))


@functools.cache
def _bwd_long_case():
    """gemma2-2b's training layer cut to two query heads of one kv head:
    bfloat16 inputs, the forward's output and log-sum-exp, and the
    backward's limit (``ref.attention_bwd_limit``)."""
    c = BWD_LONG
    rng = np.random.default_rng(17)
    shapes = [(c["B"], H, c["S"], c["D"]) for H in (c["Hq"], c["Hkv"], c["Hkv"], c["Hq"])]
    q, k, v, do = (torch.from_numpy(rng.standard_normal(sh)).bfloat16() for sh in shapes)
    o, lse = ref.attention_ref(q, k, v, return_lse=True, **c["kw"])
    return (q, k, v, o, do, lse), ref.attention_bwd_limit(q, k, v, o, do, **c["kw"])


def _emulated_wgmma_bwd(q, k, v, o, do, lse, *, single, causal, window, softcap):
    """The wgmma backward's numerics in plain torch: S and dP in float32
    from bfloat16 inputs (each product exact), P = exp(S - lse), dS = P (dP
    - delta) dcap in float32, then the three products with a register
    operand take it as bfloat16 hi + lo (hi = bf16(x), lo = bf16(x - hi)),
    or as one bfloat16 for the operands named in ``single`` (``"dS"``: dS
    into dQ and dS^T into dK; ``"P"``: P^T into dV); float32 sums, one
    rounding of each gradient to bfloat16."""
    G, scale = q.shape[1] // k.shape[1], q.shape[3] ** -0.5
    s, mask, dcap = ref._scores(q, k, causal=causal, window=window, softcap=softcap,
                                ct=torch.float32)
    qf, of, dof = (t.float() for t in (q, o, do))
    kq, vq = (t.float().repeat_interleave(G, 1) for t in (k, v))
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vq) - (dof * of).sum(-1, keepdim=True))
    ds = ds * dcap

    def operand(x, name):
        hi = x.bfloat16().float()
        return hi if name in single else hi + (x - hi).bfloat16().float()

    def per_kv_head(x):
        return x.reshape(x.shape[0], k.shape[1], G, *x.shape[2:]).sum(2)

    p, ds = operand(p, "P"), operand(ds, "dS")
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kq) * scale
    dk = per_kv_head(torch.einsum("bhqk,bhqd->bhkd", ds, qf)) * scale
    dv = per_kv_head(torch.einsum("bhqk,bhqd->bhkd", p, dof))
    return tuple(t.bfloat16() for t in (dq, dk, dv))


@pytest.mark.parametrize("single", ["", "dS", "P"])
def test_wgmma_bwd_rounding_against_the_bf16_limit(single):
    """The wgmma backward's hazard: P^T, dS and dS^T enter their products
    as bfloat16 register operands.  Split into bfloat16 hi + lo (what the
    route ships) every gradient holds ``ref.attention_bwd_limit`` at
    gemma2-2b's long causal, windowed, softcapped shape; one bfloat16
    rounding of dS breaks dq's and dk's limits, one of P^T dv's, each by
    more than 10x at thousands of elements."""
    args, (want64, _, _, limits) = _bwd_long_case()
    got = _emulated_wgmma_bwd(*args, single=single, **BWD_LONG["kw"])
    broken = {"": (), "dS": ("dq", "dk"), "P": ("dv",)}[single]
    for name, g, w64, limit in zip(("dq", "dk", "dv"), got, want64, limits):
        ratio = ((g.double() - w64).abs() / limit)
        if name in broken:
            assert ratio.max() > 10 and (ratio > 1).sum() > 1000, name
        else:
            assert ratio.max() <= 1, (name, ratio.max().item())


# ---- D 160: zamba2-2.7b's shared attention (32 heads x 160)

D160_CASES = [
    (1, 4, 4, 40, 40, 160, dict(causal=True)),
    (1, 8, 2, 33, 33, 160, dict(causal=True)),                    # GQA 4
    (1, 4, 1, 48, 48, 160, dict(causal=True, window=7)),
    (1, 4, 2, 40, 40, 160, dict(causal=True, softcap=30.0)),
    (2, 4, 4, 48, 20, 160, dict(causal=False, window=8)),         # rows 27.. see no key
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,kw", D160_CASES)
def test_plain_version_at_d160_matches_reference(dtype, B, Hq, Hkv, Sq, Skv, D, kw):
    """``ops.attention`` on CPU tensors at D 160 against the reference's
    ``attention_ref`` (causal, GQA, window, softcap, rows that see no key),
    the last 32 columns (the wgmma route's third, half-filled box) also on
    their own, so that a dropped box cannot pass on an average."""
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(B, Hq, Hkv, Sq, Skv, D, seed=160)
    got = _f32(ops.attention(*(torch.from_numpy(a).to(tdt) for a in arrays), **kw))
    want = _f32(j_ref.attention_ref(*(jnp.asarray(a, jdt) for a in arrays), **kw))
    assert got.shape == (B, Hq, Sq, 160)
    _close(got, want, tol)
    _close(got[..., 128:], want[..., 128:], tol)
    assert np.abs(want[..., 128:]).max() > 0.1


def test_route_at_d160():
    """D 160: bfloat16 takes wgmma (three 64-column boxes, ``TILE_ROWS``
    128), float32 ffma; ``kernel_route`` reads it from meta tensors."""
    assert 160 in ops.HEAD_DIMS and 160 in ops.WGMMA_HEAD_DIMS
    assert 160 not in ops.TF32X3_HEAD_DIMS
    assert ops.route(torch.bfloat16, 160) == "wgmma"
    assert ops.route(torch.float32, 160) == "ffma"
    for dtype, r in ((torch.bfloat16, "wgmma"), (torch.float32, "ffma")):
        q = torch.empty(2, 32, 4096, 160, dtype=dtype, device="meta")
        assert ops.kernel_route(q, q, q) == r
    with pytest.raises(ValueError, match="route 'tf32x3' does not take"):
        t = torch.empty(1, 2, 8, 160, device="meta")
        ops._launch(t, t, t, t, causal=True, window=None, softcap=None, force_route="tf32x3")


def _jax_bwd_of_blocked_sdpa(q, k, v, do, kw):
    """dq, dk, dv of the reference's ``models.attention.blocked_sdpa`` (the
    path its models train through) by ``jax.vjp``, in float32, in the
    kernel's ``[B, H, S, D]`` layout."""
    import jax

    def sdpa(a, b, c):
        o = j_attention.blocked_sdpa(*(jnp.swapaxes(t, 1, 2) for t in (a, b, c)), **kw)
        return jnp.swapaxes(o, 1, 2)

    @jax.jit
    def grads(a, b, c, g):
        return jax.vjp(sdpa, a, b, c)[1](g)

    return [np.array(g, np.float32) for g in grads(*(jnp.asarray(_f32(t)) for t in (q, k, v, do)))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,kw", D160_CASES)
def test_bwd_plain_version_at_d160_within_the_limit_of_jax_grad(dtype, B, Hq, Hkv, Sq, Skv,
                                                                 D, kw):
    """The backward at D 160 (zamba2-2.7b's shared attention), as
    ``ops.attention_bwd`` gives it on CPU tensors (``ref.attention_bwd_ref``):
    every element of dq, dk and dv within ``ref.attention_bwd_limit`` (16 x
    the float32 plain version's error + 2^-8 |want| in bfloat16, the bar
    the card's kernels are held to) of the float64 gradient, and in
    float32 so is ``jax.grad`` of the reference's ``blocked_sdpa`` on the
    same inputs (in bfloat16 the limit's delta takes the bfloat16 ``o``
    the kernel is given, which ``jax.grad`` does not see); the last 32
    columns (the wgmma route's third, half-filled box) carry
    gradient.  Causal and not, GQA 4, window, softcap, rows that see no
    key."""
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _bwd_inputs(B, Hq, Hkv, Sq, Skv, D, seed=160 + Sq))
    o, lse = ops.attention(q, k, v, return_lse=True, **kw)
    before = ops.attention_bwd.launches
    got = ops.attention_bwd(q, k, v, o, do, lse, **kw)
    assert ops.attention_bwd.launches == before
    want64, _, _, limits = ref.attention_bwd_limit(q, k, v, o, do, **kw)
    jgrads = (_jax_bwd_of_blocked_sdpa(q, k, v, do, kw) if dtype == torch.float32
              else (None,) * 3)
    for name, g, j, w64, limit in zip(("dq", "dk", "dv"), got, jgrads, want64, limits):
        assert g.dtype == dtype and g.shape[3] == 160
        assert ((g.double() - w64).abs() <= limit).all(), name
        if j is not None:
            assert ((torch.from_numpy(j).double() - w64).abs() <= limit).all(), name
        assert w64[..., 128:].abs().max() > 1e-3, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_at_d160_runs_the_plain_version_on_cpu(dtype):
    """``_Attention.backward`` (the forward op's autograd formula) takes D
    160 now: given CPU tensors (as a card's saved tensors would be, on the
    CPU) it returns the plain version's gradients, None for the op's four
    other inputs, and launches nothing."""
    import types

    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _bwd_inputs(1, 4, 2, 24, 24, 160, seed=7))
    kw = dict(causal=True, window=None, softcap=None)
    o, lse = ops.attention(q, k, v, return_lse=True, **kw)
    ctx = types.SimpleNamespace(saved_tensors=(q, k, v, o, lse), mask=kw)
    before = ops.attention_bwd.launches, dict(ops.attention_bwd.route_launches)
    got = ops._Attention.backward(ctx, do)
    assert (ops.attention_bwd.launches, ops.attention_bwd.route_launches) == before
    assert got[3:] == (None, None, None, None)
    for g, w in zip(got, ref.attention_bwd_ref(q, k, v, o, do, lse, **kw)):
        assert torch.equal(g, w)


# ---- the wgmma route's served head layouts, and the limits the card sets

# (name, B, Hq, Hkv, Sq, Skv, D, options, bq, bk): pixtral-12b's GQA 32/8 at
# D 128, zamba2-2.7b's MHA at D 160, seamless-m4t-large-v2's non-causal
# encoder (and its cross-attention, Sq != Skv) at D 64, deepseek-moe-16b's
# MHA at D 128, at lengths no multiple of 64 or 128; the reference kernel's
# tiles (bq, bk) divide them
SERVED_LAYOUTS = [
    ("gqa_32_8_d128", 1, 32, 8, 72, 72, 128, dict(causal=True), 72, 72),
    ("mha_d160", 1, 4, 4, 100, 100, 160, dict(causal=True), 50, 50),
    ("noncausal_d64", 2, 4, 4, 136, 136, 64, dict(causal=False), 68, 68),
    ("noncausal_cross_d64", 2, 4, 4, 40, 136, 64, dict(causal=False), 40, 68),
    ("mha_d128", 2, 4, 4, 200, 200, 128, dict(causal=True), 100, 40),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,B,Hq,Hkv,Sq,Skv,D,kw,bq,bk", SERVED_LAYOUTS)
def test_served_layouts_match_the_reference_kernel(name, B, Hq, Hkv, Sq, Skv, D, kw, bq, bk,
                                                   dtype):
    """The port's attention (the plain version on CPU tensors; the card's
    wgmma route is held against it in tests/test_torch_cuda.py and the
    smoke's phase 3b) at each served head layout of the wgmma route,
    against the reference's Pallas kernel in interpret mode and its oracle,
    within the file's tolerances."""
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(B, Hq, Hkv, Sq, Skv, D, seed=Sq + D)
    got = _f32(ops.attention(*(torch.from_numpy(a).to(tdt) for a in arrays), **kw))
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    kern = _f32(j_flash.flash_attention(jq, jk, jv, interpret=True, bq=bq, bk=bk, **kw))
    want = _f32(j_ref.attention_ref(jq, jk, jv, **kw))
    assert got.shape == (B, Hq, Sq, D)
    _close(got, kern, tol)
    _close(got, want, tol)


def test_fake_refuses_what_the_card_refuses():
    """The forward op's fake implementation (what a traced step runs in
    place of a launch) raises where the wrapper raises before a launch
    (``ops.kernel_route``), with the same message, on meta tensors standing
    for the card's: a head width no route takes, a dtype, and each route's
    int32 grid of query tiles (``TILE_ROWS`` rows a tile); one tile short
    of a grid's limit it gives the card's output shapes."""
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    f32, f16 = torch.float32, torch.float16
    refused = [
        (meta(1, 2, 8, 48), meta(1, 2, 8, 48)),                                 # head width
        (meta(1, 2, 8, 64, dtype=f16), meta(1, 2, 8, 64, dtype=f16)),           # dtype
        (meta(1, 2**24, 2**14, 64), meta(1, 1, 8, 64)),                         # wgmma grid
        (meta(1, 2**23, 2**14, 32, dtype=f32), meta(1, 1, 8, 32, dtype=f32)),   # ffma grid
        (meta(1, 2**24, 2**14, 64, dtype=f32), meta(1, 1, 8, 64, dtype=f32)),   # tf32x3 grid
    ]
    for q, kv in refused:
        with pytest.raises(ValueError) as card:
            ops.kernel_route(q, kv, kv)
        with pytest.raises(ValueError) as fake:
            ops.flash_attention_fwd(q, kv, kv, True, None, None, False)
        assert str(fake.value) == str(card.value)
    for q, kv in ((meta(1, 2**23, 2**14, 160), meta(1, 1, 8, 160)),
                  (meta(1, 2**22, 2**14, 32, dtype=f32), meta(1, 1, 8, 32, dtype=f32))):
        o, lse = ops.flash_attention_fwd(q, kv, kv, True, None, None, True)
        assert o.shape == q.shape and lse.shape == q.shape[:3] and o.device.type == "meta"


def test_tile_rows_are_the_kernels():
    """``ops.TILE_ROWS``, what the wrapper's and the fake's grid limits count
    in, are the source's query rows a block: ``kBQ`` of the ffma route,
    ``kWgBQ`` of the wgmma and tf32x3 CTAs."""
    import re

    from repro_torch.kernels import _build

    src = (_build.CSRC / "flash_attention.cu").read_text()
    rows = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
            for name in ("kBQ", "kWgBQ")}
    assert ops.TILE_ROWS == {"ffma": rows["kBQ"], "wgmma": rows["kWgBQ"],
                             "tf32x3": rows["kWgBQ"]}
