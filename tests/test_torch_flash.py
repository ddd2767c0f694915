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
