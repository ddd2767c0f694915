"""The port's chunked recurrence, Mamba2, mLSTM and sLSTM blocks against
the reference's.

Inputs are numpy draws from a seed given to both packages.  The twins of
tests/test_moe_ssm.py's three recurrence tests hold the port alone to the
naive float64 recurrence within that file's 1e-4 (1e-5 for the conv).
Against the reference, the scan's float32 outputs and states agree within
2e-5 (tests/test_torch_models.py's tolerance) in float32 and bfloat16
(the scan computes in float32 whatever its inputs), at a length that is a
multiple of the chunk and at an odd one (the reference's rule: one chunk
of S); the conv agrees byte for byte in float32 and in bfloat16 (the
products and the tap-by-tap sum round where the reference's do), its
decode step in bfloat16 (within 2e-5 in float32); the blocks alone, on
the reference's own init carried with ``models.convert``, within 2e-5 in
float32.  Where a chunk's decay overflows ``exp`` the reference's
gradient is NaN and the port's finite (it masks the exponent first).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import mamba2 as j_mamba2
from repro.models import model as j_model
from repro.models import ssm_common as j_ssm
from repro.models import xlstm as j_xlstm
from repro_torch.configs import get_config
from repro_torch.models import convert, mamba2, ssm_common, xlstm

TOL = 2e-5
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _f32(x) -> np.ndarray:
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol, err_msg=what)


def _same_bytes(got, want, what=""):
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape and g.tobytes() == w.tobytes(), \
        f"{what}: max |diff| {np.abs(g - w).max()}"


def _scan_inputs(B, S, H, dk, dv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, dk)).astype(np.float32),
            rng.standard_normal((B, S, H, dk)).astype(np.float32),
            rng.standard_normal((B, S, H, dv)).astype(np.float32),
            -np.abs(rng.standard_normal((B, S, H))).astype(np.float32))


# ---- twins of tests/test_moe_ssm.py (the port alone)

def _naive_recurrence(q, k, v, log_f):
    B, S, H, dk = q.shape
    C = np.zeros((B, H, dk, v.shape[-1]))
    n = np.zeros((B, H, dk))
    ys, qns = [], []
    for t in range(S):
        f = np.exp(np.asarray(log_f[:, t], np.float64))[..., None]
        C = C * f[..., None] + np.einsum("bhd,bhv->bhdv", k[:, t], v[:, t])
        n = n * f + np.asarray(k[:, t], np.float64)
        ys.append(np.einsum("bhd,bhdv->bhv", q[:, t], C))
        qns.append(np.einsum("bhd,bhd->bh", q[:, t], n))
    return np.stack(ys, 1), np.stack(qns, 1), C, n


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("seed", [0, 17, 499])
def test_chunked_scan_matches_naive(seed, chunk):
    q, k, v, log_f = _scan_inputs(2, 16, 2, 4, 6, seed)
    y, qn, st = ssm_common.chunked_scan(*(torch.from_numpy(a) for a in (q, k, v, log_f)),
                                        chunk=chunk, normalize=True)
    y_ref, qn_ref, C_ref, n_ref = _naive_recurrence(q, k, v, log_f)
    for got, want in ((y, y_ref), (qn, qn_ref), (st.C, C_ref), (st.n, n_ref)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_decode_steps_continue_chunked_scan():
    q, k, v, log_f = (torch.from_numpy(a) for a in _scan_inputs(1, 12, 2, 4, 4, 7))
    y_all, _, _ = ssm_common.chunked_scan(q, k, v, log_f, chunk=4)
    _, _, st = ssm_common.chunked_scan(q[:, :8], k[:, :8], v[:, :8], log_f[:, :8], chunk=4)
    for t in range(8, 12):
        y_t, _, st = ssm_common.decode_step(q[:, t], k[:, t], v[:, t], log_f[:, t], st)
        np.testing.assert_allclose(y_t.numpy(), y_all[:, t].numpy(), atol=1e-4, rtol=1e-4)


def test_causal_conv_matches_decode_chain():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 10, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    full = ssm_common.causal_conv1d(x, w, b)
    state = torch.zeros((2, 3, 6))
    for t in range(10):
        y_t, state = ssm_common.conv_decode_step(x[:, t], state, w, b)
        np.testing.assert_allclose(y_t.numpy(), full[:, t].numpy(), atol=1e-5, rtol=1e-5)


# ---- against the reference

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", [(32, 8), (20, 8), (7, 16)])
@pytest.mark.parametrize("normalize", [False, True])
def test_chunked_scan_matches_reference(dtype, S, chunk, normalize):
    """(20, 8): S is no multiple of the chunk, so both take one chunk of
    20; (7, 16): the chunk exceeds S.  Starts from a nonzero state."""
    jdt, tdt = DTYPES[dtype]
    arrays = _scan_inputs(2, S, 3, 4, 5, seed=S)
    rng = np.random.default_rng(1)
    C0 = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    n0 = rng.standard_normal((2, 3, 4)).astype(np.float32)
    j = [jnp.asarray(a, jdt) for a in arrays[:3]] + [jnp.asarray(arrays[3])]
    t = [torch.from_numpy(a).to(tdt) for a in arrays[:3]] + [torch.from_numpy(arrays[3])]
    wy, wqn, wst = j_ssm.chunked_scan(*j, chunk=chunk, normalize=normalize,
                                      state=j_ssm.ScanState(jnp.asarray(C0), jnp.asarray(n0)))
    gy, gqn, gst = ssm_common.chunked_scan(
        *t, chunk=chunk, normalize=normalize,
        state=ssm_common.ScanState(torch.from_numpy(C0), torch.from_numpy(n0)))
    assert ssm_common.chunk_len(S, chunk) == (S if S % min(chunk, S) else min(chunk, S))
    assert gy.dtype == gst.C.dtype == gst.n.dtype == torch.float32
    _close(gy, wy, what="y")
    _close(gst.C, wst.C, what="C")
    _close(gst.n, wst.n, what="n")
    if normalize:
        _close(gqn, wqn, what="qn")
    else:
        assert gqn is None and wqn is None


@pytest.mark.parametrize("normalize", [False, True])
def test_chunked_scan_gradient_where_the_decay_overflows(normalize):
    """A chunk whose cumulative log-decay passes ~88 (here -3 a step over
    64 steps, as zamba2-2.7b's full widths reach at random init): the
    port's outputs equal the reference's, and its gradients (through
    ``torch.autograd``) are finite and equal the reference's at chunk 8
    (where nothing overflows) within 1e-4, while ``jax.grad`` of the
    reference at chunk 64 is NaN: ``where(tri, exp(A_t - A_s), 0)`` takes
    inf x 0 above the diagonal, which the port avoids by masking the
    exponent first.  The reference is wrong here (ROADMAP queue 3)."""
    q, k, v, _ = _scan_inputs(1, 64, 2, 4, 3, seed=64)
    log_f = np.full((1, 64, 2), -3.0, np.float32)
    arrays = (q, k, v, log_f)

    def j_loss(chunk):
        def f(*a):
            y, qn, st = j_ssm.chunked_scan(*a, chunk=chunk, normalize=normalize)
            return y.sum() + (qn.sum() if normalize else 0.0) + st.C.sum()
        return f

    want = jax.grad(j_loss(8), argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in arrays))
    broken = jax.grad(j_loss(64), argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in arrays))
    assert any(np.isnan(np.asarray(g)).any() for g in broken)
    t = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, qn, st = ssm_common.chunked_scan(*t, chunk=64, normalize=normalize)
    wy, wqn, wst = j_ssm.chunked_scan(*(jnp.asarray(a) for a in arrays), chunk=64,
                                      normalize=normalize)
    _close(y.detach(), wy, what="y")
    _close(st.C.detach(), wst.C, what="C")
    loss = y.sum() + (qn.sum() if normalize else 0.0) + st.C.sum()
    for name, g, w in zip(("q", "k", "v", "log_f"), torch.autograd.grad(loss, t), want):
        assert torch.isfinite(g).all(), name
        _close(g, w, tol=1e-4, what=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalize", [False, True])
def test_decode_step_matches_reference(dtype, normalize):
    jdt, tdt = DTYPES[dtype]
    q, k, v, log_f = (a[:, 0] for a in _scan_inputs(2, 1, 3, 4, 5, seed=3))
    rng = np.random.default_rng(4)
    C0 = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    n0 = rng.standard_normal((2, 3, 4)).astype(np.float32)
    wy, wqn, wst = j_ssm.decode_step(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                     jnp.asarray(log_f), j_ssm.ScanState(jnp.asarray(C0),
                                                                         jnp.asarray(n0)),
                                     normalize=normalize)
    gy, gqn, gst = ssm_common.decode_step(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                          torch.from_numpy(log_f),
                                          ssm_common.ScanState(torch.from_numpy(C0),
                                                               torch.from_numpy(n0)),
                                          normalize=normalize)
    for got, want, what in ((gy, wy, "y"), (gst.C, wst.C, "C"), (gst.n, wst.n, "n")):
        _close(got, want, what=what)
    if normalize:
        _close(gqn, wqn, what="qn")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
def test_causal_conv_and_decode_step_match_reference(dtype, bias):
    """The shift-and-add conv, in the input's dtype, byte for byte against
    the reference's; the decode step's window product (summed in float32,
    rounded once) byte for byte in bfloat16 and within 2e-5 in float32,
    where the reference's dot sums its 4 taps in another order (1 ulp)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 13, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32) * 0.5
    b = rng.standard_normal(24).astype(np.float32) if bias else None
    jb = None if b is None else jnp.asarray(b, jdt)
    tb = None if b is None else torch.from_numpy(b).to(tdt)
    want = j_ssm.causal_conv1d(jnp.asarray(x, jdt), jnp.asarray(w, jdt), jb)
    got = ssm_common.causal_conv1d(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt), tb)
    assert got.dtype == tdt
    _same_bytes(got, want, "causal_conv1d")
    state = rng.standard_normal((2, 3, 24)).astype(np.float32)
    wy, wst = j_ssm.conv_decode_step(jnp.asarray(x[:, 0], jdt), jnp.asarray(state, jdt),
                                     jnp.asarray(w, jdt), jb)
    gy, gst = ssm_common.conv_decode_step(torch.from_numpy(x[:, 0]).to(tdt),
                                          torch.from_numpy(state).to(tdt),
                                          torch.from_numpy(w).to(tdt), tb)
    if dtype == "bfloat16":
        _same_bytes(gy, wy, "conv_decode_step")
    else:
        _close(gy, wy, what="conv_decode_step")
    _same_bytes(gst, wst, "conv state")


def _carried(arch, seed=0):
    """(cfg, reference params, port model) on the reference's reduced init."""
    jm = j_model.build(j_get_config(arch, reduced=True))
    params, _ = jm.init(jax.random.PRNGKey(seed))
    cfg = get_config(arch, reduced=True)
    return cfg, params, convert.from_jax_params(cfg, jax.tree.map(np.asarray, params))


def _x(cfg, S, seed=5):
    return np.random.default_rng(seed).standard_normal((2, S, cfg.d_model)).astype(np.float32)


def _states_close(got, want, what):
    for g, w in zip(jax.tree.leaves(jax.tree.map(np.asarray, tuple(got))),
                    jax.tree.leaves(tuple(want))):
        _close(g, w, what=what)


@pytest.mark.parametrize("S", [16, 12])
def test_mamba2_block_matches_reference(S):
    """Layer 0 of reduced zamba2-2.7b alone: train (no state), prefill from
    a zero state (the conv state is the last K-1 inputs before the conv),
    then 3 decode steps; S = 12 is no multiple of the chunk (8)."""
    cfg, params, port = _carried("zamba2-2.7b")
    jp = jax.tree.map(lambda a: a[0, 0], params["mamba"])
    blk = port.mamba[0]
    x = _x(cfg, S + 3)
    want, _ = j_mamba2.apply(jp, jnp.asarray(x[:, :S]), cfg)
    got, none = mamba2.apply(blk, torch.from_numpy(x[:, :S]), cfg)
    assert none is None
    _close(got, want, what="train")
    jst = j_mamba2.init_state(cfg, 2)
    tst = mamba2.init_state(cfg, 2, device="cpu")
    want, jst = j_mamba2.apply(jp, jnp.asarray(x[:, :S]), cfg, jst)
    got, tst = mamba2.apply(blk, torch.from_numpy(x[:, :S]), cfg, tst)
    _close(got, want, what="prefill")
    _close(tst[0], jst[0], what="conv state")
    _close(tst[1].C, jst[1].C, what="scan C")
    for t in range(S, S + 3):
        want, jst = j_mamba2.decode(jp, jnp.asarray(x[:, t:t + 1]), cfg, jst)
        got, tst = mamba2.decode(blk, torch.from_numpy(x[:, t:t + 1]), cfg, tst)
        _close(got, want, what=f"decode {t}")
        _close(tst[1].C, jst[1].C, what=f"scan C {t}")
        _close(tst[0], jst[0], what=f"conv state {t}")


@pytest.mark.parametrize("kind", ["m", "s"])
def test_xlstm_blocks_match_reference(kind):
    """Reduced xlstm-125m's first mLSTM (layer 0) or its sLSTM (layer 2)
    alone: train, prefill of 16 from the initial state, 3 decode steps;
    the sLSTM's stabilizer ``m`` (starting at -10) carries in the state."""
    cfg, params, port = _carried("xlstm-125m")
    i = j_xlstm.pattern_of(cfg).index(kind)
    jp = jax.tree.map(lambda a: a[0], params[f"blk{i}"])
    blk = port.blocks[i]
    assert blk.kind == kind
    j_apply, j_decode = ((j_xlstm.mlstm_apply, j_xlstm.mlstm_decode) if kind == "m"
                         else (j_xlstm.slstm_apply, j_xlstm.slstm_decode))
    t_apply, t_decode = ((xlstm.mlstm_apply, xlstm.mlstm_decode) if kind == "m"
                         else (xlstm.slstm_apply, xlstm.slstm_decode))
    x = _x(cfg, 19, seed=8)
    want, _ = j_apply(jp, jnp.asarray(x[:, :16]), cfg)
    got, _ = t_apply(blk, torch.from_numpy(x[:, :16]), cfg)
    _close(got, want, what="train")
    jst = j_xlstm.mlstm_state(cfg, 2) if kind == "m" else j_xlstm.slstm_state(cfg, 2)
    tst = (xlstm.mlstm_state if kind == "m" else xlstm.slstm_state)(cfg, 2, device="cpu")
    if kind == "s":
        assert float(tst["m"].max()) == float(tst["m"].min()) == -10.0
    want, jst = j_apply(jp, jnp.asarray(x[:, :16]), cfg, jst)
    got, tst = t_apply(blk, torch.from_numpy(x[:, :16]), cfg, tst)
    _close(got, want, what="prefill")
    _states_close(tst if kind == "m" else [tst[n] for n in "hcnm"],
                  jst if kind == "m" else [jst[n] for n in "hcnm"], "prefill state")
    for t in range(16, 19):
        want, jst = j_decode(jp, jnp.asarray(x[:, t:t + 1]), cfg, jst)
        got, tst = t_decode(blk, torch.from_numpy(x[:, t:t + 1]), cfg, tst)
        _close(got, want, what=f"decode {t}")
