"""The port's dense decoder against the reference's, on carried-over weights.

Weights come from the reference's own init (``model.build(cfg).init``)
and cross with ``models.convert.from_jax_params``; tokens are numpy draws
from a seed.  Logits of ``transformer.apply`` in modes ``train``,
``prefill`` and ``decode`` (several steps) must agree within 2e-5, the
tolerance of tests/test_attention.py, and so must the caches' ``pos`` and
the keys and values they hold.  Reduced ``tspm-mlho`` (dense, GQA) and
reduced ``gemma2-2b`` (local/global layers with window 16, both softcaps,
post-norms, GeGLU, scaled embeddings) run on the CPU, where attention is
the plain ``blocked_sdpa``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attention
from repro.models import layers as j_layers
from repro.models import model as j_model
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import attention, convert, layers, transformer
from repro_torch.models import model as model_lib

ARCH_CASES = ["tspm-mlho", "gemma2-2b"]
TOL = 2e-5


def _f32(x) -> np.ndarray:
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol, err_msg=what)


def _pair(arch, seed=0):
    """(cfg, reference model, reference params, port model) on carried weights."""
    jcfg = j_get_config(arch, reduced=True)
    jm = j_model.build(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(seed))
    cfg = get_config(arch, reduced=True)
    port = convert.from_jax_params(cfg, jax.tree.map(np.asarray, params))
    return cfg, jm, params, port


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(4, cfg.vocab_size, (b, s)).astype(np.int32)


def test_configs_resolve_the_same_arch_names():
    from repro.configs import ARCHS as J_ARCHS

    assert ARCHS == J_ARCHS
    for arch in ARCHS:
        for reduced in (False, True):
            assert (get_config(arch, reduced).__dict__
                    == j_get_config(arch, reduced).__dict__)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCH_CASES)
def test_param_count_and_converted_values(arch):
    cfg, jm, params, port = _pair(arch)
    assert model_lib.param_count(port) == j_model.param_count(params)
    blk = params["blk1" if cfg.local_global else "blk0"]
    layer = 1 if cfg.local_global else cfg.n_layers - 1
    rep = layer // len(transformer.pattern_of(cfg))
    np.testing.assert_array_equal(
        port.blocks[layer].attn.wq.weight.numpy(),
        np.asarray(blk["attn"]["wq"]["w"][rep]).T)
    pattern = transformer.pattern_of(cfg)
    assert port.blocks[layer].kind == pattern[layer % len(pattern)]


@pytest.mark.parametrize("arch", ARCH_CASES)
@pytest.mark.parametrize("seq", [8, 40])
def test_train_logits_match_reference(arch, seq):
    """seq 40 crosses gemma2's reduced window (16) on its local layers."""
    cfg, jm, params, port = _pair(arch)
    toks = _tokens(cfg, 2, seq)
    want, aux = jm.apply(params, {"tokens": jnp.asarray(toks)}, mode="train")
    got, got_aux = transformer.apply(port, {"tokens": torch.from_numpy(toks)}, cfg,
                                     mode="train")
    assert got.shape == want.shape == (2, seq, cfg.vocab_size)
    _close(got, want)
    assert float(got_aux) == float(aux) == 0.0


def _caches_as_reference(cfg, caches):
    """The port's per-layer caches stacked into the reference's layout:
    one dict per pattern position with [n_rep, ...] arrays."""
    n = len(transformer.pattern_of(cfg))
    return [{"k": np.stack([c["k"].numpy() for c in caches[i::n]]),
             "v": np.stack([c["v"].numpy() for c in caches[i::n]]),
             "pos": np.asarray([c["pos"] for c in caches[i::n]], np.int32)}
            for i in range(n)]


def _assert_caches_match(cfg, got, want, what):
    for g, w in zip(_caches_as_reference(cfg, got), want):
        np.testing.assert_array_equal(g["pos"], np.asarray(w["pos"]), err_msg=what)
        _close(g["k"], w["k"], what=f"{what} k")
        _close(g["v"], w["v"], what=f"{what} v")


@pytest.mark.parametrize("arch", ARCH_CASES)
def test_prefill_and_decode_match_reference(arch):
    """Prefill 20 tokens, then 6 decode steps fed the reference's greedy
    tokens: logits and caches agree at every step."""
    cfg, jm, params, port = _pair(arch)
    mdl = model_lib.build(cfg)
    b, plen, max_len = 2, 20, 32
    toks = _tokens(cfg, b, plen, seed=2)
    jc = jm.init_caches(b, max_len)
    tc = mdl.init_caches(b, max_len, device="cpu")
    want, jc = jm.apply(params, {"tokens": jnp.asarray(toks)}, mode="prefill", caches=jc)
    got, tc = mdl.apply(port, {"tokens": torch.from_numpy(toks)}, mode="prefill",
                        caches=tc)
    assert got.shape == want.shape == (b, 1, cfg.vocab_size)
    _close(got, want, what="prefill logits")
    _assert_caches_match(cfg, tc, jc, "prefill")
    for step in range(6):
        nxt = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)[:, None]
        want, jc = jm.apply(params, {"tokens": jnp.asarray(nxt)}, mode="decode",
                            caches=jc)
        got, tc = mdl.apply(port, {"tokens": torch.from_numpy(nxt)}, mode="decode",
                            caches=tc)
        _close(got, want, what=f"decode step {step} logits")
        _assert_caches_match(cfg, tc, jc, f"decode step {step}")


def test_decode_equals_the_last_row_of_train():
    """The port alone: prefill + decode steps give the train-mode logits
    of the whole sequence at each position (the cache is exact)."""
    cfg = get_config("gemma2-2b", reduced=True)
    mdl = model_lib.build(cfg)
    port = mdl.init(torch.Generator("cpu").manual_seed(3))
    toks = torch.from_numpy(_tokens(cfg, 2, 26, seed=4))
    full, _ = mdl.apply(port, {"tokens": toks}, mode="train")
    caches = mdl.init_caches(2, 32, device="cpu")
    got, caches = mdl.apply(port, {"tokens": toks[:, :20]}, mode="prefill", caches=caches)
    _close(got[:, 0], full[:, 19], tol=1e-4)
    for t in range(20, 26):
        got, caches = mdl.apply(port, {"tokens": toks[:, t:t + 1]}, mode="decode",
                                caches=caches)
        _close(got[:, 0], full[:, t], tol=1e-4, what=f"position {t}")


def test_layers_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) * 53, (2, 7))
    for fraction in (1.0, 0.5):
        jc, js = j_layers.rope_angles(jnp.asarray(pos), 32, fraction)
        tc, ts = layers.rope_angles(torch.from_numpy(pos.copy()), 32, fraction)
        _close(tc, jc)
        _close(layers.apply_rope(torch.from_numpy(x), tc, ts, fraction),
               j_layers.apply_rope(jnp.asarray(x), jc, js, fraction))
    h = rng.standard_normal((3, 5, 24)).astype(np.float32)
    scale = rng.standard_normal(24).astype(np.float32)
    norm = layers.RMSNorm(24, torch.float32, "cpu")
    norm.scale.copy_(torch.from_numpy(scale))
    _close(layers.rmsnorm(norm, torch.from_numpy(h)),
           j_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(h)))
    ffn = {n: {"w": rng.standard_normal(s).astype(np.float32) * 0.2}
           for n, s in (("gate", (24, 40)), ("up", (24, 40)), ("down", (40, 24)))}
    tm = layers.MLP(24, 40, torch.float32, "cpu")
    for n in ffn:
        getattr(tm, n).weight.copy_(torch.from_numpy(ffn[n]["w"].T.copy()))
    jffn = jax.tree.map(jnp.asarray, ffn)
    for act in ("silu", "gelu"):
        _close(layers.mlp(tm, torch.from_numpy(h), act), j_layers.mlp(jffn, jnp.asarray(h), act),
               what=act)


@pytest.mark.parametrize("window,softcap", [(None, None), (5, None), (None, 30.0)])
def test_decode_attention_matches_reference(window, softcap):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    cfg = get_config("gemma2-2b", reduced=True).replace(attn_softcap=softcap)
    got = attention.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)), cfg,
                                     pos=8, window=window)
    want = j_attention.decode_attention(*(jnp.asarray(a) for a in (q, k, v)), cfg,
                                        pos=jnp.int32(8), window=window)
    _close(got, want)


def test_unported_families_and_devices_raise():
    for arch in ("deepseek-moe-16b", "xlstm-125m", "zamba2-2.7b",
                 "seamless-m4t-large-v2", "pixtral-12b", "llama4-maverick-400b-a17b"):
        with pytest.raises(NotImplementedError, match="item 17"):
            model_lib.build(get_config(arch, reduced=True))
    mdl = model_lib.build(get_config("tspm-mlho", reduced=True))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mdl.init()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mdl.init_caches(1, 8)


def test_seeded_init_scales_and_determinism():
    cfg = get_config("tspm-mlho", reduced=True)
    mdl = model_lib.build(cfg)
    a = mdl.init(torch.Generator("cpu").manual_seed(7))
    b = mdl.init(torch.Generator("cpu").manual_seed(7))
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
        assert not x.requires_grad
    w = a.blocks[0].ffn.down.weight                 # [d, d_ff]: scale d_ff^-0.5
    assert w.abs().max() <= 2 * cfg.d_ff ** -0.5 + 1e-7
    # a standard normal truncated to [-2, 2] has std 0.8796
    assert abs(float(w.std()) / cfg.d_ff ** -0.5 - 0.8796) < 0.05
    assert torch.equal(a.ln_f.scale, torch.zeros(cfg.d_model))
    assert a.head is None and abs(float(a.embed.table.std()) - 0.8796) < 0.05


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_lookup_out_of_range_ids_match_take(dtype, scale):
    """The reference's ``jnp.take``: ids in [-V, -1] wrap, ids outside
    [-V, V) give NaN rows; NaN in the same places, every other row
    byte-equal (float32 and bfloat16, with and without the sqrt(d) scale)."""
    V, d = 6, 8
    table = np.random.default_rng(9).standard_normal((V, d)).astype(np.float32)
    ids = np.array([[-V - 1, -V, -1, 0], [V - 1, V, V + 1, 2]], np.int32)
    jt = jnp.asarray(table, jnp.dtype(dtype))
    emb = layers.Embedding(V, d, layers.DTYPES[dtype], "cpu")
    emb.table.copy_(torch.from_numpy(table).to(layers.DTYPES[dtype]))
    want = np.asarray(j_layers.embed_lookup({"table": jt}, jnp.asarray(ids), scale)
                      .astype(jnp.float32))
    got = layers.embed_lookup(emb, torch.from_numpy(ids), scale)
    assert got.dtype == layers.DTYPES[dtype] and got.shape == (2, 4, d)
    got = got.float().numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert nan[0, 0].all() and nan[1, 1:3].all() and not nan[0, 1:].any()
    assert got[~nan].tobytes() == want[~nan].tobytes()


@pytest.mark.parametrize("Sq,impl", [(1, "torch"), (1, "flash"), (24, "torch"), (128, "flash")])
def test_full_attention_matches_reference(Sq, impl):
    """``full_attention`` under each ``cfg.attn_impl`` against the
    reference's on the CPU; the reference's ``'xla'`` is the port's
    ``'torch'``.  At Sq = 1 under ``'flash'`` the reference takes
    ``blocked_sdpa`` and the port the kernel's plain version; at Sq = 128
    the reference runs its Pallas kernel in interpret mode."""
    rng = np.random.default_rng(Sq)
    Skv = max(Sq, 16)
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, Skv, 2, 16)).astype(np.float32) for _ in range(2))
    cfg = get_config("gemma2-2b", reduced=True)
    kw = dict(causal=Sq > 1, window=None)
    want = j_attention.full_attention(
        *(jnp.asarray(a) for a in (q, k, v)),
        dataclasses.replace(cfg, attn_impl={"torch": "xla"}.get(impl, impl)), **kw)
    got = attention.full_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   dataclasses.replace(cfg, attn_impl=impl), **kw)
    _close(got, want)


@pytest.mark.parametrize("window,softcap", [(None, None), (12, None), (None, 30.0),
                                            (12, 30.0)])
def test_blocked_sdpa_matches_reference(window, softcap):
    rng = np.random.default_rng(12)
    q = rng.standard_normal((1, 40, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 40, 2, 16)).astype(np.float32) for _ in range(2))
    kw = dict(causal=True, window=window, softcap=softcap)
    want = j_attention.blocked_sdpa(*(jnp.asarray(a) for a in (q, k, v)), q_chunk=8, **kw)
    got = attention.blocked_sdpa(*(torch.from_numpy(a) for a in (q, k, v)), q_chunk=8, **kw)
    _close(got, want)
