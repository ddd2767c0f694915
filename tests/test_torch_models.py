"""The port's decoder against the reference's, on carried-over weights.

Weights come from the reference's own init (``model.build(cfg).init``)
and cross with ``models.convert.from_jax_params``; tokens (and a VLM's
patch embeddings) are numpy draws from a seed.  Logits of
``transformer.apply`` in modes ``train``, ``prefill`` and ``decode``
(several steps) must agree within 2e-5, the tolerance of
tests/test_attention.py, and so must the caches' ``pos`` and the keys and
values they hold; where an MoE layer lies between, within 2e-4, the
reference MoE test's tolerance (tests/test_moe_ssm.py), and the train
mode's ``aux`` within 1e-6 relative.  Reduced ``tspm-mlho`` (dense, GQA),
``gemma2-2b`` (local/global layers with window 16, both softcaps,
post-norms, GeGLU, scaled embeddings), ``deepseek-moe-16b`` (MoE every
layer, top-2 of 8, 2 shared), ``llama4-maverick-400b-a17b`` (dense and
MoE layers interleaved, top-1, 1 shared) and ``pixtral-12b`` (8 projected
patch embeddings before the tokens) run on the CPU, where attention is
the plain ``blocked_sdpa``; so do reduced ``xlstm-125m`` (two mLSTM and
one sLSTM a repetition, chunk 8) and ``zamba2-2.7b`` (two
groups of two Mamba2 layers, each followed by a shared attention
invocation, the two shared blocks alternating), whose logits and
recurrent states hold the same 2e-5 (largest reading: xlstm-125m's train
logits, 2.4e-5 off values up to 43, inside 2e-5 + 2e-5 |want|).
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
from repro_torch.models import attention, convert, layers, transformer, xlstm, zamba
from repro_torch.models import model as model_lib

ARCH_CASES = ["tspm-mlho", "gemma2-2b", "deepseek-moe-16b", "llama4-maverick-400b-a17b",
              "pixtral-12b", "xlstm-125m", "zamba2-2.7b"]
TOL = 2e-5
MOE_TOL = 2e-4


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


def _tol(cfg):
    return MOE_TOL if cfg.n_experts else TOL


def _batch(cfg, toks, seed=1):
    """``{"tokens"}``, with a VLM's patch embeddings ``[B, n_patches,
    frontend_dim]`` (a seeded normal draw) before them."""
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patch_embeds"] = np.random.default_rng(seed + 100).standard_normal(
            (toks.shape[0], cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    return batch


def _as(batch, fn):
    return {k: fn(v) for k, v in batch.items()}


def test_configs_resolve_the_same_arch_names():
    from repro.configs import ARCHS as J_ARCHS

    assert ARCHS == J_ARCHS
    for arch in ARCHS:
        for reduced in (False, True):
            assert (get_config(arch, reduced).__dict__
                    == j_get_config(arch, reduced).__dict__)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def _converted_recurrent(cfg, params, port):
    """xLSTM: the last layer's linear weights transposed, an sLSTM's
    recurrent ``r`` as it is; Zamba2: the last Mamba2 layer's projections
    transposed and its conv and float32 parameters as they are, each
    shared block's attention and ``down``."""
    last = cfg.n_layers - 1
    if cfg.family == "xlstm":
        pattern = xlstm.pattern_of(cfg)
        rep, i = divmod(last, len(pattern))
        blk, jblk = port.blocks[last], params[f"blk{i}"]
        assert blk.kind == pattern[i] == "s"
        np.testing.assert_array_equal(blk.wx.weight.numpy(), np.asarray(jblk["wx"]["w"][rep]).T)
        np.testing.assert_array_equal(blk.r.numpy(), np.asarray(jblk["r"][rep]))
        np.testing.assert_array_equal(port.blocks[0].wg.weight.numpy(),
                                      np.asarray(params["blk0"]["wg"]["w"][0]).T)
        return
    g, i = divmod(last, zamba._groups(cfg)[1])
    blk, jm = port.mamba[last], params["mamba"]
    np.testing.assert_array_equal(blk.in_proj.weight.numpy(),
                                  np.asarray(jm["in_proj"]["w"][g, i]).T)
    for name in ("conv_w", "conv_b", "a_log", "d_skip", "dt_bias"):
        np.testing.assert_array_equal(getattr(blk, name).numpy(), np.asarray(jm[name][g, i]),
                                      err_msg=name)
    assert blk.a_log.dtype == blk.d_skip.dtype == blk.dt_bias.dtype == torch.float32
    for j in range(cfg.n_shared_attn_blocks):
        sh, jsh = port.shared[j], params["shared"]
        np.testing.assert_array_equal(sh.attn.wq.weight.numpy(),
                                      np.asarray(jsh["attn"]["wq"]["w"][j]).T)
        np.testing.assert_array_equal(sh.down.weight.numpy(), np.asarray(jsh["down"]["w"][j]).T)


@pytest.mark.parametrize("arch", ARCH_CASES)
def test_param_count_and_converted_values(arch):
    """Linear weights transposed, expert weights and the router as they
    are (``torch.bmm``'s layout is the reference's)."""
    cfg, jm, params, port = _pair(arch)
    assert model_lib.param_count(port) == j_model.param_count(params)
    if cfg.family in ("xlstm", "hybrid"):
        _converted_recurrent(cfg, params, port)
        return
    pattern = transformer.pattern_of(cfg)
    layer = cfg.n_layers - 1
    blk = params[f"blk{layer % len(pattern)}"]
    rep = layer // len(pattern)
    np.testing.assert_array_equal(
        port.blocks[layer].attn.wq.weight.numpy(),
        np.asarray(blk["attn"]["wq"]["w"][rep]).T)
    assert port.blocks[layer].kind == pattern[layer % len(pattern)]
    if pattern[-1] == "moe":
        ffn, jffn = port.blocks[layer].ffn, blk["ffn"]
        assert ffn.router.dtype == torch.float32
        for name in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(getattr(ffn, name).numpy(),
                                          np.asarray(jffn[name][rep]), err_msg=name)
        np.testing.assert_array_equal(ffn.shared.down.weight.numpy(),
                                      np.asarray(jffn["shared"]["down"]["w"][rep]).T)
    if cfg.family == "vlm":
        np.testing.assert_array_equal(port.patch_proj.weight.numpy(),
                                      np.asarray(params["patch_proj"]["w"]).T)


@pytest.mark.parametrize("arch", ARCH_CASES)
@pytest.mark.parametrize("seq", [8, 40])
def test_train_logits_match_reference(arch, seq):
    """seq 40 crosses gemma2's reduced window (16) on its local layers and
    is no multiple of the recurrent families' reduced chunk (8: one chunk
    of 40, as the reference); a VLM's logits cover its patches and
    tokens; ``aux`` is the MoE layers' sum (0 without them)."""
    cfg, jm, params, port = _pair(arch)
    batch = _batch(cfg, _tokens(cfg, 2, seq))
    want, aux = jm.apply(params, _as(batch, jnp.asarray), mode="train")
    got, got_aux = model_lib.build(cfg).apply(port, _as(batch, torch.from_numpy), mode="train")
    assert got.shape == want.shape == (2, cfg.n_patches + seq, cfg.vocab_size)
    _close(got, want, tol=_tol(cfg))
    assert got_aux.dtype == torch.float32 and got_aux.shape == ()
    if cfg.n_experts:
        assert float(got_aux) == pytest.approx(float(aux), rel=1e-6) and float(aux) > 0
    else:
        assert float(got_aux) == float(aux) == 0.0


def _caches_as_reference(cfg, caches):
    """The port's per-layer caches stacked into the reference's layout:
    one dict per pattern position with [n_rep, ...] arrays."""
    n = len(transformer.pattern_of(cfg))
    return [{"k": np.stack([c["k"].numpy() for c in caches[i::n]]),
             "v": np.stack([c["v"].numpy() for c in caches[i::n]]),
             "pos": np.asarray([c["pos"] for c in caches[i::n]], np.int32)}
            for i in range(n)]


def _assert_recurrent_caches_match(cfg, got, want, what):
    """xLSTM: by pattern position, the repetitions' states stacked;
    Zamba2: the Mamba2 states stacked ``[n_groups, every]`` and the shared
    attention's caches ``[n_groups]`` (each invocation its own)."""
    def stack(xs):
        return np.stack([np.stack(x) if isinstance(x, list) else x for x in xs])

    if cfg.family == "xlstm":
        for i, (g, w) in enumerate(zip(got, want)):
            for name in (("C", "n") if isinstance(w, tuple) else ("h", "c", "n", "m")):
                leaves = [getattr(st, name) if isinstance(w, tuple) else st[name] for st in g]
                _close(stack([x.numpy() for x in leaves]),
                       getattr(w, name) if isinstance(w, tuple) else w[name],
                       what=f"{what} {i}.{name}")
        return
    conv, scan = want["mamba"]
    for name, w in (("conv", conv), ("C", scan.C), ("n", scan.n)):
        g = [[(st[0] if name == "conv" else getattr(st[1], name)).numpy() for st in grp]
             for grp in got["mamba"]]
        _close(np.stack([np.stack(x) for x in g]), w, what=f"{what} mamba {name}")
    attn = want["attn"]
    np.testing.assert_array_equal([c["pos"] for c in got["attn"]], np.asarray(attn["pos"]),
                                  err_msg=what)
    for name in ("k", "v"):
        _close(np.stack([c[name].numpy() for c in got["attn"]]), attn[name],
               what=f"{what} attn {name}")


def _assert_caches_match(cfg, got, want, what):
    if cfg.family in ("xlstm", "hybrid"):
        _assert_recurrent_caches_match(cfg, got, want, what)
        return
    for g, w in zip(_caches_as_reference(cfg, got), want):
        np.testing.assert_array_equal(g["pos"], np.asarray(w["pos"]), err_msg=what)
        _close(g["k"], w["k"], tol=_tol(cfg), what=f"{what} k")
        _close(g["v"], w["v"], tol=_tol(cfg), what=f"{what} v")


@pytest.mark.parametrize("arch", ARCH_CASES)
def test_prefill_and_decode_match_reference(arch):
    """Prefill 20 tokens (after a VLM's patches), then 6 decode steps fed
    the reference's greedy tokens: logits and caches agree at every step."""
    cfg, jm, params, port = _pair(arch)
    mdl = model_lib.build(cfg)
    b, plen, max_len = 2, 20, 32 + cfg.n_patches
    batch = _batch(cfg, _tokens(cfg, b, plen, seed=2))
    jc = jm.init_caches(b, max_len)
    tc = mdl.init_caches(b, max_len, device="cpu")
    want, jc = jm.apply(params, _as(batch, jnp.asarray), mode="prefill", caches=jc)
    got, tc = mdl.apply(port, _as(batch, torch.from_numpy), mode="prefill", caches=tc)
    assert got.shape == want.shape == (b, 1, cfg.vocab_size)
    _close(got, want, tol=_tol(cfg), what="prefill logits")
    _assert_caches_match(cfg, tc, jc, "prefill")
    for step in range(6):
        nxt = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)[:, None]
        want, jc = jm.apply(params, {"tokens": jnp.asarray(nxt)}, mode="decode",
                            caches=jc)
        got, tc = mdl.apply(port, {"tokens": torch.from_numpy(nxt)}, mode="decode",
                            caches=tc)
        _close(got, want, tol=_tol(cfg), what=f"decode step {step} logits")
        _assert_caches_match(cfg, tc, jc, f"decode step {step}")


def _assert_decode_equals_train(cfg):
    """The port alone: prefill + decode steps give the train-mode logits
    of the whole sequence at each position (the cache is exact), a VLM's
    at offset ``n_patches``."""
    mdl = model_lib.build(cfg)
    port = mdl.init(torch.Generator("cpu").manual_seed(3))
    batch = _as(_batch(cfg, _tokens(cfg, 2, 26, seed=4)), torch.from_numpy)
    toks, off = batch["tokens"], cfg.n_patches
    full, _ = mdl.apply(port, batch, mode="train")
    caches = mdl.init_caches(2, 32 + off, device="cpu")
    got, caches = mdl.apply(port, dict(batch, tokens=toks[:, :20]), mode="prefill",
                            caches=caches)
    _close(got[:, 0], full[:, off + 19], tol=1e-4)
    for t in range(20, 26):
        got, caches = mdl.apply(port, {"tokens": toks[:, t:t + 1]}, mode="decode",
                                caches=caches)
        _close(got[:, 0], full[:, off + t], tol=1e-4, what=f"position {t}")


def test_decode_equals_the_last_row_of_train():
    _assert_decode_equals_train(get_config("gemma2-2b", reduced=True))


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-2.7b"])
def test_decode_equals_train_for_recurrent_families(arch):
    """``_assert_decode_equals_train`` for the xLSTM and hybrid families
    (the reference's own check, tests/test_archs_smoke.py): the scans'
    states carry from prefill into decode (the sLSTM's stabilizer and the
    Mamba2 conv window among them), and each shared attention invocation
    keeps its own cache.  The prefill's 20 tokens are no multiple of the
    reduced chunk (8): one chunk of 20, as the reference takes."""
    _assert_decode_equals_train(get_config(arch, reduced=True))


@pytest.mark.parametrize("arch,count", [("xlstm-125m", 114_220_800),
                                        ("zamba2-2.7b", 2_786_410_400)])
def test_param_count_at_full_size(arch, count):
    """The full-size model on the meta device (nothing allocated) has the
    reference's parameter count, ``abstract_init``'s."""
    cfg = get_config(arch)
    model = model_lib.MODULES[cfg.family](cfg, "meta")
    structs, _ = j_model.abstract_init(j_model.build(j_get_config(arch)))
    assert model_lib.param_count(model) == j_model.param_count(structs) == count
    if cfg.family == "hybrid":
        shared = zamba._shared_cfg(cfg)
        assert (shared.d_model, shared.hd, shared.attn_softcap, shared.sliding_window) \
            == (5120, 160, None, None)
        assert zamba._groups(cfg) == (9, 6) and len(model.shared) == 2


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "llama4-maverick-400b-a17b",
                                  "pixtral-12b"])
def test_decode_equals_train_at_unbounded_capacity(arch):
    """``_assert_decode_equals_train`` for the MoE and VLM families, at
    ``capacity_factor=16`` so that no assignment drops on either path (the
    reference's own check, tests/test_archs_smoke.py)."""
    cfg = get_config(arch, reduced=True)
    _assert_decode_equals_train(cfg.replace(capacity_factor=16.0) if cfg.n_experts else cfg)


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


def test_entry_points_default_to_the_card():
    """``init`` and ``init_caches`` default to the card, and raise without
    one (pass ``device='cpu'`` for the plain versions); every family of the
    reference builds, ``encdec`` among them (tests/test_torch_encdec.py)."""
    assert set(model_lib.FAMILIES) == {get_config(a).family for a in ARCHS}
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
    ``'torch'``.  At Sq = 1 under ``'flash'`` both take ``blocked_sdpa``;
    at Sq = 128 the reference runs its Pallas kernel in interpret mode."""
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


@pytest.mark.parametrize("kv_len", [None, 21, 0])
@pytest.mark.parametrize("impl", ["torch", "flash"])
def test_full_attention_impl_and_kv_len_match_reference(impl, kv_len):
    """``impl`` overrides the config's ``attn_impl``, and keys at and past
    ``kv_len`` are masked, as the reference's ``full_attention(...,
    impl='xla', kv_len=...)`` masks them (its Pallas kernel takes no
    ``kv_len``; the port's ``'flash'`` gives the kernel the keys before it)."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 32, 2, 16)).astype(np.float32) for _ in range(2))
    cfg = get_config("gemma2-2b", reduced=True)
    kw = dict(causal=False, window=None, kv_len=kv_len)
    want = j_attention.full_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                      dataclasses.replace(cfg, attn_impl="flash"),
                                      impl="xla", **kw)
    other = {"torch": "flash", "flash": "torch"}[impl]
    got = attention.full_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   dataclasses.replace(cfg, attn_impl=other), impl=impl, **kw)
    _close(got, want)
    if kv_len == 0:
        assert not got.any()


@pytest.mark.parametrize("scale,kv_len,causal", [(0.3, None, True), (None, 25, True),
                                                 (0.3, 25, False), (None, 0, False)])
def test_blocked_sdpa_scale_and_kv_len_match_reference(scale, kv_len, causal):
    rng = np.random.default_rng(13)
    q = rng.standard_normal((1, 40, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 40, 2, 16)).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=None, softcap=None, scale=scale, kv_len=kv_len)
    want = j_attention.blocked_sdpa(*(jnp.asarray(a) for a in (q, k, v)), q_chunk=8, **kw)
    got = attention.blocked_sdpa(*(torch.from_numpy(a) for a in (q, k, v)), q_chunk=8, **kw)
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


@pytest.mark.parametrize("Sq", [1, 2, 17])
def test_flash_sends_one_query_row_to_blocked_sdpa(monkeypatch, Sq):
    """Under ``'flash'`` Sq = 1 never reaches ``flash_ops.attention`` (the
    reference's dispatch, ``full_attention``'s ``q.shape[1] > 1``): the
    calls are counted, and the values equal the reference's and the port's
    own ``blocked_sdpa``; Sq > 1 calls the kernel's wrapper once."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    calls = []
    attention_op = flash_ops.attention
    monkeypatch.setattr(flash_ops, "attention",
                        lambda *a, **kw: calls.append(1) or attention_op(*a, **kw))
    rng = np.random.default_rng(20 + Sq)
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 9, 2, 16)).astype(np.float32) for _ in range(2))
    cfg = get_config("gemma2-2b", reduced=True)
    kw = dict(causal=False, window=None)
    got = attention.full_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   dataclasses.replace(cfg, attn_impl="flash"), **kw)
    assert len(calls) == (Sq > 1)
    want = j_attention.full_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                      dataclasses.replace(cfg, attn_impl="flash"), **kw)
    _close(got, want)
    if Sq == 1:
        plain = attention.blocked_sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                                       causal=False, softcap=cfg.attn_softcap)
        assert torch.equal(got, plain)
    # a decode step's cache path never reaches full_attention at all
    calls.clear()
    mdl = model_lib.build(dataclasses.replace(cfg, attn_impl="flash"))
    port = mdl.init(torch.Generator("cpu").manual_seed(0))
    caches = mdl.init_caches(2, 8, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 1))
    mdl.apply(port, {"tokens": toks}, mode="prefill", caches=caches)
    assert not calls
