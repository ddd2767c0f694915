"""The encoder-decoder family (seamless-m4t-large-v2) in the port against
the reference's, on carried-over weights.

Weights come from the reference's own init and cross with
``models.convert.from_jax_params``; source frames and target tokens are
numpy draws from a seed.  Logits of ``encdec.apply`` in modes ``train``,
``prefill`` and ``decode`` (several steps) and the caches (every layer's
keys, values and ``pos``, and the memory) agree within 2e-5, the
tolerance of tests/test_attention.py, as tests/test_torch_models.py holds
the other families; prefill + decode equals the port's own train-mode
forward within 2e-3, the reference's test_prefill_decode_consistency
(tests/test_archs_smoke.py).  ``attention.apply`` with ``causal=False``
and with ``memory`` (cross-attention: keys and values from the memory, no
RoPE) is held against the reference's on its own.  The reduced config:
2 encoder and 2 decoder layers, d 64, 4 heads of 16, vocab 256, float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attention
from repro.models import model as j_model
from repro.training import train_loop as j_train_loop
from repro_torch.configs import get_config
from repro_torch.models import attention, convert, encdec
from repro_torch.models import model as model_lib
from repro_torch.training import train_loop

ARCH = "seamless-m4t-large-v2"
TOL = 2e-5


def _close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol,
                               err_msg=what)


def _pair(seed=0):
    """(cfg, reference model, reference params, port model) on carried weights."""
    jm = j_model.build(j_get_config(ARCH, reduced=True))
    params, _ = jm.init(jax.random.PRNGKey(seed))
    cfg = get_config(ARCH, reduced=True)
    return cfg, jm, params, convert.from_jax_params(cfg, jax.tree.map(np.asarray, params))


def _batch(cfg, b, ss, st, seed=1):
    rng = np.random.default_rng(seed)
    return {"src_embeds": rng.standard_normal((b, ss, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(4, cfg.vocab_size, (b, st)).astype(np.int32)}


def _as(batch, fn):
    return {k: fn(v) for k, v in batch.items()}


def test_build_param_count_and_converted_values():
    """``model.build`` takes the family at full size and reduced; linear
    weights transposed, the tied embedding carried once, ``ln_x``, ``xattn``
    and ``ln_enc`` by name."""
    assert model_lib.build(get_config(ARCH)).cfg.family == "encdec"
    cfg, _, params, port = _pair()
    assert model_lib.param_count(port) == j_model.param_count(params)
    assert isinstance(port, encdec.EncDec) and len(port.enc) == 2 and len(port.dec) == 2
    last = cfg.n_dec_layers - 1
    np.testing.assert_array_equal(port.dec[last].xattn.wk.weight.numpy(),
                                  np.asarray(params["dec"]["xattn"]["wk"]["w"][last]).T)
    np.testing.assert_array_equal(port.enc[0].mlp.down.weight.numpy(),
                                  np.asarray(params["enc"]["mlp"]["down"]["w"][0]).T)
    np.testing.assert_array_equal(port.dec[0].ln_x.scale.numpy(),
                                  np.asarray(params["dec"]["ln_x"]["scale"][0]))
    np.testing.assert_array_equal(port.ln_enc.scale.numpy(), np.asarray(params["ln_enc"]["scale"]))
    np.testing.assert_array_equal(port.embed.table.numpy(), np.asarray(params["embed"]["table"]))
    assert [n for n, _ in port.named_parameters() if "embed" in n] == ["embed.table"]


def test_param_count_at_full_size():
    """1.77 B parameters on the meta device (nothing allocated): the
    reference's ``abstract_init`` count, 262.4 M of them the tied
    embedding."""
    cfg = get_config(ARCH)
    model = encdec.EncDec(cfg, "meta")
    structs, _ = j_model.abstract_init(j_model.build(j_get_config(ARCH)))
    assert model_lib.param_count(model) == j_model.param_count(structs) == 1_772_429_312
    assert model.embed.table.numel() == 256_206 * 1024


@pytest.mark.parametrize("ss,st", [(12, 10), (40, 24)])
def test_train_logits_match_reference(ss, st):
    """Source and target of other lengths than each other; ``aux`` is 0."""
    cfg, jm, params, port = _pair()
    batch = _batch(cfg, 2, ss, st)
    want, aux = jm.apply(params, _as(batch, jnp.asarray), mode="train")
    got, got_aux = model_lib.build(cfg).apply(port, _as(batch, torch.from_numpy), mode="train")
    assert got.shape == want.shape == (2, st, cfg.vocab_size)
    _close(got, want)
    assert got_aux.dtype == torch.float32 and float(got_aux) == float(aux) == 0.0


def test_prefill_and_decode_match_reference():
    """Prefill 8 target tokens over 14 source frames, then 6 decode steps
    fed the reference's greedy tokens: logits, every layer's cache and
    ``pos``, and the memory agree at every step."""
    cfg, jm, params, port = _pair()
    mdl = model_lib.build(cfg)
    b, ss, max_len = 2, 14, 16
    batch = _batch(cfg, b, ss, 8, seed=2)
    jc = jm.init_caches(b, max_len, src_len=ss)
    tc = mdl.init_caches(b, max_len, src_len=ss, device="cpu")
    assert tuple(tc["memory"].shape) == tuple(jc["memory"].shape) == (b, ss, cfg.d_model)
    want, jc = jm.apply(params, _as(batch, jnp.asarray), mode="prefill", caches=jc)
    got, tc = mdl.apply(port, _as(batch, torch.from_numpy), mode="prefill", caches=tc)
    assert got.shape == want.shape == (b, 1, cfg.vocab_size)
    for step in range(7):
        what = f"decode step {step - 1}" if step else "prefill"
        _close(got, want, what=f"{what} logits")
        _close(tc["memory"], jc["memory"], what=f"{what} memory")
        np.testing.assert_array_equal([c["pos"] for c in tc["attn"]],
                                      np.asarray(jc["attn"]["pos"]), err_msg=what)
        for name in ("k", "v"):
            _close(np.stack([c[name].numpy() for c in tc["attn"]]), jc["attn"][name],
                   what=f"{what} {name}")
        if step == 6:
            break
        nxt = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)[:, None]
        want, jc = jm.apply(params, {"tokens": jnp.asarray(nxt)}, mode="decode", caches=jc)
        got, tc = mdl.apply(port, {"tokens": torch.from_numpy(nxt)}, mode="decode", caches=tc)


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_prefill_decode_consistency(impl):
    """The port alone, as the reference's test_prefill_decode_consistency:
    prefill of 8 target tokens and then decode steps give the train-mode
    logits at each position within 2e-3.  Under ``'flash'`` the encoder's
    and the prefill's attentions take the kernel's plain version and a
    decode step's cross-attention (one query row) ``blocked_sdpa``."""
    cfg = get_config(ARCH, reduced=True).replace(attn_impl=impl)
    mdl = model_lib.build(cfg)
    port = mdl.init(torch.Generator("cpu").manual_seed(1))
    batch = _as(_batch(cfg, 2, 12, 12, seed=3), torch.from_numpy)
    full, _ = mdl.apply(port, batch, mode="train")
    caches = mdl.init_caches(2, 24, src_len=12, device="cpu")
    n_pre = 8
    got, caches = mdl.apply(port, dict(batch, tokens=batch["tokens"][:, :n_pre]),
                            mode="prefill", caches=caches)
    _close(got[:, 0], full[:, n_pre - 1], tol=2e-3)
    for t in range(n_pre, 12):
        got, caches = mdl.apply(port, {"tokens": batch["tokens"][:, t:t + 1]}, mode="decode",
                                caches=caches)
        _close(got[:, 0], full[:, t], tol=2e-3, what=f"position {t}")


@pytest.mark.parametrize("case", ["self-causal", "self-bidirectional", "cross", "cross-flash"])
def test_attention_apply_causal_and_memory_match_reference(case):
    """``attention.apply`` against the reference's: causal self-attention,
    ``causal=False`` self-attention, and cross-attention over a memory of
    another length (``memory``: keys and values from it, no RoPE, no
    mask), the last also under ``'flash'`` (the kernel's plain version at
    Sq != Skv)."""
    cfg = get_config(ARCH, reduced=True)
    if case == "cross-flash":
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    rng = np.random.default_rng(30)
    d = cfg.d_model
    w = {n: rng.standard_normal((d, d)).astype(np.float32) * d ** -0.5
         for n in ("wq", "wk", "wv", "wo")}
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    memory = rng.standard_normal((2, 13, d)).astype(np.float32)
    positions = np.broadcast_to(np.arange(9, dtype=np.int32) + 3, (2, 9))
    kw = dict(causal=case == "self-causal")
    port = attention.Attention(cfg, "cpu")
    for n, a in w.items():
        getattr(port, n).weight.copy_(torch.from_numpy(a.T.copy()))
    if case.startswith("cross"):
        got_mem = attention.apply(port, torch.from_numpy(x), cfg,
                                  positions=torch.from_numpy(positions.copy()),
                                  memory=torch.from_numpy(memory), **kw)[0]
        want = j_attention.apply({n: {"w": jnp.asarray(a)} for n, a in w.items()},
                                 jnp.asarray(x), cfg, positions=jnp.asarray(positions),
                                 memory=jnp.asarray(memory), **kw)[0]
        _close(got_mem, want)
        # no RoPE on cross-attention: shifted positions give the same output
        again = attention.apply(port, torch.from_numpy(x), cfg,
                                positions=torch.from_numpy(positions + 5),
                                memory=torch.from_numpy(memory), **kw)[0]
        assert torch.equal(again, got_mem)
        return
    got = attention.apply(port, torch.from_numpy(x), cfg,
                          positions=torch.from_numpy(positions.copy()), **kw)[0]
    want = j_attention.apply({n: {"w": jnp.asarray(a)} for n, a in w.items()}, jnp.asarray(x),
                             cfg, positions=jnp.asarray(positions), **kw)[0]
    _close(got, want)


def test_train_state_carries_params_and_moments():
    """``from_jax_train_state`` carries an encdec ``TrainState`` as it is:
    parameters and both float32 moments by the port's names (moments drawn
    from a seed, so every leaf differs), and the step."""
    jm = j_model.build(j_get_config(ARCH, reduced=True))
    state, _ = j_train_loop.init_state(jm, jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    draw = lambda t: jax.tree.map(  # noqa: E731
        lambda a: rng.standard_normal(a.shape).astype(np.float32), t)
    state = state._replace(opt=state.opt._replace(mu=draw(state.opt.mu), nu=draw(state.opt.nu),
                                                  step=np.int32(5)))
    cfg = get_config(ARCH, reduced=True)
    host = jax.tree.map(np.asarray, state)
    got = train_loop.from_jax_train_state(cfg, host)
    assert int(got.opt.step) == 5
    for tree, mine in ((host.params, dict(got.params.named_parameters())),
                       (host.opt.mu, got.opt.mu), (host.opt.nu, got.opt.nu)):
        want = convert.named_arrays(cfg, tree)
        assert set(want) == set(mine) and "dec.1.xattn.wo.weight" in want
        for name, t in mine.items():
            assert t.dtype == torch.float32, name
            np.testing.assert_array_equal(t.detach().numpy(), want[name], err_msg=name)
    assert all(p.requires_grad for p in got.params.parameters())


def test_remat_gives_the_same_gradients():
    """``cfg.remat`` checkpoints every encoder and decoder layer: the same
    loss and gradients bit for bit."""
    cfg = get_config(ARCH, reduced=True)
    batch = _as(_batch(cfg, 2, 10, 8, seed=5), torch.from_numpy)
    batch.update(labels=batch["tokens"], loss_mask=torch.ones(2, 8, dtype=torch.bool))
    out = []
    for remat in ("none", "dots"):
        mdl = model_lib.build(cfg.replace(remat=remat))
        model = train_loop.trainable(mdl.init(torch.Generator("cpu").manual_seed(6)))
        loss, _ = train_loop.make_loss_fn(mdl)(model, batch)
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
