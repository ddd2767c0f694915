"""The port's MoE layer (``repro_torch.models.moe``) against the reference's.

Weights come from the reference's init of reduced ``deepseek-moe-16b``
(top-2 of 8, 2 shared) and ``llama4-maverick-400b-a17b`` (top-1 of 8, 1
shared, every second layer MoE) and cross with
``models.convert.from_jax_params``; inputs are numpy draws from a seed.
The reference's routing is read from its own ``apply`` (its
``jax.lax.top_k``, ``jnp.argsort``, ``jnp.searchsorted`` and the slot's
``jnp.where`` recorded as they run): ``eid``, the sort order, ranks,
keeps, slots and tokens must be byte-identical, the gates within 1e-6.
``y`` agrees within 2e-4 (tests/test_moe_ssm.py's tolerance) and ``aux``
within 1e-6 relative.  The twins of tests/test_moe_ssm.py's three MoE
tests run on the port alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import model as j_model
from repro.models import moe as j_moe
from repro.training import train_loop as j_train_loop
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import convert, layers, moe, transformer
from repro_torch.models import model as model_lib
from repro_torch.training import train_loop

MOE_ARCHS = ["deepseek-moe-16b", "llama4-maverick-400b-a17b"]
Y_TOL = 2e-4
AUX_RTOL = 1e-6


def _moe_layer(arch, seed=0, **cfg_kw):
    """(reference cfg, reference MoE params, cfg, the port's MoE module) of
    the first MoE layer of a reduced arch, carried through ``convert``."""
    jcfg = j_get_config(arch, reduced=True).replace(**cfg_kw)
    params, _ = j_model.build(jcfg).init(jax.random.PRNGKey(seed))
    cfg = get_config(arch, reduced=True).replace(**cfg_kw)
    port = convert.from_jax_params(cfg, jax.tree.map(np.asarray, params))
    i = transformer.pattern_of(cfg).index("moe")
    jp = jax.tree.map(lambda a: a[0], params[f"blk{i}"]["ffn"])
    return jcfg, jp, cfg, port.blocks[i].ffn


def _x(cfg, b=2, s=24, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


class _Recorder:
    """Stands in for ``jnp`` in the reference's module and records what
    ``argsort``, ``searchsorted`` and ``where`` return."""

    def __init__(self):
        self.seen = {}

    def __getattr__(self, name):
        fn = getattr(jnp, name)
        if name not in ("argsort", "searchsorted", "where"):
            return fn

        def recorded(*a, **kw):
            out = fn(*a, **kw)
            self.seen.setdefault(name, []).append(np.asarray(out))
            return out
        return recorded


def _reference_apply(monkeypatch, jp, x, jcfg):
    """The reference's ``moe.apply`` -> (y, aux, its routing): ``gate``
    (renormalised as it does), ``eid``, ``order``, ``rank``, ``keep``,
    ``slot``, ``token``, as numpy int64 / float32 arrays."""
    rec = _Recorder()
    top = []
    top_k = jax.lax.top_k

    def recorded_top_k(*a, **kw):
        out = top_k(*a, **kw)
        top.append(tuple(np.asarray(t) for t in out))
        return out

    with monkeypatch.context() as m:
        m.setattr(j_moe, "jnp", rec)
        m.setattr(jax.lax, "top_k", recorded_top_k)
        y, aux = j_moe.apply(jp, jnp.asarray(x), jcfg)
    (gate, eid), = top
    gate = gate / np.maximum(gate.sum(-1, keepdims=True), 1e-9)
    order, = rec.seen["argsort"]
    first, = rec.seen["searchsorted"]
    n_k = order.size
    rank = np.arange(n_k) - first
    c = j_moe._capacity(x.shape[0] * x.shape[1], jcfg)
    routing = {"gate": gate, "eid": eid, "order": order, "rank": rank, "keep": rank < c,
               "slot": rec.seen["where"][0], "token": order // jcfg.experts_per_token}
    return np.asarray(y), float(aux), routing


def _same_ints(got, want, what):
    """Equal values and shapes, as int64 (the reference's ids are int32)."""
    got = got.numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64), err_msg=what)


@pytest.mark.parametrize("n", [1, 2, 7, 40, 2048, 12_345])
@pytest.mark.parametrize("capacity_factor", [0.01, 0.5, 1.0, 1.25, 16.0])
def test_capacity_matches_reference(n, capacity_factor):
    for arch in MOE_ARCHS:
        for reduced in (False, True):
            cfg = get_config(arch, reduced).replace(capacity_factor=capacity_factor)
            jcfg = j_get_config(arch, reduced).replace(capacity_factor=capacity_factor)
            assert moe._capacity(n, cfg) == j_moe._capacity(n, jcfg)


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routing_matches_reference(monkeypatch, arch, capacity_factor):
    """At the config's capacity factor and at 0.5, where assignments drop:
    the routing tensors are byte-identical to the reference's."""
    kw = {} if capacity_factor is None else {"capacity_factor": capacity_factor}
    jcfg, jp, cfg, port = _moe_layer(arch, **kw)
    x = _x(cfg)
    _, _, want = _reference_apply(monkeypatch, jp, x, jcfg)
    with torch.no_grad():
        got = moe.route(port, torch.from_numpy(x).reshape(-1, cfg.d_model), cfg)
    for name in ("eid", "order", "rank", "keep", "slot", "token"):
        _same_ints(getattr(got, name), want[name], name)
    np.testing.assert_allclose(got.gate.numpy(), want["gate"], atol=1e-6, rtol=1e-6)
    if capacity_factor == 0.5:
        assert not want["keep"].all()       # the case drops assignments


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_matches_reference(monkeypatch, arch, capacity_factor):
    kw = {} if capacity_factor is None else {"capacity_factor": capacity_factor}
    jcfg, jp, cfg, port = _moe_layer(arch, **kw)
    x = _x(cfg, seed=3)
    want, want_aux, _ = _reference_apply(monkeypatch, jp, x, jcfg)
    with torch.no_grad():
        y, aux = moe.apply(port, torch.from_numpy(x), cfg)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(y.numpy(), want, atol=Y_TOL, rtol=Y_TOL)
    assert float(aux) == pytest.approx(want_aux, rel=AUX_RTOL)


def test_planted_tie_takes_the_lower_expert_first(monkeypatch):
    """Two router columns equal: their probabilities tie exactly.  The port
    orders tied experts lower index first, as ``jax.lax.top_k`` does, so
    ``eid`` (and the aux loss, which reads ``eid[:, 0]``) equal the
    reference's."""
    jcfg, jp, cfg, port = _moe_layer("llama4-maverick-400b-a17b")
    router = np.asarray(jp["router"]).copy()
    x = _x(cfg, seed=4)
    top = np.argmax(x.reshape(-1, cfg.d_model) @ router, -1)
    e_top = int(np.bincount(top).argmax())
    twin = (e_top + 3) % cfg.n_experts
    router[:, twin] = router[:, e_top]
    jp = dict(jp, router=jnp.asarray(router))
    with torch.no_grad():
        port.router.copy_(torch.from_numpy(router))
    want, want_aux, routing = _reference_apply(monkeypatch, jp, x, jcfg)
    with torch.no_grad():
        got = moe.route(port, torch.from_numpy(x).reshape(-1, cfg.d_model), cfg)
        y, aux = moe.apply(port, torch.from_numpy(x), cfg)
    tied = (got.eid[:, 0] == min(e_top, twin)).numpy()
    assert tied.sum() >= 2                  # the tie is met, lower index first
    assert (got.probs[:, e_top] == got.probs[:, twin]).all()
    assert not (got.eid[:, 0] == max(e_top, twin)).any()
    _same_ints(got.eid, routing["eid"], "eid")
    _same_ints(got.slot, routing["slot"], "slot")
    np.testing.assert_allclose(y.numpy(), want, atol=Y_TOL, rtol=Y_TOL)
    assert float(aux) == pytest.approx(want_aux, rel=AUX_RTOL)


# --- twins of tests/test_moe_ssm.py's MoE tests, on the port alone ----------
def _small_cfg(**kw):
    base = dict(name="m", family="moe", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=4, d_ff=64, vocab_size=64, n_experts=8,
                n_shared_experts=0, experts_per_token=2, moe_d_ff=16,
                fsdp=False)
    base.update(kw)
    return ModelConfig(**base)


def _small_moe(cfg, seed):
    p = moe.MoE(cfg, "cpu")
    p.init_weights(torch.Generator().manual_seed(seed))
    return p


def test_capacity_drops_are_counted():
    """With tiny capacity the dropped tokens' outputs are exactly the
    shared path (none here: zero), and the routing says which dropped."""
    cfg = _small_cfg(capacity_factor=0.01)
    p = _small_moe(cfg, 0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16, 32))
                         .astype(np.float32))
    y, _ = moe.apply(p, x, cfg)
    zero = (y.abs().sum(-1) < 1e-9).reshape(-1)
    r = moe.route(p, x.reshape(-1, 32), cfg)
    assert int(zero.sum()) > 0                         # capacity 8 < demand
    kept_any = torch.zeros(32, dtype=torch.bool).index_put_((r.token,), r.keep,
                                                            accumulate=True)
    assert torch.equal(zero, ~kept_any)
    assert int((~r.keep).sum()) == 32 * 2 - int(r.keep.sum()) > 0


def test_unbounded_capacity_matches_dense_mixture():
    """With no drops, y == sum_k gate_k * expert_k(x), computed densely."""
    cfg = _small_cfg(capacity_factor=32.0)
    p = _small_moe(cfg, 1)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 8, 32))
                         .astype(np.float32))
    y, _ = moe.apply(p, x, cfg)
    xf = x.reshape(-1, 32)
    gate, eid = torch.topk(torch.softmax(xf @ p.router, -1), cfg.experts_per_token)
    gate = gate / gate.sum(-1, keepdim=True)
    want = torch.zeros(8, 32)
    for t in range(8):
        for j in range(cfg.experts_per_token):
            e = int(eid[t, j])
            h = torch.nn.functional.silu(xf[t] @ p.w_gate[e]) * (xf[t] @ p.w_up[e])
            want[t] += gate[t, j] * (h @ p.w_down[e])
    torch.testing.assert_close(y.reshape(8, 32), want, atol=2e-4, rtol=2e-4)


def test_aux_loss_bounds():
    """Switch aux >= coef (perfect balance) and small for random routers."""
    cfg = _small_cfg()
    p = _small_moe(cfg, 2)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 64, 32))
                         .astype(np.float32))
    _, aux = moe.apply(p, x, cfg)
    assert float(aux) >= cfg.router_aux_coef * 0.9
    assert float(aux) < cfg.router_aux_coef * cfg.n_experts


def test_small_config_matches_the_reference_moe_test_config():
    """The twins above run tests/test_moe_ssm.py's config."""
    assert _small_cfg().__dict__ == JModelConfig(
        name="m", family="moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
        d_ff=64, vocab_size=64, n_experts=8, n_shared_experts=0,
        experts_per_token=2, moe_d_ff=16, fsdp=False).__dict__


# --- bfloat16 ----------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_casts_and_ordered_combine(monkeypatch, arch):
    """In bfloat16 the experts run in x's dtype (weights cast), the gate is
    cast before its product and the combine adds each token's
    contributions in ascending expert order in bfloat16: ``y`` equals that
    sum written out, byte for byte, repeats bit for bit, and lies within
    bfloat16 rounding of the reference's ``apply`` in bfloat16 (whose
    products round differently on the CPU)."""
    jcfg, jp, cfg, port = _moe_layer(arch, dtype="bfloat16")
    assert port.router.dtype == torch.float32 and port.w_gate.dtype == torch.bfloat16
    x = torch.from_numpy(_x(cfg, seed=5)).to(torch.bfloat16)
    with torch.no_grad():
        y, aux = moe.apply(port, x, cfg)
        again, _ = moe.apply(port, x, cfg)
        r = moe.route(port, x.reshape(-1, cfg.d_model), cfg)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert torch.equal(y.view(torch.int16), again.view(torch.int16))
    # the sum written out: token by token, experts ascending
    xf, (e, c, d) = x.reshape(-1, cfg.d_model), (cfg.n_experts, r.capacity, cfg.d_model)
    buf = torch.zeros(e * c + 1, d, dtype=torch.bfloat16)
    buf[r.slot[r.keep]] = xf[r.token[r.keep]]
    h = buf[:-1].view(e, c, d)
    hg = torch.nn.functional.silu(torch.bmm(h, port.w_gate))
    ho = torch.bmm(hg * torch.bmm(h, port.w_up), port.w_down).reshape(e * c, d)
    want = torch.zeros_like(xf)
    contrib = {}
    for i in range(r.order.numel()):
        if r.keep[i]:
            t, ex = int(r.token[i]), int(r.order[i]) % cfg.experts_per_token
            contrib.setdefault(t, []).append(
                (int(r.eid[t, ex]), ho[r.slot[i]] * r.gate[t, ex].to(torch.bfloat16)))
    for t, items in contrib.items():
        for _, v in sorted(items, key=lambda iv: iv[0]):
            want[t] = want[t] + v
    want = want + layers.mlp(port.shared, xf, cfg.mlp_act)
    assert torch.equal(y.reshape(-1, d).view(torch.int16), want.view(torch.int16))
    ref, ref_aux, _ = _reference_apply(
        monkeypatch, jp, x.float().numpy().astype(jnp.bfloat16), jcfg)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(y.float().numpy(), ref, atol=2e-2, rtol=2 ** -5)
    assert float(aux) == pytest.approx(ref_aux, rel=1e-4)


# --- whole models and train states --------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS + ["pixtral-12b"])
def test_train_state_and_loss_carry_over(arch):
    """``train_loop.from_jax_train_state`` carries a reference train state
    of an MoE or VLM model as it is (parameters and moments by name), and
    the loss with its aux equals the reference's within 2e-4."""
    jcfg = j_get_config(arch, reduced=True)
    jm = j_model.build(jcfg)
    jstate, _ = j_train_loop.init_state(jm, jax.random.PRNGKey(0))
    cfg = get_config(arch, reduced=True)
    state = train_loop.from_jax_train_state(cfg, jax.tree.map(np.asarray, jstate))
    named = convert.named_arrays(cfg, jax.tree.map(np.asarray, jstate.params))
    for name, p in state.params.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), named[name], err_msg=name)
        assert state.opt.mu[name].shape == p.shape
    rng = np.random.default_rng(0)
    toks = rng.integers(4, cfg.vocab_size, (2, 16)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.family == "vlm":   # labels cover the patches and the text (launch/specs.py)
        batch["patch_embeds"] = rng.standard_normal(
            (2, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    labels = rng.integers(4, cfg.vocab_size, (2, cfg.n_patches + 16)).astype(np.int32)
    batch.update(labels=labels, loss_mask=np.ones_like(labels, bool))
    want, wm = j_train_loop.make_loss_fn(jm)(jstate.params, jax.tree.map(jnp.asarray, batch))
    got, gm = train_loop.make_loss_fn(model_lib.build(cfg))(
        state.params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(got.detach()) == pytest.approx(float(want), rel=2e-4)
    if cfg.family == "moe":
        aux = float(gm["aux"].detach())
        assert aux == pytest.approx(float(wm["aux"]), rel=AUX_RTOL) and aux > 0
