"""LM training in the port against the reference's, on carried-over state.

Weights, moments and gradients cross with ``models.convert``; tokens are
numpy draws from a seed.  The reference runs on JAX's CPU backend
(``train_loop.make_loss_fn`` under ``jax.value_and_grad``, its jitted
``make_train_step``), the port on CPU tensors (attention through
``blocked_sdpa``, or the flash kernel's plain version under
``attn_impl="flash"``).  Loss, ``ce`` and every gradient agree within the
reference's own 1e-5 (tests/test_training.py), and so do the parameters
after 1 and 3 optimizer steps.  The port alone: microbatching equals one
batch, a restored state continues bit for bit, checkpointing under
``remat`` gives the same gradients, the preemption guard and the
watchdog, and the launcher's ``--ckpt-dir`` resume.
"""
import os
import runpy
import signal
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as j_model
from repro.training import optimizer as j_opt
from repro.training import train_loop as j_train_loop
from repro_torch.configs import get_config
from repro_torch.models import convert
from repro_torch.models import model as model_lib
from repro_torch.training import checkpoint, elastic
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_loop

TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]


def _close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol,
                               err_msg=what)


def _batch(vocab, b=4, s=32, seed=0):
    """The reference test's batch: next-token labels, full mask."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, vocab, (b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], toks[:, :1]], 1)
    return {"tokens": toks, "labels": labels, "loss_mask": np.ones((b, s), bool)}


def _ref_state(arch, seed=0):
    """(cfg, reference model, reference TrainState) of a reduced arch."""
    jcfg = j_get_config(arch, reduced=True)
    jm = j_model.build(jcfg)
    state, _ = j_train_loop.init_state(jm, jax.random.PRNGKey(seed))
    return get_config(arch, reduced=True), jm, state


def _port_state(cfg, jstate):
    return train_loop.from_jax_train_state(cfg, jax.tree.map(np.asarray, jstate))


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_loss_and_grads(cfg, model, batch):
    mdl = model_lib.build(cfg)
    loss, metrics = train_loop.make_loss_fn(mdl)(model, {k: torch.from_numpy(v)
                                                        for k, v in batch.items()})
    names, params = zip(*model.named_parameters())
    return loss, metrics, dict(zip(names, torch.autograd.grad(loss, params)))


# ---------------------------------------------------------------- optimizer

def test_schedule_matches_reference():
    c = opt_lib.OptConfig(peak_lr=1.0, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    jc = j_opt.OptConfig(peak_lr=1.0, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    steps = np.arange(0, 130, dtype=np.int32)
    got = opt_lib.schedule(c, torch.from_numpy(steps))
    _close(got, j_opt.schedule(jc, jnp.asarray(steps)), tol=1e-7)
    assert float(got[0]) == 0.0 and float(got[10]) == pytest.approx(1.0, abs=1e-6)
    assert float(got[100]) == pytest.approx(0.1, abs=1e-6)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((4, 3)).astype(np.float32) * 30,
         "b": rng.standard_normal(5).astype(np.float32) * 30}
    got, norm = opt_lib.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()},
                                            1.0)
    want, jnorm = j_opt.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    _close(norm, jnorm, tol=1e-6)
    for k in g:
        _close(got[k], want[k], tol=1e-7, what=k)
    assert float(opt_lib.global_norm(got)) == pytest.approx(1.0, rel=1e-5)
    small = {"a": torch.full((4,), 1e-3)}
    assert torch.equal(opt_lib.clip_by_global_norm(small, 1.0)[0]["a"], small["a"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_matches_reference(dtype):
    """Three AdamW steps on the same gradients: parameters (cast back to
    their dtype, written in place), float32 moments, step, lr and grad norm
    agree with the reference's functional ``update``."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    cfg = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)
    rng = np.random.default_rng(2)
    p = {"w": rng.standard_normal((6, 5)).astype(np.float32),
         "s": rng.standard_normal(5).astype(np.float32)}
    # copies: update_ writes tp in place, and jnp.asarray may share p's memory
    tp = {k: torch.tensor(v, dtype=tdt) for k, v in p.items()}
    jp = {k: jnp.asarray(v, jdt) for k, v in p.items()}
    ts, js = opt_lib.init(tp), j_opt.init(jp)
    for i in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * 3 for k, v in p.items()}
        tg = {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}
        live = {k: v.data_ptr() for k, v in tp.items()}
        ts, tm = opt_lib.update_(opt_lib.OptConfig(**cfg), tg, ts, tp)
        jp, js, jm = j_opt.update(j_opt.OptConfig(**cfg),
                                  {k: jnp.asarray(v, jdt) for k, v in g.items()}, js, jp)
        assert not tg and {k: v.data_ptr() for k, v in tp.items()} == live
        tol = 1e-6 if dtype == "float32" else 2 ** -8
        for k in p:
            assert tp[k].dtype == tdt and ts.mu[k].dtype == torch.float32
            _close(tp[k], np.asarray(jp[k], np.float32), tol=tol, what=f"step {i} {k}")
            _close(ts.mu[k], js.mu[k], tol=1e-6)
            _close(ts.nu[k], js.nu[k], tol=1e-6)
        assert int(ts.step) == int(js.step) == i + 1
        _close(tm["lr"], jm["lr"], tol=1e-7)
        _close(tm["grad_norm"], jm["grad_norm"], tol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_functional_update_matches_reference(dtype):
    """The functional ``update`` (copies, then ``update_``) against the
    reference's ``update`` over three steps, leaving its inputs as they
    were."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    cfg = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)
    rng = np.random.default_rng(3)
    p = {"w": rng.standard_normal((6, 5)).astype(np.float32),
         "s": rng.standard_normal(5).astype(np.float32)}
    tp = {k: torch.tensor(v, dtype=tdt) for k, v in p.items()}
    jp = {k: jnp.asarray(v, jdt) for k, v in p.items()}
    ts, js = opt_lib.init(tp), j_opt.init(jp)
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    for i in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * 3 for k, v in p.items()}
        tg = {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}
        kept = ({k: v.clone() for k, v in tp.items()}, {k: v.clone() for k, v in tg.items()},
                {k: v.clone() for k, v in ts.mu.items()}, ts.step.clone())
        new_p, new_s, tm = opt_lib.update(opt_lib.OptConfig(**cfg), tg, ts, tp)
        jp, js, jm = j_opt.update(j_opt.OptConfig(**cfg),
                                  {k: jnp.asarray(v, jdt) for k, v in g.items()}, js, jp)
        for was, now in zip(kept[:3], (tp, tg, ts.mu)):
            assert was.keys() == now.keys() and all(torch.equal(was[k], now[k]) for k in was)
        assert torch.equal(kept[3], ts.step)
        for k in p:
            assert new_p[k].dtype == tdt and new_s.mu[k].dtype == torch.float32
            _close(new_p[k], np.asarray(jp[k], np.float32), tol=tol, what=f"step {i} {k}")
            _close(new_s.mu[k], js.mu[k], tol=1e-6)
            _close(new_s.nu[k], js.nu[k], tol=1e-6)
        assert int(new_s.step) == int(js.step) == i + 1
        _close(tm["lr"], jm["lr"], tol=1e-7)
        _close(tm["grad_norm"], jm["grad_norm"], tol=1e-5)
        tp, ts = new_p, new_s


# ---------------------------------------------------------------- one step

@pytest.mark.parametrize("arch,impl", [("tspm-mlho", "auto"), ("gemma2-2b", "auto"),
                                       ("tspm-mlho", "flash")])
def test_loss_and_grads_match_reference(arch, impl):
    """Loss, ce and every gradient of one batch against
    ``jax.value_and_grad`` of the reference's ``make_loss_fn``; gemma2-2b
    has local/global layers (window 16 < 32 tokens), both softcaps,
    post-norms, GeGLU and scaled embeddings.  ``impl='flash'`` runs the
    port's attention through the flash kernel's plain version."""
    cfg, jm, jstate = _ref_state(arch)
    batch = _batch(cfg.vocab_size)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        j_train_loop.make_loss_fn(jm), has_aux=True))(jstate.params, _jbatch(batch))
    cfg = cfg.replace(attn_impl=impl)
    model = _port_state(cfg, jstate).params
    loss, metrics, grads = _port_loss_and_grads(cfg, model, batch)
    _close(loss, jloss, what="loss")
    _close(metrics["ce"], jmet["ce"], what="ce")
    want = convert.named_arrays(cfg, jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(grads)
    for name, g in grads.items():
        _close(g, want[name], what=name)


@pytest.mark.parametrize("arch", ["tspm-mlho", "gemma2-2b", "deepseek-moe-16b", "xlstm-125m",
                                  "pixtral-12b"])
def test_params_after_steps_match_reference(arch):
    """From one carried reference TrainState: the moments and metrics after
    1 and after 3 train steps within 1e-5, and the parameters too, but for
    the elements whose first clipped gradient lies within 100 eps of zero.
    Adam's first step moves a parameter by about +-lr whatever the size of
    its gradient, so there the two packages' rounding-level gradient
    difference (~1e-9) becomes a step of a different size or sign (one such
    element in tspm-mlho and in gemma2-2b: |g| 1.2e-8 and 6.0e-9).  Those
    may part by at most the steps' sum of 2 lr, and fewer than 1 element in
    10,000 may part by more than 1e-5.  deepseek-moe-16b and xlstm-125m take
    AdamW over the MoE and recurrent trees; pixtral-12b trains on tokens
    alone, its ``patch_proj`` getting the zero gradient ``jax.grad`` gives
    it."""
    cfg, jm, jstate = _ref_state(arch)
    opt_cfg = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=10)
    jstep = jax.jit(j_train_loop.make_train_step(jm, j_opt.OptConfig(**opt_cfg)))
    state = _port_state(cfg, jstate)
    step = train_loop.make_train_step(model_lib.build(cfg), opt_lib.OptConfig(**opt_cfg))
    lr_sum, tiny = 0.0, None
    for i in range(3):
        batch = _batch(cfg.vocab_size, seed=10 + i)
        jstate, jmet = jstep(jstate, _jbatch(batch))
        state, met = step(state, batch)
        lr_sum += float(jmet["lr"])
        for k in ("loss", "ce", "lr", "grad_norm"):
            _close(met[k], jmet[k], what=f"step {i} {k}")
        host = jax.tree.map(np.asarray, jstate)
        if tiny is None:     # mu after one step = (1 - b1) * the clipped gradient
            tiny = {n: np.abs(m) < 0.1 * 100 * 1e-8
                    for n, m in convert.named_arrays(cfg, host.opt.mu).items()}
        if i in (0, 2):
            for tree, got in ((host.opt.mu, state.opt.mu), (host.opt.nu, state.opt.nu)):
                want = convert.named_arrays(cfg, tree)
                for name, t in got.items():
                    _close(t, want[name], what=f"step {i} {name}")
            want = convert.named_arrays(cfg, host.params)
            parted = 0
            for name, p in state.params.named_parameters():
                got, w = p.detach().numpy(), want[name]
                keep = ~tiny[name]
                _close(got[keep], w[keep], what=f"step {i} {name}")
                diff = np.abs(got - w)[~keep]
                assert (diff <= TOL + 2 * lr_sum).all(), name
                parted += int((diff > TOL + TOL * np.abs(w[~keep])).sum())
            assert parted < 1e-4 * sum(t.size for t in tiny.values()), parted
            assert int(state.opt.step) == int(host.opt.step) == i + 1


# ---------------------------------------------------------------- the port alone

def _init(arch="tspm-mlho", seed=0, **replace):
    cfg = get_config(arch, reduced=True).replace(**replace)
    mdl = model_lib.build(cfg)
    return cfg, mdl, train_loop.init_state(mdl, torch.Generator("cpu").manual_seed(seed))


def _same_state(a, b):
    for (n, p), (_, q) in zip(a.params.named_parameters(), b.params.named_parameters()):
        assert torch.equal(p, q), n
    for n in a.opt.mu:
        assert torch.equal(a.opt.mu[n], b.opt.mu[n]) and torch.equal(a.opt.nu[n], b.opt.nu[n])
    assert torch.equal(a.opt.step, b.opt.step)


def _copy(state):
    import copy

    return train_loop.TrainState(copy.deepcopy(state.params),
                                 opt_lib.OptState(*copy.deepcopy(tuple(state.opt))))


def test_init_state_is_trainable_and_loss_decreases():
    cfg, mdl, state = _init()
    assert all(p.requires_grad for p in state.params.parameters())
    assert all(m.dtype == torch.float32 for m in state.opt.mu.values())
    step = train_loop.make_train_step(mdl, opt_lib.OptConfig(peak_lr=3e-3, warmup_steps=2,
                                                             decay_steps=50))
    batch = _batch(cfg.vocab_size)
    ces = [float(step(state, batch)[1]["ce"]) for _ in range(12)]
    assert ces[-1] < ces[0] * 0.7, ces


def test_microbatch_equivalence():
    """grad accumulation over 4 microbatches == one big batch step."""
    cfg, mdl, state = _init()
    opt_cfg = opt_lib.OptConfig(peak_lr=1e-3, warmup_steps=0, decay_steps=10)
    batch = _batch(cfg.vocab_size, b=8)
    s1, m1 = train_loop.make_train_step(mdl, opt_cfg)(_copy(state), batch)
    s4, m4 = train_loop.make_train_step(mdl, opt_cfg, microbatches=4)(_copy(state), batch)
    for (n, a), (_, b) in zip(s1.params.named_parameters(), s4.params.named_parameters()):
        _close(a, b.detach().numpy(), what=n)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    assert float(m1["ce"]) == pytest.approx(float(m4["ce"]), rel=1e-5)


def test_remat_gives_the_same_gradients():
    """Checkpointed blocks (``cfg.remat``) recompute the same values."""
    batch = _batch(256, s=24)
    out = {}
    for remat in ("none", "dots"):
        cfg, _, state = _init("gemma2-2b", seed=4, remat=remat)
        out[remat] = _port_loss_and_grads(cfg, state.params, batch)
    assert torch.equal(out["none"][0], out["dots"][0])
    for n, g in out["none"][2].items():
        assert torch.equal(g, out["dots"][2][n]), n


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-2.7b"])
def test_recurrent_families_carry_train_states_and_remat(arch):
    """``from_jax_train_state`` carries the xLSTM and hybrid trees
    (``blk{i}`` stacked by repetition; ``mamba [n_groups, every]`` and
    ``shared [n_blocks]``): parameters, float32 moments and step.  Train
    mode under ``remat`` (each repetition or group checkpointed) gives the
    same loss and gradients bit for bit as without."""
    cfg, _, jstate = _ref_state(arch)
    jstate = jstate._replace(opt=jstate.opt._replace(
        mu=jax.tree.map(lambda a: a + 0.5, jstate.opt.mu),
        nu=jax.tree.map(lambda a: a + 0.25, jstate.opt.nu)))
    state = _port_state(cfg, jstate)
    names = [n for n, _ in state.params.named_parameters()]
    assert all(p.requires_grad for p in state.params.parameters())
    for tree, got in ((jstate.params, dict(state.params.named_parameters())),
                      (jstate.opt.mu, state.opt.mu), (jstate.opt.nu, state.opt.nu)):
        want = convert.named_arrays(cfg, jax.tree.map(np.asarray, tree))
        assert sorted(want) == sorted(got) == sorted(names)
        for n in names:
            np.testing.assert_array_equal(got[n].detach().float().numpy(), want[n], err_msg=n)
    assert all(m.dtype == torch.float32 for m in state.opt.mu.values())
    assert int(state.opt.step) == int(np.asarray(jstate.opt.step))
    batch = _batch(cfg.vocab_size, s=24)
    out = {r: _port_loss_and_grads(cfg.replace(remat=r), state.params, batch)
           for r in ("none", "dots")}
    assert torch.equal(out["none"][0], out["dots"][0])
    for n, g in out["none"][2].items():
        assert torch.equal(g, out["dots"][2][n]), n


def test_checkpoint_resume_is_bit_exact(tmp_path):
    cfg, mdl, state = _init()
    step = train_loop.make_train_step(mdl, opt_lib.OptConfig(warmup_steps=0, decay_steps=10))
    batch = _batch(cfg.vocab_size)
    for _ in range(3):
        state, _ = step(state, batch)
    path = checkpoint.save(str(tmp_path), 3, train_loop.state_tree(state), {"note": "t"})
    assert checkpoint.latest(str(tmp_path)) == path
    _, _, fresh = _init(seed=9)
    tree, manifest = checkpoint.restore(path, train_loop.state_tree(fresh))
    restored = train_loop.restore_state(fresh, tree)
    assert manifest["step"] == 3 and manifest["extra"] == {"note": "t"}
    _same_state(restored, state)
    a, _ = step(state, batch)
    b, _ = step(restored, batch)
    _same_state(a, b)
    os.makedirs(str(tmp_path / "step_00000099.tmp"))      # a crash mid-write
    assert checkpoint.latest(str(tmp_path)) == path
    checkpoint.save_async(str(tmp_path), 4, train_loop.state_tree(a))
    checkpoint.wait()
    tree, _ = checkpoint.restore(checkpoint.latest(str(tmp_path)),
                                 train_loop.state_tree(fresh))
    _same_state(train_loop.restore_state(fresh, tree), a)


def test_async_checkpoint_holds_the_state_it_was_given(tmp_path, monkeypatch):
    """A train step taken between ``save_async`` and ``wait`` (the step
    writes the parameters in place) does not reach the checkpoint: its
    writer is held until the step is done, and what it writes equals the
    state before the step."""
    import threading

    cfg, mdl, state = _init()
    step = train_loop.make_train_step(mdl, opt_lib.OptConfig(warmup_steps=0, decay_steps=10))
    batch = _batch(cfg.vocab_size)
    state, _ = step(state, batch)
    before = _copy(state)
    gate, write = threading.Event(), checkpoint._write
    monkeypatch.setattr(checkpoint, "_write", lambda *a: (gate.wait(10), write(*a)))
    saver = checkpoint.Saver()
    saver.save_async(str(tmp_path), 1, train_loop.state_tree(state))
    state, _ = step(state, batch)
    gate.set()
    saver.wait()
    _, _, fresh = _init(seed=9)
    tree, manifest = checkpoint.restore(checkpoint.latest(str(tmp_path)),
                                        train_loop.state_tree(fresh))
    assert manifest["step"] == 1
    _same_state(train_loop.restore_state(fresh, tree), before)


def test_preemption_guard_checkpoints(tmp_path):
    cfg, mdl, state = _init()
    step = train_loop.make_train_step(mdl, opt_lib.OptConfig(warmup_steps=0, decay_steps=10))
    guard = elastic.PreemptionGuard()
    batch = _batch(cfg.vocab_size)
    done = 0
    for i in range(10):
        if i == 4:
            guard.trigger()          # simulated SIGTERM from the pod manager
        if guard.preempted:
            checkpoint.save(str(tmp_path), i, train_loop.state_tree(state))
            break
        state, _ = step(state, batch)
        done += 1
    assert done == 4 and checkpoint.latest(str(tmp_path)).endswith("step_00000004")
    old = signal.getsignal(signal.SIGTERM)
    try:
        guard = elastic.PreemptionGuard(install_handlers=True)
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.preempted
    finally:
        signal.signal(signal.SIGTERM, old)
        signal.signal(signal.SIGINT, signal.default_int_handler)


def test_watchdog_flags_straggler():
    wd = elastic.StepWatchdog(factor=2.0, window=8)
    for i in range(6):
        wd.start()
        time.sleep(0.02 if i != 4 else 0.1)
        wd.stop(i)
    assert 4 in wd.flagged


def test_train_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    """``launch.train`` on the CPU: 4 steps with a checkpoint, then a run
    to 7 that resumes at step 4 from the state saved, byte for byte."""
    from repro_torch.launch import train

    args = ["--arch", "tspm-mlho", "--reduced", "--device", "cpu", "--patients", "48",
            "--batch", "4", "--seq", "64", "--log-every", "2", "--ckpt-dir", str(tmp_path)]
    train.main(args + ["--steps", "4"])
    first = capsys.readouterr().out
    saved = first.split("state_digest=")[-1].split()[0]
    assert "step 0: loss=" in first and "step 3: loss=" in first
    assert "flash_attention_bwd launches 0" in first    # plain versions on the CPU
    state = train.main(args + ["--steps", "7", "--metrics-json", str(tmp_path / "m.json")])
    out = capsys.readouterr().out
    assert f"resumed from {tmp_path / 'step_00000004'} at step 4" in out
    assert f"restored state_digest={saved}" in out
    assert "step 4: loss=" in out and "step 6: loss=" in out and "(3 steps" in out
    assert int(state.opt.step) == 7 and checkpoint.latest(str(tmp_path)).endswith("7")


def test_example_runs_the_reduced_launcher(tmp_path, monkeypatch, capsys):
    """``examples/train_lm_torch.py --device cpu`` takes the no-argument
    defaults (reduced tspm-mlho); ``--full`` the 300-step run's."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    import train_lm_torch

    assert train_lm_torch.args_for(["--full", "--device", "cpu"]) == [
        "--arch", "tspm-mlho", "--steps", "300", "--batch", "8", "--seq", "256",
        "--patients", "512", "--device", "cpu"]
    args = train_lm_torch.args_for(["--device", "cpu"])
    assert "--reduced" in args and args[-2:] == ["--device", "cpu"]
    monkeypatch.setattr(sys, "argv", ["train_lm_torch.py", "--device", "cpu"])
    monkeypatch.setattr("repro_torch.launch.train.main",
                        lambda argv: print("launcher", argv))
    runpy.run_path(str(ROOT / "examples" / "train_lm_torch.py"), run_name="__main__")
    assert "--reduced" in capsys.readouterr().out
