"""Training of the MoE, VLM, xLSTM, hybrid and encoder-decoder families in
the port against the reference's, on carried-over state.

The twin, for every family beyond the dense one, of
tests/test_torch_training.py's ``test_loss_and_grads_match_reference``
(and of the reference's own tests/test_archs_smoke.py, which runs
``jax.value_and_grad`` for every architecture).  The reference's
``TrainState`` crosses with ``train_loop.from_jax_train_state``; the batch
is the reference's ``launch/specs.train_batch`` (a VLM's labels cover its
patches and its text, an encoder-decoder's source and target take half
the sequence each).  The reference runs ``jax.value_and_grad`` of its
``make_loss_fn`` on JAX's CPU backend, the port ``torch.autograd`` of its
own on CPU tensors: attention through ``blocked_sdpa``, or, under
``attn_impl="flash"``, through the flash kernel's plain version, which
autograd then differentiates.  Loss, ``ce``, ``aux`` and every gradient
(an MoE router's among them, which the balance loss reaches) agree within
the reference's own 1e-5 (tests/test_training.py).  The launcher trains
the families whose batch is tokens alone, as the reference's does.
"""
import functools
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig
from repro.launch import specs as j_specs
from repro.models import model as j_model
from repro.training import train_loop as j_train_loop
from repro_torch.configs import get_config
from repro_torch.models import convert
from repro_torch.models import model as model_lib
from repro_torch.training import train_loop

TOL = 1e-5
SEQ, BATCH = 32, 2


def _close(got, want, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=TOL, rtol=TOL,
                               err_msg=what)


@functools.cache
def _reference(arch):
    """(reference TrainState, the batch as numpy, loss, metrics, gradients by
    the port's names) of one reduced arch, computed once a file."""
    jcfg = j_get_config(arch, reduced=True)
    jm = j_model.build(jcfg)
    state, _ = j_train_loop.init_state(jm, jax.random.PRNGKey(0))
    batch = j_specs.train_batch(jcfg, ShapeConfig("train", SEQ, BATCH, "train"),
                                concrete=True, seed=0)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        j_train_loop.make_loss_fn(jm), has_aux=True))(state.params, batch)
    host = jax.tree.map(np.array, (state, batch, loss, metrics, grads))
    return (*host[:4], convert.named_arrays(get_config(arch, reduced=True), host[4]))


@pytest.mark.parametrize("arch,impl", [
    ("deepseek-moe-16b", "auto"), ("pixtral-12b", "auto"), ("xlstm-125m", "auto"),
    ("zamba2-2.7b", "auto"), ("seamless-m4t-large-v2", "auto"),
    ("zamba2-2.7b", "flash"), ("seamless-m4t-large-v2", "flash")])
def test_family_loss_and_grads_match_reference(arch, impl):
    """deepseek-moe-16b: MoE every layer, the balance loss in the loss;
    pixtral-12b: 8 projected patches before the text; xlstm-125m: mLSTM and
    sLSTM (the sLSTM's time loop under autograd); zamba2-2.7b: Mamba2
    scans and the shared attention blocks; seamless-m4t-large-v2: the
    non-causal encoder and the decoder's cross-attention.  ``impl='flash'``
    sends zamba2's shared attention and seamless's three attentions to the
    flash kernel's plain version."""
    jstate, batch, jloss, jmet, want = _reference(arch)
    cfg = get_config(arch, reduced=True).replace(attn_impl=impl)
    model = train_loop.from_jax_train_state(cfg, jstate).params
    loss, metrics = train_loop.make_loss_fn(model_lib.build(cfg))(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    _close(loss, jloss, "loss")
    _close(metrics["ce"], jmet["ce"], "ce")
    _close(metrics["aux"], jmet["aux"], "aux")
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g.dtype == torch.float32 and g.shape == want[name].shape, name
        _close(g, want[name], name)
    if cfg.n_experts:
        assert float(jmet["aux"]) > 0
        routers = [n for n in grads if n.endswith("ffn.router")]
        assert len(routers) == cfg.n_layers
        assert all(np.abs(want[n]).max() > 0 for n in routers)
    if cfg.family == "vlm":
        assert batch["labels"].shape[1] == batch["tokens"].shape[1] + cfg.n_patches
        assert np.abs(want["patch_proj.weight"]).max() > 0
    if cfg.family == "encdec":
        assert batch["src_embeds"].shape[1] == batch["tokens"].shape[1] == SEQ // 2
        assert np.abs(want["dec.0.xattn.wk.weight"]).max() > 0
        assert np.abs(want["enc.0.attn.wq.weight"]).max() > 0


LAUNCHER_LINE = re.compile(r"^step (\d+): loss=(\S+) ce=(\S+) lr=\S+$", re.M)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "pixtral-12b", "xlstm-125m",
                                  "zamba2-2.7b"])
def test_launcher_trains_the_token_families_on_the_cpu(arch, capsys):
    """``launch.train --arch ARCH --reduced --device cpu``, as the
    reference's launcher takes any family whose batch is tokens (a VLM
    without patches: its ``patch_proj`` gets a zero gradient, as
    ``jax.grad`` gives it): the reference's log lines (``corpus:``,
    ``model: ARCH params=N`` with the reference's count at that
    vocabulary, ``step i: loss= ce= lr=``, ``done in``), finite values and
    every step logged."""
    from repro_torch.launch import train

    train.main(["--arch", arch, "--reduced", "--device", "cpu", "--patients", "32",
                "--batch", "2", "--seq", "32", "--steps", "3", "--log-every", "1"])
    out = capsys.readouterr().out
    vocab = int(re.search(r"^corpus: \S+ \S+ vocab=(\d+)", out, re.M).group(1))
    jcfg = j_get_config(arch, reduced=True)
    jcfg = jcfg.replace(vocab_size=max(jcfg.vocab_size, vocab))
    structs, _ = j_model.abstract_init(j_model.build(jcfg))
    assert f"model: {arch} params={j_model.param_count(structs):,}\n" in out
    steps = LAUNCHER_LINE.findall(out)
    assert [int(s[0]) for s in steps] == [0, 1, 2]
    assert all(np.isfinite(float(x)) for s in steps for x in s[1:])
    assert re.search(r"^done in \S+s \(3 steps, 0 stragglers, mean step \S+s\)$", out, re.M)
