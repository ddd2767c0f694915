"""The dry run on the reference's production meshes, and the manual-SPMD
paths its cells trace, on the CPU.

* ``run_cell(..., mesh="pod16x16")`` and ``multi_pod=True`` on fake
  ``cpu`` tensors over a fake process group, one arch a family, at a small
  ``ShapeConfig`` and a few layers (``overrides``): each record has the
  reference's keys, its mesh tag and ``chips``, ``coll_breakdown`` keyed
  by the reference's ``_COLLECTIVES``, and a train cell ``t_collective >
  0``; ``--multi-pod`` and ``--both-meshes`` take the reference's meaning.
* On real collectives, in spawned ``gloo`` worlds (tests/torch_mesh_worker.py):
  the expert-parallel MoE (``moe.apply_shard_map``) on a 2 x 4 mesh against
  the port's dense ``moe.apply`` on one device and the reference's output
  from the same weights (atol/rtol 3e-4, aux within 1e-6), its train loss
  (the vocab-parallel ``lm_loss``) and gradients, the ``gspmd`` forward
  (the gathered tokens) and a decode step over a sequence-sharded cache
  (flash-decode) with the cache it writes, against one device; and xlstm's
  sLSTM on the local shard on a 4 x 2 mesh against the reference's
  ``lm_loss`` (1e-4 relative) and gradients (atol 3e-4, rtol 3e-3) on one
  device: the tolerances of the reference's tests/test_distributed.py.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker
from repro.analysis import roofline as j_rl
from repro.configs import get_config as j_get_config
from repro.models import model as j_model
from repro.training import train_loop as j_train_loop
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import convert
from repro_torch.models import model as model_lib
from repro_torch.training import train_loop

REF_KEYS = {"arch", "shape", "mesh", "tag", "overrides", "microbatches", "status",
            "t_lower_s", "t_compile_s", "params_total", "params_active",
            "memory_analysis", "roofline"}

# (arch, shape, layers, multi_pod): one arch a family, the MoE (the EP
# path) on the 512-rank mesh and the others on the 256-rank one, each cut
# to a few layers
CELLS = [
    ("gemma2-2b", ShapeConfig("t64", 64, 32, "train"), 2, False),
    ("deepseek-moe-16b", ShapeConfig("p64", 64, 32, "prefill"), 1, True),
    ("pixtral-12b", ShapeConfig("p1056", 1056, 32, "prefill"), 1, False),
    ("xlstm-125m", ShapeConfig("p32", 32, 32, "prefill"), 6, False),
    ("zamba2-2.7b", ShapeConfig("d64", 64, 32, "decode"), 6, False),
    ("seamless-m4t-large-v2", ShapeConfig("t64", 64, 32, "train"), 2, False),
    ("seamless-m4t-large-v2", ShapeConfig("d64", 64, 32, "decode"), 2, False),
]


def _overrides(arch, layers):
    out = {"n_layers": layers}
    if arch == "seamless-m4t-large-v2":
        out.update(n_enc_layers=layers // 2, n_dec_layers=layers // 2)
    return out


@pytest.mark.parametrize("cell", range(len(CELLS)),
                         ids=[f"{c[0]}-{'pod2x16x16' if c[3] else 'pod16x16'}" for c in CELLS])
def test_run_cell_on_the_production_meshes(cell, tmp_path):
    arch, shape, layers, multi_pod = CELLS[cell]
    tag = "pod2x16x16" if multi_pod else "pod16x16"
    rec = dryrun.run_cell(arch, shape, multi_pod, str(tmp_path),
                          overrides=_overrides(arch, layers), device="cpu",
                          mesh="pod16x16")
    assert rec["status"] == "ok", rec.get("traceback")
    assert REF_KEYS <= set(rec)
    assert rec["mesh"] == tag and rec["chips"] == (512 if multi_pod else 256)
    rf = rec["roofline"]
    assert rf["chips"] == rec["chips"]
    assert tuple(rf["coll_breakdown"]) == j_rl._COLLECTIVES
    assert rf["coll_bytes"] == sum(rf["coll_breakdown"].values()) * rec["chips"]
    if shape.kind == "train":
        assert rf["t_collective_s"] > 0
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] \
        == mem["peak_size_in_bytes"]
    assert rec["counted_flops_scope"] == "per rank" and rec["counted_flops"] > 0
    with open(tmp_path / f"{arch}__{shape.name}__{tag}.json") as f:
        assert json.load(f)["mesh"] == tag


def test_the_command_line_takes_the_references_mesh_flags(tmp_path):
    """``--multi-pod`` traces on pod2x16x16, ``--both-meshes`` on both
    production meshes; an unknown mesh is refused."""
    common = ["--arch", "glm4-9b", "--shape", "decode_32k", "--device", "cpu",
              "--set", "n_layers=1", "--out", str(tmp_path)]
    for flags, tags in ((["--multi-pod"], ["pod2x16x16"]),
                        (["--both-meshes"], ["pod16x16", "pod2x16x16"])):
        with pytest.raises(SystemExit) as e:
            dryrun.main(common + flags)
        assert e.value.code == 0
        for tag in tags:
            with open(tmp_path / f"glm4-9b__decode_32k__{tag}.json") as f:
                rec = json.load(f)
            assert rec["status"] == "ok" and rec["mesh"] == tag
            assert rec["roofline"]["coll_bytes"] > 0
    assert not (tmp_path / "glm4-9b__decode_32k__h100x1.json").exists()
    with pytest.raises(ValueError, match="unknown mesh"):
        dryrun.run_cell("glm4-9b", "decode_32k", False, str(tmp_path), device="cpu",
                        mesh="pod4x4")


def _jax_init(arch):
    jcfg = j_get_config(arch, reduced=True)
    params, _ = j_model.build(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, params


def _lm_batch(seed, b=4, s=16, vocab=256):
    """tokens, labels and a loss mask with about a fifth of it off."""
    rng = np.random.default_rng(seed)
    tokens, labels = (rng.integers(0, vocab, (b, s)).astype(np.int32) for _ in range(2))
    return tokens, labels, (rng.random((b, s)) < 0.8).astype(np.float32)


def _port_loss_and_grads(mdl, module, batch):
    logits, aux = mdl.apply(module, batch, mode="train")
    loss = train_loop.lm_loss(logits, batch["labels"], batch["loss_mask"])[0] + aux
    names, params = zip(*module.named_parameters())
    return logits.detach(), aux.detach(), loss.detach(), \
        dict(zip(names, torch.autograd.grad(loss, params)))


def _assert_loss_and_grads(got, loss, grads):
    """The reference's tolerances: the loss within 1e-4 relative, every
    gradient within atol 3e-4 / rtol 3e-3."""
    assert abs(float(got["loss"]) - float(loss)) < 1e-4 * max(abs(float(loss)), 1)
    assert set(got["grads"]) == set(grads)
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), np.asarray(grads[name]), atol=3e-4,
                                   rtol=3e-3, err_msg=name)


def test_expert_parallel_moe_matches_the_dense_moe_and_the_reference(tmp_path):
    """On a 2 x 4 gloo world: the EP forward against the reference and the
    port's dense MoE on one device (atol/rtol 3e-4, aux within 1e-6), its
    train loss (the vocab-parallel ``lm_loss``) and gradients against the
    dense MoE's, the ``gspmd`` forward (gathered tokens), and a decode
    step over a sequence-sharded cache, logits and written cache."""
    jcfg, params = _jax_init("deepseek-moe-16b")
    jcfg = jcfg.replace(capacity_factor=16.0, moe_dispatch="gspmd")
    tokens, labels, mask = _lm_batch(0)
    ref, aux_ref = j_model.build(jcfg).apply(params, {"tokens": jnp.asarray(tokens)},
                                             mode="train")
    cfg = dryrun.get_config("deepseek-moe-16b", reduced=True).replace(
        capacity_factor=16.0, moe_dispatch="gspmd")
    module = convert.from_jax_params(cfg, params)
    mdl = model_lib.build(cfg)
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels),
             "loss_mask": torch.from_numpy(mask)}
    for p in module.parameters():
        p.requires_grad_(True)
    dense, aux_dense, loss, grads = _port_loss_and_grads(mdl, module, batch)
    caches = mdl.init_caches(4, 32, device="cpu")
    mdl.apply(module, {"tokens": batch["tokens"]}, mode="prefill", caches=caches)
    prefilled = [dict(c, k=c["k"].clone(), v=c["v"].clone()) for c in caches]
    nxt = torch.from_numpy(_lm_batch(2, s=1)[0])
    decoded, caches = mdl.apply(module, {"tokens": nxt}, mode="decode", caches=caches)
    got = torch_mesh_worker.spawn(torch_mesh_worker.ep_rank, 8, tmp_path,
                 {"params": module.state_dict(), **batch, "caches": prefilled, "next": nxt})
    logits = got["logits"].numpy()
    np.testing.assert_allclose(logits, np.asarray(ref), atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(logits, dense.numpy(), atol=3e-4, rtol=3e-4)
    assert abs(float(got["aux"]) - float(aux_ref)) < 1e-6
    assert abs(float(got["aux"]) - float(aux_dense)) < 1e-6
    _assert_loss_and_grads(got, loss, grads)
    np.testing.assert_allclose(got["logits_gspmd"].numpy(), dense.numpy(), atol=3e-4,
                               rtol=3e-4)
    np.testing.assert_allclose(got["logits_decode"].numpy(), decoded.numpy(), atol=3e-4,
                               rtol=3e-4)
    for mine, want in zip(got["caches"], caches):
        for key in ("k", "v"):
            np.testing.assert_allclose(mine[key].numpy(), want[key].numpy(), atol=3e-4,
                                       rtol=3e-4)


def test_slstm_on_the_local_shard_matches_one_device(tmp_path):
    """On a 4 x 2 gloo world, xlstm's train loss (the vocab-parallel
    ``lm_loss``) and every gradient against the reference's on one
    device."""
    jcfg, params = _jax_init("xlstm-125m")
    tokens, labels, mask = _lm_batch(1)
    mdl = j_model.build(jcfg)

    def loss(p, b):
        logits, _ = mdl.apply(p, b, mode="train")
        return j_train_loop.lm_loss(logits, b["labels"], b["loss_mask"])[0]

    batch = {"tokens": tokens, "labels": labels, "loss_mask": mask}
    ref_l, ref_g = jax.jit(jax.value_and_grad(loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = dryrun.get_config("xlstm-125m", reduced=True)
    module = convert.from_jax_params(cfg, params)
    got = torch_mesh_worker.spawn(torch_mesh_worker.slstm_rank, 8, tmp_path,
                 {"params": module.state_dict(),
                  **{k: torch.from_numpy(v) for k, v in batch.items()}})
    _assert_loss_and_grads(got, ref_l, convert.named_arrays(cfg, ref_g))
