"""Sharded execution on real process groups, on the CPU: the reference's
model scenarios of tests/test_distributed.py, and the pieces they stand on.

* In one spawned 8-rank ``gloo`` world (``torch_mesh_worker.model_rank``):
  DP gradients (tspm-mlho reduced, the batch placed by
  ``pipeline.shard_batch``, a 4 x 2 mesh) against the reference's
  unsharded ``value_and_grad`` of ``make_loss_fn`` (the loss within 1e-4,
  every gradient within atol 2e-4); the TP forward (gemma2-2b reduced with
  FSDP, a 2 x 4 mesh) against the reference's unsharded train-mode logits
  (atol = rtol = 2e-4); the elastic drill (the train state resharded onto
  4 x 2, saved, restored and resharded onto the 2 x 2 mesh of ranks 0-3)
  byte-equal to the reference's unsharded state.  These are the
  reference's configs, meshes, batches and tolerances; its sharded halves
  do not run under jax 0.9.0, its unsharded halves do.
* In one process (a one-rank ``gloo`` group where a mesh is needed):
  ``shard_batch``'s specs and local shapes, ``checkpoint.save`` of a plain
  tree in the reference's bytes, and a sharded tree's checkpoint equal to
  the plain tree's.
"""
import os
import zipfile

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils._pytree import tree_leaves

import torch_mesh_worker
from repro.configs import get_config as j_get_config
from repro.models import model as j_model
from repro.training import checkpoint as j_ckpt
from repro.training import train_loop as j_train_loop
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import convert
from repro_torch.training import checkpoint, elastic, train_loop

WORLD = 8


def _dp_batch():
    rng = np.random.default_rng(0)
    tokens = rng.integers(4, 64, (8, 16)).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, 1),
            "loss_mask": np.ones((8, 16), bool)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's results on one device, and what rank 0 of the
    8-rank world gathered."""
    tmp = tmp_path_factory.mktemp("model_world")
    ref = {}
    jcfg = j_get_config("tspm-mlho", reduced=True)
    mdl = j_model.build(jcfg)
    params, _ = mdl.init(jax.random.PRNGKey(0))
    loss_fn = j_train_loop.make_loss_fn(mdl)
    batch = _dp_batch()
    ref["dp_loss"], grads = jax.value_and_grad(lambda p, b: loss_fn(p, b)[0])(
        params, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    cfg = get_config("tspm-mlho", reduced=True)
    ref["dp_grads"] = convert.named_arrays(cfg, grads)
    data = {"mlho_params": convert.from_jax_params(cfg, params).state_dict(),
            "dp_batch": {k: torch.from_numpy(v) for k, v in batch.items()}}

    gjcfg = j_get_config("gemma2-2b", reduced=True).replace(fsdp=True)
    gmdl = j_model.build(gjcfg)
    gparams, _ = gmdl.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, 256, (4, 32)).astype(np.int32)
    ref["tp"] = np.asarray(gmdl.apply(gparams, {"tokens": jax.numpy.asarray(tokens)},
                                      mode="train")[0])
    gcfg = get_config("gemma2-2b", reduced=True).replace(fsdp=True)
    data["gemma_params"] = convert.from_jax_params(gcfg, gparams).state_dict()
    data["tp_tokens"] = torch.from_numpy(tokens)

    jstate, _ = j_train_loop.init_state(mdl, jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, jstate)
    ref["state"] = {"params": convert.named_arrays(cfg, host.params),
                    "mu": convert.named_arrays(cfg, host.opt.mu),
                    "nu": convert.named_arrays(cfg, host.opt.nu), "step": host.opt.step}
    tree = train_loop.state_tree(train_loop.from_jax_train_state(cfg, host))
    data["state"] = dict(zip(("params", "mu", "nu", "step"), (tree.params, *tree.opt)))
    data["ckpt_dir"] = str(tmp / "ckpt")
    return ref, torch_mesh_worker.spawn(torch_mesh_worker.model_rank, WORLD, tmp, data)


def test_data_parallel_grads_match_the_references_single_device(world):
    ref, got = world
    assert abs(float(got["dp"]["loss"]) - float(ref["dp_loss"])) < 1e-4
    assert set(got["dp"]["grads"]) == set(ref["dp_grads"])
    for name, g in got["dp"]["grads"].items():
        np.testing.assert_allclose(g.numpy(), ref["dp_grads"][name], atol=2e-4,
                                   err_msg=name)


def test_tp_sharded_forward_matches_the_references_replicated(world):
    ref, got = world
    np.testing.assert_allclose(got["tp"].numpy(), ref["tp"], atol=2e-4, rtol=2e-4)


def test_elastic_reshard_across_meshes_is_byte_equal(world):
    ref, got = world
    assert got["elastic_ranks"] == [0, 1, 2, 3]
    for part in ("params", "mu", "nu"):
        assert set(got["elastic"][part]) == set(ref["state"][part])
        for name, t in got["elastic"][part].items():
            want = np.ascontiguousarray(ref["state"][part][name])
            assert t.numpy().dtype == want.dtype and t.numpy().tobytes() == want.tobytes(), \
                (part, name)
    step = got["elastic"]["step"]
    assert step.dtype == torch.int32 and int(step) == int(ref["state"]["step"])


# ---- one process -------------------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    """A one-rank ``gloo`` default group for the test, torn down after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape,axes,placements", [
    ((1, 1), ("data", "model"), (Shard(0), Replicate())),
    ((1, 1, 1), ("pod", "data", "model"), (Shard(0), Shard(0), Replicate())),
    ((1,), ("model",), (Replicate(),)),
])
def test_shard_batch_shards_the_leading_dim_over_the_batch_axes(one_rank, shape, axes,
                                                                placements):
    mesh = make_test_mesh(shape, axes, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 64, (8, 16)).astype(np.int32),
             "loss_mask": rng.random((8, 16)) < 0.5,
             "patch_embeds": rng.standard_normal((8, 4, 3)).astype(np.float32)}
    out = pipeline.shard_batch(batch, mesh)
    assert set(out) == set(batch)
    for k, v in out.items():
        assert isinstance(v, DTensor) and v.device_mesh is mesh
        assert tuple(v.placements) == placements
        assert tuple(v.to_local().shape) == batch[k].shape
        np.testing.assert_array_equal(v.full_tensor().numpy(), batch[k])


def _members(path) -> dict:
    """A checkpoint's bytes: the manifest, and each array of the ``.npz``
    (its zip headers carry the write time)."""
    with open(os.path.join(path, "manifest.json"), "rb") as f:
        out = {"manifest.json": f.read()}
    with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as z:
        out.update({n: z.read(n) for n in z.namelist()})
    return out


def _plain_tree(rng):
    return {"w": torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)),
            "b": [torch.arange(8, dtype=torch.int64), torch.tensor(3, dtype=torch.int32)],
            "m": np.ones((2, 3), np.float64)}


def test_checkpoint_of_a_plain_tree_is_the_references_bytes(tmp_path):
    """A plain tree in one process without a process group writes what
    the reference writes for the same host tree, array for array."""
    tree = _plain_tree(np.random.default_rng(0))
    mine = checkpoint.save(str(tmp_path / "port"), 5, tree, {"note": "x"})
    host = jax.tree_util.tree_map(lambda x: np.asarray(x), tree)
    theirs = j_ckpt.save(str(tmp_path / "ref"), 5, host, {"note": "x"})
    assert _members(mine) == _members(theirs)
    assert not dist.is_initialized()


def test_checkpoint_of_a_sharded_tree_is_the_plain_trees(one_rank, tmp_path):
    """DTensor leaves are gathered: ``save`` and ``save_async`` write the
    plain tree's bytes, ``restore`` fills a plain tree, and ``reshard``
    places it back on the mesh."""
    mesh = make_test_mesh((1, 1), ("data", "model"), device="cpu")
    tree = _plain_tree(np.random.default_rng(1))
    specs = {"w": ("data", "model"), "b": [("data",), ()], "m": ("model", None)}
    sharded = elastic.reshard(tree, mesh, specs)
    assert all(isinstance(x, DTensor) for x in (sharded["w"], *sharded["b"], sharded["m"]))
    plain = checkpoint.save(str(tmp_path / "plain"), 1, tree)
    assert _members(checkpoint.save(str(tmp_path / "sharded"), 1, sharded)) == _members(plain)
    saver = checkpoint.Saver()
    saver.save_async(str(tmp_path / "async"), 1, sharded)
    saver.wait()
    assert _members(os.path.join(tmp_path / "async", "step_00000001")) == _members(plain)
    restored, _ = checkpoint.restore(checkpoint.latest(str(tmp_path / "sharded")), tree)
    again = elastic.reshard(restored, mesh, specs)
    for a, b in zip(tree_leaves(again), tree_leaves(sharded)):
        assert a.placements == b.placements
        assert torch.equal(a.full_tensor(), b.full_tensor())
