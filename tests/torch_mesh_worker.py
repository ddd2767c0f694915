"""Ranks of the spawned ``gloo`` worlds of tests/test_torch_dryrun_mesh.py.

Each function runs in one spawned process: it joins the world through a
``file://`` rendezvous (no port to collide with under xdist), builds the
reference's test mesh (``launch/mesh.make_test_mesh``) over it, places the
parameters the parent saved as DTensors by their sanitized specs and the
batch on 'data', runs the model under ``axis_rules``, and rank 0 saves
the gathered results for the parent to compare.  Only ``torch`` and
``repro_torch`` are imported here.
"""
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.training import train_loop


def _join(rank, world, init_file):
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)


def _placed_model(cfg, state_dict, mesh, grad=False):
    module = model_lib.MODULES[cfg.family](cfg, "cpu")
    module.load_state_dict(state_dict)
    named = dict(module.named_parameters())
    specs = layers.param_specs(module)
    for p in named.values():
        p.requires_grad_(grad)
    return sharding.distribute_module(
        module, sharding.param_shardings(mesh, {n: specs[n] for n in named}, named))


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _batch(data, mesh, *keys):
    return {k: sharding.distribute(data[k], NamedSharding(mesh, P("data", None)))
            for k in keys}


def _loss_and_grads(module, cfg, batch):
    """``lm_loss`` (vocab-parallel on the mesh) plus the aux loss, and every
    parameter's gradient, gathered."""
    logits, aux = model_lib.build(cfg).apply(module, batch, mode="train")
    loss = train_loop.lm_loss(logits, batch["labels"], batch["loss_mask"])[0] + aux
    names, params = zip(*module.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return {"logits": _full(logits).detach(), "aux": _full(aux).detach(),
            "loss": _full(loss).detach(), "grads": {n: _full(g) for n, g in zip(names, grads)}}


def ep_rank(rank, world, init_file, in_path, out_path):
    """deepseek-moe-16b (reduced, capacity 16, FSDP on) on a 2 x 4 mesh.
    Its MoE layers take ``apply_shard_map``: rank 0 saves the logits, the
    aux loss, the train loss and every gradient; then the logits of a
    forward under ``moe_dispatch="gspmd"`` (the gathered tokens), and of
    one decode step over the parent's prefilled caches placed by
    ``cache_pspecs`` (``decode_kv_shard="seq"``: the sequence on 'model'),
    with the caches it wrote."""
    _join(rank, world, init_file)
    try:
        data = torch.load(in_path)
        cfg = get_config("deepseek-moe-16b", reduced=True).replace(
            capacity_factor=16.0, moe_dispatch="shard_map_ep", fsdp=True,
            decode_kv_shard="seq")
        mesh = make_test_mesh((2, 4), ("data", "model"), device="cpu")
        module = _placed_model(cfg, data["params"], mesh, grad=True)
        batch = _batch(data, mesh, "tokens", "labels", "loss_mask")
        with sharding.axis_rules(mesh):
            out = _loss_and_grads(module, cfg, batch)
            with torch.no_grad():
                gspmd = cfg.replace(moe_dispatch="gspmd")
                out["logits_gspmd"] = _full(model_lib.build(gspmd).apply(
                    module, {"tokens": batch["tokens"]}, mode="train")[0])
            caches = data["caches"]
            caches = sharding.distribute_tree(caches, sh.to_shardings(
                mesh, sh.cache_pspecs(cfg, caches, mesh), caches))
            logits, caches = model_lib.build(cfg).apply(
                module, {"tokens": _batch(data, mesh, "next")["next"]}, mode="decode",
                caches=caches)
        out["logits_decode"] = _full(logits)
        out["caches"] = [{k: _full(c[k]) for k in ("k", "v")} for c in caches]
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def slstm_rank(rank, world, init_file, in_path, out_path):
    """xlstm-125m (reduced) on a 4 x 2 mesh: its sLSTM takes the local
    scan; rank 0 saves the train loss (``lm_loss``) and every parameter's
    gradient."""
    _join(rank, world, init_file)
    try:
        data = torch.load(in_path)
        cfg = get_config("xlstm-125m", reduced=True)
        mesh = make_test_mesh((4, 2), ("data", "model"), device="cpu")
        module = _placed_model(cfg, data["params"], mesh, grad=True)
        with sharding.axis_rules(mesh):
            out = _loss_and_grads(module, cfg,
                                  _batch(data, mesh, "tokens", "labels", "loss_mask"))
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()
