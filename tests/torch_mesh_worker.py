"""Ranks of the spawned ``gloo`` worlds of tests/test_torch_dryrun_mesh.py,
tests/test_torch_distributed.py and tests/test_torch_compression.py.

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
import torch.multiprocessing as tmp
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import gloo_cuda_all_gather, make_test_mesh
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.training import train_loop
from repro_torch.training.optimizer import OptState


def spawn(fn, world, tmp_path, data):
    """Run ``fn`` on ``world`` spawned ranks, with ``data`` (saved for
    them in ``tmp_path``, the rendezvous file's directory too); -> what
    rank 0 saved."""
    in_path, out_path = str(tmp_path / "in.pt"), str(tmp_path / "out.pt")
    torch.save(data, in_path)
    tmp.start_processes(fn, args=(world, str(tmp_path / "rendezvous"), in_path, out_path),
                        nprocs=world, start_method="spawn")
    return torch.load(out_path)


def _join(rank, world, init_file):
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)


def _specs(module) -> dict:
    """Each parameter's logical spec, by ``named_parameters()``'s name."""
    specs = layers.param_specs(module)
    return {n: specs[n] for n, _ in module.named_parameters()}


def _placed_model(cfg, state_dict, mesh, grad=False):
    module = model_lib.MODULES[cfg.family](cfg, "cpu")
    module.load_state_dict(state_dict)
    named = dict(module.named_parameters())
    for p in named.values():
        p.requires_grad_(grad)
    return sharding.distribute_module(
        module, sharding.param_shardings(mesh, _specs(module), named))


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


def model_rank(rank, world, init_file, in_path, out_path):
    """The reference's three model scenarios of tests/test_distributed.py,
    one after the other in one world of 8 ranks:

    * DP gradients: tspm-mlho (reduced) on a 4 x 2 mesh, the batch placed
      by ``pipeline.shard_batch``: the loss of ``make_loss_fn`` and every
      parameter's gradient, gathered;
    * TP forward: gemma2-2b (reduced, FSDP on) on a 2 x 4 mesh: the
      train-mode logits, gathered;
    * elastic reshard: the parent's tspm-mlho train state placed on the
      4 x 2 mesh (``elastic.reshard``), saved (``checkpoint.save``: rank 0
      writes), restored into the plain tree and placed on the 2 x 2 mesh
      of ranks 0-3; ranks 4-7 must hold no shard of it, and ranks 0-3
      gather it.

    Rank 0 saves what it gathered, with the ranks of the last mesh."""
    from repro_torch.data import pipeline
    from repro_torch.training import checkpoint, elastic

    _join(rank, world, init_file)
    try:
        data = torch.load(in_path)
        out = {}
        cfg = get_config("tspm-mlho", reduced=True)
        mesh = make_test_mesh((4, 2), ("data", "model"), device="cpu")
        module = _placed_model(cfg, data["mlho_params"], mesh, grad=True)
        batch = pipeline.shard_batch(data["dp_batch"], mesh)
        with sharding.axis_rules(mesh):
            loss, _ = train_loop.make_loss_fn(model_lib.build(cfg))(module, batch)
            names, params = zip(*module.named_parameters())
            grads = torch.autograd.grad(loss, params)
        out["dp"] = {"loss": _full(loss).detach(),
                     "grads": {n: _full(g) for n, g in zip(names, grads)}}

        gcfg = get_config("gemma2-2b", reduced=True).replace(fsdp=True)
        mesh = make_test_mesh((2, 4), ("data", "model"), device="cpu")
        module = _placed_model(gcfg, data["gemma_params"], mesh)
        batch = pipeline.shard_batch({"tokens": data["tp_tokens"]}, mesh)
        with sharding.axis_rules(mesh), torch.no_grad():
            logits, _ = model_lib.build(gcfg).apply(module, batch, mode="train")
        out["tp"] = _full(logits)

        st = data["state"]          # a dict: torch.load takes no NamedTuple
        state = train_loop.TrainState(st["params"], OptState(st["mu"], st["nu"], st["step"]))
        sp = train_loop.state_pspecs(_specs(model_lib.MODULES[cfg.family](cfg, "cpu")))
        big = make_test_mesh((4, 2), ("data", "model"), device="cpu")
        small = make_test_mesh((2, 2), ("data", "model"), device="cpu", ranks=range(4))
        st_big = elastic.reshard(state, big, sp)
        checkpoint.save(data["ckpt_dir"], 0, st_big)
        restored, _ = checkpoint.restore(checkpoint.latest(data["ckpt_dir"]), state)
        st_small = elastic.reshard(restored, small, sp)
        leaves = tree_leaves(st_small)
        assert all(isinstance(x, DTensor) and x.device_mesh is small for x in leaves)
        if rank >= 4:
            assert small.get_coordinate() is None
            assert all(x.to_local().numel() == 0 for x in leaves), rank
        else:
            out["elastic"] = dict(zip(("params", "mu", "nu", "step"),
                                      (st_small.params, *st_small.opt)))
            out["elastic"] = tree_map(_full, out["elastic"])
            out["elastic_ranks"] = small.mesh.flatten().tolist()
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def compression_screen_rank(rank, world, init_file, in_path, out_path):
    """The reference's compression and hash-screen scenarios in one world
    of 8 ranks:

    * parity: ``compressed_psum_mean`` of the parent's seeded ``[8, 16]``
      rows over a ``('pod',)`` mesh, a row a rank, without and with an
      error buffer (``sharding.local_call``): each rank's mean and new
      error, gathered by rank;
    * the convergence drill: 300 steps of the distributed least squares
      with the int8 mean and error feedback kept on each rank; the final
      MSE;
    * the sharded hash screen: the parent's mined ``[P, T]`` rows sharded
      by patient over a ``('data',)`` mesh, screened with one all-reduce
      of the bucket table (``screen_hash(..., axis_names=('data',))``);
      the keep mask, gathered."""
    from repro_torch.core import sparsity
    from repro_torch.distributed.compression import compressed_psum_mean

    _join(rank, world, init_file)
    try:
        data = torch.load(in_path)
        out = {}
        pod = make_test_mesh((world,), ("pod",), device="cpu")
        row = P("pod", None)
        g, e = (sharding.distribute(data[k], NamedSharding(pod, row)) for k in ("g", "e"))
        n, d = data["g"].shape
        with sharding.axis_rules(pod):
            for key, args in (("plain", (g,)), ("err", (g, e))):
                mean, err = sharding.local_call(
                    lambda g, e=None: tuple(t[None] for t in compressed_psum_mean(
                        g[0], "pod", None if e is None else e[0])),
                    args, (row,) * len(args), (row, row), ((n, d), (n, d)))
                out[key] = (_full(mean), _full(err))

            X, y = data["X"], data["y"]
            Xd, yd = (sharding.distribute(t, NamedSharding(pod, P("pod", *([None] * (t.ndim - 1)))))
                      for t in (X, y))
            err = sharding.distribute(torch.zeros(world, X.shape[1]), NamedSharding(pod, row))

            def step(w, Xs, ys, err):
                pred = Xs @ w
                g = 2 * Xs.T @ (pred - ys) / ys.numel()
                g_mean, new_err = compressed_psum_mean(g, "pod", err[0])
                return g_mean, new_err[None]      # error feedback stays shard-local

            w = torch.zeros(X.shape[1])
            for _ in range(300):
                g_mean, err = sharding.local_call(
                    step, (w, Xd, yd, err), (None, P("pod", None), P("pod"), row),
                    (P(None), row), ((X.shape[1],), (world, X.shape[1])))
                w = w - 0.1 * g_mean.to_local()
            out["mse"] = float(((X @ w - y) ** 2).mean())

        data_mesh = make_test_mesh((world,), ("data",), device="cpu")
        spec = P("data", None)
        seq, mask = (sharding.distribute(data[k], NamedSharding(data_mesh, spec))
                     for k in ("seq", "mask"))
        with sharding.axis_rules(data_mesh):
            keep = sharding.local_call(
                lambda s, m: sparsity.screen_hash(s, m, data["threshold"],
                                                  n_buckets_log2=data["H"],
                                                  axis_names=("data",)),
                (seq, mask), (spec, spec), spec, tuple(data["seq"].shape))
        out["keep"] = _full(keep)
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def card_dp_rank(rank, world, init_file, in_path, out_path):
    """tspm-mlho (full widths, the parent's layers) on a ``(1, world)``
    ``('data', 'model')`` mesh whose ranks all use ``cuda:0``: the batch
    placed by ``pipeline.shard_batch``, the loss of ``make_loss_fn`` and
    every gradient; each rank's attention launches, forward and backward,
    must not be zero.  Rank 0 saves the loss and the gathered gradients."""
    from repro_torch.data import pipeline
    from repro_torch.kernels.flash_attention import ops as flash_ops

    torch.cuda.set_device(0)
    all_gather = gloo_cuda_all_gather()   # noqa: F841 (registered while it lives)
    _join(rank, world, init_file)
    try:
        data = torch.load(in_path)
        cfg = get_config("tspm-mlho").replace(n_layers=data["layers"])
        mesh = make_test_mesh((1, world), ("data", "model"), device="cuda")
        module = _placed_model(cfg, data["params"], mesh, grad=True)
        batch = pipeline.shard_batch(data["batch"], mesh)
        fwd, bwd = flash_ops.attention.launches, flash_ops.attention_bwd.launches
        with sharding.axis_rules(mesh):
            loss, _ = train_loop.make_loss_fn(model_lib.build(cfg))(module, batch)
            names, params = zip(*module.named_parameters())
            grads = torch.autograd.grad(loss, params)
        launches = (flash_ops.attention.launches - fwd, flash_ops.attention_bwd.launches - bwd)
        assert min(launches) > 0, (rank, launches)
        out = {"loss": _full(loss.detach()).cpu(),
               "grads": {n: _full(g).cpu() for n, g in zip(names, grads)}}
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()
