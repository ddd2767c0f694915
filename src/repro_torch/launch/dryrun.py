"""Dry run: trace every (arch x shape) cell's step without allocating, on
one card or on the reference's production meshes, and record its memory,
FLOPs, collectives and roofline.

The reference lowers and compiles each cell for a 256- or 512-chip TPU
mesh against ShapeDtypeStructs.  PyTorch compiles nothing ahead of time:
each cell's step (``train_loop.make_train_step``'s for train shapes,
``model.apply`` in prefill or decode mode for the others) runs once on
fake tensors (``torch._subclasses.fake_tensor.FakeTensorMode``) on
``device``: the card's own dispatch on ``cuda`` (the attention kernels'
fake implementations, ``kernels/flash_attention/ops``), the plain
versions' on ``cpu``.  Nothing is allocated and nothing launches.

Meshes (``mesh=``, one of ``MESHES``):

* ``h100x1`` (the default): one card.  ``FlopCounterMode`` counts the
  FLOPs and ``PeakBytes`` the peak of live bytes: every storage of the
  step's inputs (parameters, moments, batch, caches) and of what its ops
  create, freed when the last tensor on it dies, each rounded up to the
  caching allocator's 512 B blocks, plus what a kernel launch allocates
  and frees inside (``ops.launch_scratch_bytes``).
* ``pod16x16`` and ``pod2x16x16``: the reference's production meshes
  (``launch/mesh.make_production_mesh``: a ``DeviceMesh`` over a fake
  process group of 256 or 512 ranks, this process rank 0).  Parameters,
  moments, batch and caches are DTensors placed by the reference's rules
  (``distributed/sharding``, ``launch/shardings``,
  ``train_loop.state_pspecs``; parameters through ``sanitize_pspec``),
  holding fake tensors; the step runs under ``axis_rules`` (batch over
  every axis without ``tp_internals``, ``seq_res`` on 'model' under
  ``sp_residual``), where DTensor's implicit replication takes the step's
  own plain tensors (positions, masks) as replicated.  ``RankCounts``
  then sees rank 0's local ops only: its peak bytes (local shards), its
  FLOPs (``counted_flops``, per rank) and its collectives by kind
  (``roofline.count_collective``: per-device operand bytes, the
  reference's ``collective_bytes`` convention).  Attention takes the
  card's op (``attn_impl="flash"``) on either device, with its DTensor
  sharding rules.

The record keeps the reference's keys, so ``analysis/report`` renders it:
``memory_analysis.argument_size_in_bytes`` is the inputs' bytes (a rank's
on a mesh) and ``temp_size_in_bytes`` the peak less those; ``t_lower_s``
is the trace's seconds and ``t_compile_s`` 0.0 (nothing compiles);
``raw_cost_analysis`` holds the counted FLOPs by op and
``counted_flops`` their total; ``roofline`` prices
``analysis/costmodel``'s FLOPs and bytes at the card's peaks over
``chips`` cards, and the collective bytes (rank 0's times ``chips``) at
NVLink's.  Beside them, ``fits_device_memory`` says whether the (rank's)
peak fits the card's memory.  On the CPU build no fake ``cuda`` tensor
may be made (the process aborts), so tests pass ``--device cpu``.

A trace costs the host about half a millisecond an op whatever the
shapes (DTensor adds its sharding propagation, cached per op and
layout), so a cell's seconds follow its op count: xlstm-125m's sLSTM runs
a Python loop over time (on a mesh on the local shard, as the reference's
``shard_map``), and its train_4k and prefill_32k cells take tens of
minutes.  ``--jobs N`` traces N cells at once, each in its own process.

The command line takes the reference's flags: ``--multi-pod`` traces on
``pod2x16x16``, ``--both-meshes`` on ``pod16x16`` and ``pod2x16x16``;
without either (``--all`` alone included) the cells trace on ``h100x1``.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--out experiments/dryrun] [--device cpu] [--jobs 8]
  python -m repro_torch.launch.dryrun --all --both-meshes [--jobs 8]
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import multiprocessing
import os
import sys
import time
import traceback
import weakref
from concurrent.futures import ProcessPoolExecutor

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.analysis import costmodel
from repro_torch.analysis import roofline as rl
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES, ShapeConfig, shape_applicable
from repro_torch.distributed import sharding
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardings as sh
from repro_torch.launch import specs
from repro_torch.models import model as model_lib
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_loop

ASSIGNED = [a for a in ARCHS if a != "tspm-mlho"]
MESH = "h100x1"
# mesh tag -> make_production_mesh's multi_pod (None: one card)
MESHES = {"h100x1": None, "pod16x16": False, "pod2x16x16": True}
ALLOC_BLOCK = 512        # the CUDA caching allocator rounds every block up to this


class PeakBytes(TorchDispatchMode):
    """Live and peak bytes of the storages the ops under it create, beside
    those of the tensors ``hold`` is given; a storage counts once, rounded
    up to ``ALLOC_BLOCK``, until it dies.  A kernel launch's own scratch
    (``ops.launch_scratch_bytes``) counts at the launch.  A DTensor counts
    its local shard, and an op on DTensors is left to DTensor, whose local
    ops come back here: the counts are a rank's.  A collective's
    ``wait_tensor`` hands back its input on the card, where the fake mode
    makes a new storage: that storage shares the input's bytes, which
    live until both have died."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._block: dict[int, int] = {}          # storage -> its block
        self._blocks: dict[int, list[int]] = {}   # block -> [bytes, storages on it]
        # a block's own id: a dead storage's address is reused by new ones
        # while a storage that shares its block may still live
        self._ids = itertools.count()

    @staticmethod
    def _storage(t: torch.Tensor):
        return (t.to_local() if isinstance(t, DTensor) else t).untyped_storage()

    def _add(self, t: torch.Tensor, block: int | None = None) -> int:
        st = self._storage(t)
        key = st._cdata
        if key in self._block:
            return 0
        n = 0
        if block is None:
            block = next(self._ids)
            n = -(-st.nbytes() // ALLOC_BLOCK) * ALLOC_BLOCK
            self._blocks[block] = [n, 0]
            self.live += n
        self._block[key] = block
        self._blocks[block][1] += 1
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key: int) -> None:
        block = self._block.pop(key)
        entry = self._blocks[block]
        entry[1] -= 1
        if not entry[1]:
            del self._blocks[block]
            self.live -= entry[0]

    def hold(self, tree) -> int:
        """Count the tensors of ``tree`` (and a module's parameters) as live;
        -> the bytes they add."""
        n = 0
        for leaf in tree_leaves(tree):
            tensors = leaf.parameters() if isinstance(leaf, torch.nn.Module) else [leaf]
            n += sum(self._add(t) for t in tensors if isinstance(t, torch.Tensor))
        self.peak = max(self.peak, self.live)
        return n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self._count(func, args, kwargs or {}, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        if func is torch.ops._c10d_functional.wait_tensor.default:
            block = self._block.get(self._storage(args[0])._cdata)
            if block is not None:
                self._add(out, block)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t)
        self.peak = max(self.peak, self.live + flash_ops.launch_scratch_bytes(func, args))


# DTensor derives an op's global output shape by running the op on fake
# tensors of the global shapes; those ops are not a rank's work
_PROPAGATION = frozenset({"_propagate_tensor_meta_non_cached", "_propagate_tensor_meta",
                          "gen_fake_args"})


def _in_propagation(depth: int = 12) -> bool:
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        if f.f_code.co_name in _PROPAGATION:
            return True
        f = f.f_back
    return False


class RankCounts(PeakBytes):
    """``PeakBytes`` of rank 0 on a mesh, with its FLOPs (``flops``,
    ``flops_by_op``, by ``torch.utils.flop_counter``'s formulas) and its
    collectives' per-device operand bytes by kind (``coll``,
    ``roofline.count_collective``), from the local ops DTensor issues;
    the global-shape ops of DTensor's shape propagation are left out.
    ``attention`` counts the attention forward op's calls by their local
    case (q and k shapes, dtype, mask): what the kernel would launch on."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_by_op: dict[str, int] = {}
        self.coll = dict.fromkeys(rl.COLLECTIVES, 0)
        self.attention: dict[tuple, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        self._count(func, args, kwargs, out)
        got = rl.count_collective(func, args)
        if got is not None:
            self.coll[got[0]] += got[1]
        if func is torch.ops.repro_torch.flash_attention_fwd.default:
            q, k = args[0], args[1]
            case = (tuple(q.shape), tuple(k.shape), str(q.dtype).replace("torch.", ""),
                    *args[3:6])
            self.attention[case] = self.attention.get(case, 0) + 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            self.flops += n
            key = str(func._overloadpacket)
            self.flops_by_op[key] = self.flops_by_op.get(key, 0) + n
        return out


def _abstract_state(mdl, device) -> train_loop.TrainState:
    """``train_loop.init_state``'s structure, undrawn (under a fake mode:
    fake parameters and float32 moments on ``device``)."""
    params, _ = model_lib.abstract_init(mdl, device)
    model = train_loop.trainable(params)
    return train_loop.TrainState(model, opt_lib.init(dict(model.named_parameters())))


def _parse_overrides(sets: list[str] | None) -> dict:
    out = {}
    for kv in sets or []:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "True"):
            v = True
        if v in ("false", "False"):
            v = False
        out[k] = v
    return out


def _shape(shape_name) -> ShapeConfig:
    return shape_name if isinstance(shape_name, ShapeConfig) else SHAPES[shape_name]


def mesh_rules(cfg, mesh) -> dict:
    """The reference's rules for a cell: ``default_rules``, with the batch
    over every axis when ``tp_internals`` is off and the residual's
    sequence on 'model' under ``sp_residual``."""
    rules = sharding.default_rules(mesh)
    if not cfg.tp_internals:  # pure wide-DP: batch over every axis
        rules["batch"] = sh.batch_axes_of(mesh, cfg)
    if cfg.sp_residual:
        rules["seq_res"] = "model"
    return rules


def _place(tree, specs_tree, mesh):
    """``tree``'s tensors (fake globals) as DTensors by their sanitized
    specs."""
    return sharding.distribute_tree(tree, sh.to_shardings(mesh, specs_tree, tree))


def _place_inputs(mdl, cfg, shape, mesh, device, microbatches):
    """(step, args) of a cell on ``mesh``: parameters, moments, batch and
    caches as DTensors; called under the fake mode."""
    if shape.kind == "train":
        params, pspecs = model_lib.abstract_init(mdl, device)
        model = train_loop.trainable(params)
        named = dict(model.named_parameters())
        opt = opt_lib.init(named)
        shardings = sharding.param_shardings(
            mesh, train_loop.state_pspecs(pspecs), train_loop.TrainState(named, opt))
        sharding.distribute_module(model, shardings.params)
        opt = sharding.distribute_tree(opt, shardings.opt)
        batch = specs.train_batch(cfg, shape, device=device)
        batch = _place(batch, sh.batch_pspecs(cfg, batch, mesh), mesh)
        step = train_loop.make_train_step(mdl, opt_lib.OptConfig(), microbatches=microbatches)
        return step, (train_loop.TrainState(model, opt), batch)
    params, pspecs = model_lib.abstract_init(mdl, device)
    sharding.distribute_module(params, sharding.param_shardings(
        mesh, pspecs, dict(params.named_parameters())))
    caches = specs.cache_specs(cfg, shape, mdl, device)
    caches = _place(caches, sh.cache_pspecs(cfg, caches, mesh), mesh)
    batch = _serve_batch(cfg, shape, device)
    batch = _place(batch, sh.batch_pspecs(cfg, batch, mesh), mesh)
    return _serve_step(mdl, shape), (params, batch, caches)


def _serve_batch(cfg, shape, device):
    if shape.kind == "prefill":
        batch = specs.train_batch(cfg, shape, device=device)
        batch.pop("labels")
        batch.pop("loss_mask")
        return batch
    return specs.decode_batch(cfg, shape, device=device)


def _serve_step(mdl, shape):
    mode = shape.kind

    def serve_step(params, batch, caches):
        return mdl.apply(params, batch, mode=mode, caches=caches)

    return serve_step


def lower_cell(arch: str, shape_name, fake_mode: FakeTensorMode, device="cuda",
               overrides: dict | None = None, microbatches: int = 1, mesh=None):
    """-> ``(step, args, cfg, shape)``: the cell's step function and its
    inputs, made as fake tensors on ``device`` under ``fake_mode``
    (``shape_name`` names one of ``SHAPES`` or is a ``ShapeConfig``).
    Given a ``DeviceMesh``, the inputs are DTensors over it and the step
    runs under the cell's rules (``mesh_rules``), with attention on the
    card's op."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    if mesh is not None and cfg.attn_impl == "auto":
        cfg = cfg.replace(attn_impl="flash")
    shape = _shape(shape_name)
    mdl = model_lib.build(cfg)
    if mesh is not None:
        with fake_mode:
            step, args = _place_inputs(mdl, cfg, shape, mesh, device, microbatches)
        rules = mesh_rules(cfg, mesh)

        def on_mesh(*a):
            with sharding.axis_rules(mesh, rules):
                return step(*a)

        return on_mesh, args, cfg, shape
    with fake_mode:
        if shape.kind == "train":
            state = _abstract_state(mdl, device)
            batch = specs.train_batch(cfg, shape, device=device)
            step = train_loop.make_train_step(mdl, opt_lib.OptConfig(),
                                              microbatches=microbatches)
            return step, (state, batch), cfg, shape
        params, _ = model_lib.abstract_init(mdl, device)
        caches = specs.cache_specs(cfg, shape, mdl, device)
        batch = _serve_batch(cfg, shape, device)
    return _serve_step(mdl, shape), (params, batch, caches), cfg, shape


@contextlib.contextmanager
def _fake_safe_strided_shards():
    """DTensor's ``_StridedShard`` (a dim sharded twice, as a flattened
    (batch, heads) dim is) computes its local size with ``torch.arange``,
    which under a fake mode would be fake and its ``tolist`` data
    dependent: that one computation runs on real (host) tensors."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types as pt

    cls = getattr(pt, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None) if cls else None
    if orig is None:
        yield
        return

    def real(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)

    cls.local_shard_size_and_offset = real
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


def trace_cell(arch: str, shape_name, device="cuda", overrides: dict | None = None,
               microbatches: int = 1, mesh: str = MESH) -> dict:
    """Run the cell's step once on fake tensors -> its counts:
    ``argument_bytes``, ``peak_bytes``, ``flops`` (the counted total),
    ``flops_by_op``, ``coll`` (per-device collective operand bytes by
    kind, on a mesh), ``chips``, ``trace_s``, ``cfg`` and ``shape``; on a
    production mesh every count is rank 0's, and ``attention_local`` lists
    the attention forward op's local cases (``RankCounts.attention``)."""
    if mesh not in MESHES:
        raise ValueError(f"unknown mesh {mesh!r}; expected one of {tuple(MESHES)}")
    fake = FakeTensorMode()
    if MESHES[mesh] is None:
        step, args, cfg, shape = lower_cell(arch, shape_name, fake, device, overrides,
                                            microbatches)
        tracker = PeakBytes()
        arg_bytes = tracker.hold(args)
        t0 = time.perf_counter()
        with fake, FlopCounterMode(display=False) as counter, tracker:
            step(*args)
        trace_s = time.perf_counter() - t0
        return {"argument_bytes": arg_bytes, "peak_bytes": tracker.peak,
                "flops": counter.get_total_flops(),
                "flops_by_op": {str(k): int(v) for k, v in
                                counter.get_flop_counts().get("Global", {}).items()},
                "coll": {}, "chips": 1, "trace_s": trace_s, "cfg": cfg, "shape": shape}
    with mesh_lib.production_mesh(multi_pod=MESHES[mesh], device=device) as dmesh:
        step, args, cfg, shape = lower_cell(arch, shape_name, fake, device, overrides,
                                            microbatches, mesh=dmesh)
        tracker = RankCounts()
        arg_bytes = tracker.hold(args)
        t0 = time.perf_counter()
        with _fake_safe_strided_shards(), fake, tracker:
            step(*args)
        trace_s = time.perf_counter() - t0
        chips = dmesh.size()
    attention = [dict(zip(("q", "k", "dtype", "causal", "window", "softcap"), case),
                      calls=n) for case, n in tracker.attention.items()]
    return {"argument_bytes": arg_bytes, "peak_bytes": tracker.peak,
            "flops": tracker.flops, "flops_by_op": tracker.flops_by_op,
            "coll": tracker.coll, "chips": chips, "trace_s": trace_s, "cfg": cfg,
            "shape": shape, "attention_local": attention}


def device_memory(device) -> int:
    """The card's memory (``total_memory``); ``roofline.HBM_BYTES`` off it."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(model_lib.resolve_device(device))
                   .total_memory)
    return int(rl.HBM_BYTES)


def run_cell(arch: str, shape_name, multi_pod: bool, out_dir: str, skip_existing=False,
             overrides: dict | None = None, microbatches: int = 1, tag: str = "",
             device="cuda", mesh: str = MESH) -> dict:
    """Trace one cell and write its record to ``out_dir``; ``mesh`` is one
    of ``MESHES`` (``multi_pod=True`` means ``pod2x16x16``, as in the
    reference)."""
    if multi_pod:
        mesh = "pod2x16x16"
    if mesh not in MESHES:
        raise ValueError(f"unknown mesh {mesh!r}; expected one of {tuple(MESHES)}")
    shape = _shape(shape_name)
    name = f"{arch}__{shape.name}__{mesh}" + (f"__{tag}" if tag else "")
    path = os.path.join(out_dir, name + ".json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh, "device": str(device),
           "tag": tag, "overrides": overrides or {}, "microbatches": microbatches}
    if not shape_applicable(cfg, shape):
        rec["status"] = "skipped-by-rule"
        rec["reason"] = "full-attention arch: long_500k requires " \
                        "sub-quadratic sequence mixing (configs/base.shape_applicable)"
        _write(path, rec)
        return rec
    try:
        t = trace_cell(arch, shape, device, overrides, microbatches, mesh)
        total, active = rl.count_params(cfg)
        embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
        temp = t["peak_bytes"] - t["argument_bytes"]
        chips = t["chips"]
        roof = rl.Roofline(
            arch=arch, shape=shape.name, chips=chips,
            hlo_flops=costmodel.step_flops(cfg, shape),
            hlo_bytes=costmodel.step_bytes(cfg, shape, active),
            coll_bytes=float(sum(t["coll"].values())) * chips, coll_breakdown=t["coll"],
            model_flops=rl.model_flops(cfg, shape, active, embed),
            bytes_per_device=temp)
        mem = device_memory(device)
        rec.update(status="ok", chips=chips, t_lower_s=t["trace_s"], t_compile_s=0.0,
                   params_total=total, params_active=active,
                   memory_analysis={"argument_size_in_bytes": t["argument_bytes"],
                                    "temp_size_in_bytes": temp,
                                    "peak_size_in_bytes": t["peak_bytes"]},
                   device_memory_bytes=mem, fits_device_memory=t["peak_bytes"] <= mem,
                   roofline=roof.row(),
                   raw_cost_analysis=dict(t["flops_by_op"], flops=t["flops"]),
                   counted_flops=t["flops"],
                   counted_flops_scope="per rank" if chips > 1 else "the card")
        if chips > 1:
            rec["attention_local"] = t["attention_local"]
    except Exception as e:  # a failing cell is a bug of the port; record it loudly
        rec.update(status="FAILED", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    _write(path, rec)
    return rec


def _write(path, rec):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true",
                    help="trace on the 2 x 16 x 16 mesh (pod2x16x16)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="trace on pod16x16 and pod2x16x16")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (perf variants)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="", help="variant tag for the record")
    ap.add_argument("--device", default="cuda",
                    help="where the fake tensors lie: cuda (the card's route) or cpu")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in its own process")
    args = ap.parse_args(argv)

    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    if args.both_meshes:
        meshes = ["pod16x16", "pod2x16x16"]
    else:
        meshes = ["pod2x16x16" if args.multi_pod else MESH]
    overrides = _parse_overrides(args.set)

    cells = [(arch, shape_name, False, args.out, args.skip_existing, overrides,
              args.microbatches, args.tag, args.device, mesh)
             for mesh in meshes for arch in archs for shape_name in shapes]
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
            futures = [pool.submit(run_cell, *cell) for cell in cells]
            recs = (f.result() for f in futures)
            _report(recs)
    else:
        _report(run_cell(*cell) for cell in cells)


def _report(recs) -> None:
    """Print a line a cell as its record comes; exit 1 if any failed."""
    n_fail = 0
    for rec in recs:
        status, extra = rec["status"], ""
        if status == "ok":
            r = rec["roofline"]
            extra = (f" dom={r['dominant']} frac={r['roofline_fraction']:.3f} "
                     f"peak={rec['memory_analysis']['peak_size_in_bytes']} "
                     f"fits={rec['fits_device_memory']} trace={rec['t_lower_s']:.1f}s")
            if rec.get("chips", 1) > 1:
                extra += f" coll={r['coll_bytes']:.3e} t_coll={r['t_collective_s']:.3e}s"
        if status == "FAILED":
            n_fail += 1
            extra = " " + rec["error"][:160]
        print(f"[{rec['mesh']}] {rec['arch']} x {rec['shape']}: {status}{extra}", flush=True)
    print(f"dry-run complete; failures: {n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
