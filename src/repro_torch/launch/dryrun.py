"""Dry run on one card: trace every (arch x shape) cell's step without
allocating, and record its memory, FLOPs and roofline.

The reference lowers and compiles each cell for a 256- or 512-chip TPU
mesh against ShapeDtypeStructs.  The port targets one H100 (mesh tag
``h100x1``), and PyTorch compiles nothing ahead of time: each cell's step
(``train_loop.make_train_step``'s for train shapes, ``model.apply`` in
prefill or decode mode for the others) runs once on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``) on ``device``: the
card's own dispatch on ``cuda`` (the attention kernels' fake
implementations, ``kernels/flash_attention/ops``), the plain versions'
on ``cpu``.  Nothing is allocated and nothing launches.  Over that trace
``FlopCounterMode`` counts the FLOPs and ``PeakBytes`` the peak of live
bytes: every storage of the step's inputs (parameters, moments, batch,
caches) and of what its ops create, freed when the last tensor on it
dies, each rounded up to the caching allocator's 512 B blocks, plus what
a kernel launch allocates and frees inside (``ops.launch_scratch_bytes``).

The record keeps the reference's keys, so ``analysis/report`` renders it:
``memory_analysis.argument_size_in_bytes`` is the inputs' bytes and
``temp_size_in_bytes`` the peak less those; ``t_lower_s`` is the trace's
seconds and ``t_compile_s`` 0.0 (nothing compiles); ``raw_cost_analysis``
holds ``FlopCounterMode``'s counts by op and ``counted_flops`` their
total; ``roofline`` prices ``analysis/costmodel``'s FLOPs and bytes at the
card's peaks (``analysis/roofline``), one chip, no collective.  Beside
them, ``fits_device_memory`` says whether the peak fits the card's memory.
On the CPU build no fake ``cuda`` tensor may be made (the process aborts),
so tests pass ``--device cpu``.

The production meshes (a fake process group, DTensor, the LM's sharding
rules, ``launch/shardings``) wait for ROADMAP queue 1 item 17.5:
``--multi-pod`` and ``--both-meshes`` are refused.

A trace costs the host about half a millisecond an op whatever the
shapes, so a cell's seconds follow its op count: xlstm-125m's sLSTM runs
a Python loop over time, and its train_4k and prefill_32k cells take tens
of minutes.  ``--jobs N`` traces N cells at once, each in its own process.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--out experiments/dryrun] [--device cpu] [--jobs 8]
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time
import traceback
import weakref
from concurrent.futures import ProcessPoolExecutor

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import costmodel
from repro_torch.analysis import roofline as rl
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES, ShapeConfig, shape_applicable
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import specs
from repro_torch.models import model as model_lib
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_loop

ASSIGNED = [a for a in ARCHS if a != "tspm-mlho"]
MESH = "h100x1"
ALLOC_BLOCK = 512        # the CUDA caching allocator rounds every block up to this
MESHES_NOT_PORTED = ("the production meshes (a fake process group, DTensor, "
                     "launch/shardings) wait for ROADMAP.md queue 1 item 17.5; "
                     "the port's dry run is one card (h100x1)")


class PeakBytes(TorchDispatchMode):
    """Live and peak bytes of the storages the ops under it create, beside
    those of the tensors ``hold`` is given; a storage counts once, rounded
    up to ``ALLOC_BLOCK``, until it dies.  A kernel launch's own scratch
    (``ops.launch_scratch_bytes``) counts at the launch."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._seen: set[int] = set()

    def _add(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return 0
        n = -(-st.nbytes() // ALLOC_BLOCK) * ALLOC_BLOCK
        self._seen.add(key)
        self.live += n
        weakref.finalize(st, self._free, key, n)
        return n

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

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
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t)
        self.peak = max(self.peak, self.live + flash_ops.launch_scratch_bytes(func, args))
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


def lower_cell(arch: str, shape_name, fake_mode: FakeTensorMode, device="cuda",
               overrides: dict | None = None, microbatches: int = 1):
    """-> ``(step, args, cfg, shape)``: the cell's step function and its
    inputs, made as fake tensors on ``device`` under ``fake_mode``
    (``shape_name`` names one of ``SHAPES`` or is a ``ShapeConfig``)."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = _shape(shape_name)
    mdl = model_lib.build(cfg)
    with fake_mode:
        if shape.kind == "train":
            state = _abstract_state(mdl, device)
            batch = specs.train_batch(cfg, shape, device=device)
            step = train_loop.make_train_step(mdl, opt_lib.OptConfig(),
                                              microbatches=microbatches)
            return step, (state, batch), cfg, shape
        params, _ = model_lib.abstract_init(mdl, device)
        caches = specs.cache_specs(cfg, shape, mdl, device)
        if shape.kind == "prefill":
            batch = specs.train_batch(cfg, shape, device=device)
            batch.pop("labels")
            batch.pop("loss_mask")
        else:
            batch = specs.decode_batch(cfg, shape, device=device)
    mode = shape.kind

    def serve_step(params, batch, caches):
        return mdl.apply(params, batch, mode=mode, caches=caches)

    return serve_step, (params, batch, caches), cfg, shape


def trace_cell(arch: str, shape_name, device="cuda", overrides: dict | None = None,
               microbatches: int = 1) -> dict:
    """Run the cell's step once on fake tensors -> its counts:
    ``argument_bytes``, ``peak_bytes``, ``flops`` (FlopCounterMode's
    total), ``flops_by_op``, ``trace_s``, ``cfg`` and ``shape``."""
    fake = FakeTensorMode()
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
            "trace_s": trace_s, "cfg": cfg, "shape": shape}


def device_memory(device) -> int:
    """The card's memory (``total_memory``); ``roofline.HBM_BYTES`` off it."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(model_lib.resolve_device(device))
                   .total_memory)
    return int(rl.HBM_BYTES)


def run_cell(arch: str, shape_name, multi_pod: bool, out_dir: str, skip_existing=False,
             overrides: dict | None = None, microbatches: int = 1, tag: str = "",
             device="cuda") -> dict:
    if multi_pod:
        raise NotImplementedError(MESHES_NOT_PORTED)
    shape = _shape(shape_name)
    name = f"{arch}__{shape.name}__{MESH}" + (f"__{tag}" if tag else "")
    path = os.path.join(out_dir, name + ".json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    rec = {"arch": arch, "shape": shape.name, "mesh": MESH, "device": str(device),
           "tag": tag, "overrides": overrides or {}, "microbatches": microbatches}
    if not shape_applicable(cfg, shape):
        rec["status"] = "skipped-by-rule"
        rec["reason"] = "full-attention arch: long_500k requires " \
                        "sub-quadratic sequence mixing (configs/base.shape_applicable)"
        _write(path, rec)
        return rec
    try:
        t = trace_cell(arch, shape, device, overrides, microbatches)
        total, active = rl.count_params(cfg)
        embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
        temp = t["peak_bytes"] - t["argument_bytes"]
        roof = rl.Roofline(
            arch=arch, shape=shape.name, chips=1,
            hlo_flops=costmodel.step_flops(cfg, shape),
            hlo_bytes=costmodel.step_bytes(cfg, shape, active),
            coll_bytes=0.0, coll_breakdown={},
            model_flops=rl.model_flops(cfg, shape, active, embed),
            bytes_per_device=temp)
        mem = device_memory(device)
        rec.update(status="ok", t_lower_s=t["trace_s"], t_compile_s=0.0,
                   params_total=total, params_active=active,
                   memory_analysis={"argument_size_in_bytes": t["argument_bytes"],
                                    "temp_size_in_bytes": temp,
                                    "peak_size_in_bytes": t["peak_bytes"]},
                   device_memory_bytes=mem, fits_device_memory=t["peak_bytes"] <= mem,
                   roofline=roof.row(),
                   raw_cost_analysis=dict(t["flops_by_op"], flops=t["flops"]),
                   counted_flops=t["flops"])
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
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
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
    if args.multi_pod or args.both_meshes:
        ap.error(MESHES_NOT_PORTED)

    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    overrides = _parse_overrides(args.set)

    cells = [(arch, shape_name, False, args.out, args.skip_existing, overrides,
              args.microbatches, args.tag, args.device)
             for arch in archs for shape_name in shapes]
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
        if status == "FAILED":
            n_fail += 1
            extra = " " + rec["error"][:160]
        print(f"[{rec['mesh']}] {rec['arch']} x {rec['shape']}: {status}{extra}", flush=True)
    print(f"dry-run complete; failures: {n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
