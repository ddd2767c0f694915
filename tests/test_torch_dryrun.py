"""The port's dry run (``launch/dryrun``), ``models.abstract_init``, the
report's tables and the attention ops' binding, on the CPU.

No test here makes a fake ``cuda`` tensor: on a PyTorch built without CUDA
a view op on one aborts the process (a C++ ``terminate``, no Python
exception), which would take a test worker down.  The dry run runs on fake
``cpu`` tensors here (``device="cpu"``) and on fake ``cuda`` ones on the
card (tests/test_torch_cuda.py, chip_smoke.py phase 11).

* ``abstract_init``: every parameter on the meta device, with the
  reference's ``eval_shape`` shape and dtype under ``models/convert``'s
  name, and the reference's logical spec (its stacked-layer leading Nones
  dropped, a linear weight's two entries swapped as the weight is).
* ``run_cell`` at full size (gemma2-2b x train_4k) on one card finishes on fake
  tensors with a recorded peak far above this machine's memory, so nothing
  was allocated, and its counted FLOPs lie in the cost model's band; at a
  reduced config the fake trace counts what a real step on real tensors
  counts, op for op.
* ``report``'s tables render records as the reference's do.
* ``torch.library.opcheck`` of both attention ops on CPU tensors.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec
from torch.utils.flop_counter import FlopCounterMode

from repro.analysis import report as j_report
from repro.configs import get_config as j_get_config
from repro.models import model as j_model
from repro_torch.analysis import costmodel, report
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.launch import dryrun, specs
from repro_torch.models import convert
from repro_torch.models import model as model_lib
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_loop


def _expected_spec(ref_spec, ref_ndim: int, port_ndim: int, name: str) -> tuple:
    spec = tuple(ref_spec) + (None,) * (ref_ndim - len(ref_spec))
    stacked, spec = spec[:ref_ndim - port_ndim], spec[ref_ndim - port_ndim:]
    assert all(s is None for s in stacked), (name, ref_spec)
    return spec[::-1] if name.endswith(".weight") else spec


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_init_matches_the_references_eval_shape(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    module, got_specs = model_lib.abstract_init(model_lib.build(cfg))
    structs, jspecs = j_model.abstract_init(j_model.build(jcfg))
    leaves, tree = jax.tree.flatten(structs)
    spec_leaves = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(spec_leaves) == len(leaves)
    # each reference leaf as a zero-cost array of its id, carried over by name
    ids = jax.tree.unflatten(tree, [np.broadcast_to(np.int64(i), l.shape)
                                    for i, l in enumerate(leaves)])
    carried = convert.named_arrays(cfg, ids)
    params = dict(module.named_parameters())
    assert set(carried) == set(params) == set(got_specs)
    for name, p in params.items():
        i = int(carried[name].flat[0]) if carried[name].size else None
        leaf = leaves[i]
        assert p.device.type == "meta", name
        assert tuple(p.shape) == carried[name].shape, name
        assert str(p.dtype).replace("torch.", "") == str(leaf.dtype), name
        assert got_specs[name] == _expected_spec(spec_leaves[i], len(leaf.shape), p.dim(),
                                                 name), name
    assert model_lib.build(cfg).init(device="meta").embed.table.device.type == "meta"


def test_run_cell_traces_full_size_without_allocating(tmp_path):
    """gemma2-2b x train_4k (B 256 x 4,096 tokens): a peak of terabytes,
    far above this machine's memory, so the step never allocated."""
    rec = dryrun.run_cell("gemma2-2b", "train_4k", False, str(tmp_path), device="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    mem = rec["memory_analysis"]
    assert mem["peak_size_in_bytes"] > 10 * host
    assert mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] \
        == mem["peak_size_in_bytes"]
    # parameters (bf16) + float32 moments + the batch, each storage rounded
    assert mem["argument_size_in_bytes"] >= rec["params_total"] * (2 + 4 + 4)
    assert rec["t_compile_s"] == 0.0 and rec["mesh"] == "h100x1"
    assert rec["fits_device_memory"] is False
    cfg = get_config("gemma2-2b")
    ratio = rec["counted_flops"] / costmodel.step_flops(cfg, dryrun.SHAPES["train_4k"])
    assert 0.75 < ratio < 1.45
    assert rec["roofline"]["hlo_flops"] == costmodel.step_flops(cfg, dryrun.SHAPES["train_4k"])
    assert rec["raw_cost_analysis"]["flops"] == rec["counted_flops"]
    with open(tmp_path / "gemma2-2b__train_4k__h100x1.json") as f:
        assert json.load(f)["counted_flops"] == rec["counted_flops"]


def test_run_cell_skips_by_rule_and_refuses_meshes(tmp_path, capsys):
    """A full-attention arch skips long_500k by rule, on one card and on a
    production mesh; a mesh the dry run does not know is refused, by
    ``run_cell`` and ``trace_cell`` alike (the production meshes trace:
    tests/test_torch_dryrun_mesh.py)."""
    rec = dryrun.run_cell("gemma2-2b", "long_500k", False, str(tmp_path), device="cpu")
    assert rec["status"] == "skipped-by-rule" and rec["mesh"] == "h100x1"
    rec = dryrun.run_cell("gemma2-2b", "long_500k", True, str(tmp_path), device="cpu")
    assert rec["status"] == "skipped-by-rule" and rec["mesh"] == "pod2x16x16"
    for call in (dryrun.run_cell, dryrun.trace_cell):
        with pytest.raises(ValueError, match="unknown mesh"):
            call("gemma2-2b", "train_4k", **({"multi_pod": False, "out_dir": str(tmp_path)}
                                              if call is dryrun.run_cell else {}),
                 device="cpu", mesh="pod4x4")
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--mesh", "pod4x4", "--out", str(tmp_path)])
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_main_traces_cells_in_worker_processes(tmp_path, capsys):
    """``--jobs 2``: the cell runs in a spawned worker and its record lands
    as ``run_cell`` writes it."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k", "--device", "cpu",
                     "--jobs", "2", "--out", str(tmp_path)])
    assert e.value.code == 0
    assert "[h100x1] xlstm-125m x decode_32k: ok" in capsys.readouterr().out
    with open(tmp_path / "xlstm-125m__decode_32k__h100x1.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["fits_device_memory"] is True


def _reduced(arch) -> dict:
    return dataclasses.asdict(get_config(arch, reduced=True))


def _real_count(arch, shape) -> int:
    cfg = get_config(arch, reduced=True)
    mdl = model_lib.build(cfg)
    gen = torch.Generator().manual_seed(0)
    with FlopCounterMode(display=False) as counter:
        if shape.kind == "train":
            state = train_loop.init_state(mdl, gen)
            batch = specs.train_batch(cfg, shape, concrete=True)
            train_loop.make_train_step(mdl, opt_lib.OptConfig())(state, batch)
        else:
            params = mdl.init(gen)
            caches = specs.cache_specs(cfg, shape, mdl, device="cpu")
            batch = (specs.decode_batch(cfg, shape, concrete=True) if shape.kind == "decode"
                     else specs.train_batch(cfg, shape, concrete=True))
            batch.pop("labels", None), batch.pop("loss_mask", None)
            mdl.apply(params, batch, mode=shape.kind, caches=caches)
    return counter.get_total_flops()


@pytest.mark.parametrize("arch,kind", [("gemma2-2b", "train"), ("deepseek-moe-16b", "train"),
                                       ("zamba2-2.7b", "train"),
                                       ("seamless-m4t-large-v2", "prefill"),
                                       ("pixtral-12b", "prefill"), ("xlstm-125m", "decode")])
def test_fake_trace_counts_what_a_real_step_counts(arch, kind):
    shape = ShapeConfig("s", 32, 2, kind)
    t = dryrun.trace_cell(arch, shape, device="cpu", overrides=_reduced(arch))
    assert t["flops"] == _real_count(arch, shape) > 0
    assert t["peak_bytes"] >= t["argument_bytes"] > 0


def _records():
    roof = {"t_compute_s": 1.25e-3, "t_memory_s": 3.5e-2, "t_collective_s": 0.0,
            "dominant": "memory", "useful_ratio": 0.731, "roofline_fraction": 0.0123,
            "coll_breakdown": {}}
    ok = {"arch": "gemma2-2b", "shape": "decode_32k", "status": "ok", "t_compile_s": 0.0,
          "memory_analysis": {"temp_size_in_bytes": 3 << 30,
                              "argument_size_in_bytes": 5 << 30,
                              "peak_size_in_bytes": 8 << 30},
          "device_memory_bytes": 80e9, "fits_device_memory": True, "roofline": roof}
    big = dict(ok, shape="train_4k", fits_device_memory=False,
               memory_analysis={"temp_size_in_bytes": 900 << 30,
                                "argument_size_in_bytes": 26 << 30,
                                "peak_size_in_bytes": 926 << 30},
               roofline=dict(roof, dominant="compute", t_compute_s=20.0))
    coll = dict(ok, shape="prefill_32k",
                roofline=dict(roof, dominant="collective", t_collective_s=9.0,
                              coll_breakdown={"all-gather": 3 << 30, "all-reduce": 5 << 30}))
    skipped = {"arch": "gemma2-2b", "shape": "long_500k", "status": "skipped-by-rule",
               "reason": "full-attention arch: long_500k requires sub-quadratic sequence"}
    failed = {"arch": "glm4-9b", "shape": "train_4k", "status": "FAILED",
              "error": "RuntimeError: " + "x" * 80}
    return [ok, big, coll, skipped, failed]


def test_report_tables_render_as_the_references(tmp_path, capsys, monkeypatch):
    recs = _records()
    assert report.dryrun_table(recs) == j_report.dryrun_table(recs)
    assert report.roofline_table(recs) == j_report.roofline_table(recs)
    for r in recs:
        name = f"{r['arch']}__{r['shape']}__h100x1.json"
        (tmp_path / name).write_text(json.dumps(r))
    assert report.load(str(tmp_path), "h100x1") == sorted(
        recs, key=lambda r: f"{r['arch']}__{r['shape']}__h100x1.json")
    monkeypatch.setattr("sys.argv", ["report", str(tmp_path)])
    report.main()
    out = capsys.readouterr().out
    assert "cells: ok=3 skipped-by-rule=1 failed=1" in out
    assert "cells whose peak exceeds the card's memory: 1" in out
    assert "- gemma2-2b x train_4k: peak 926.00GiB > 74.51GiB" in out


def _attn_inputs(dtype, Hq, Hkv, S, D, seed=0, grad=False):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(1, Hq, S, D, generator=g).to(dtype)
    k, v = (torch.randn(1, Hkv, S, D, generator=g).to(dtype) for _ in range(2))
    return tuple(t.requires_grad_(grad) for t in (q, k, v))


MASKS = [dict(causal=True, window=None, softcap=None),
         dict(causal=True, window=5, softcap=30.0),
         dict(causal=False, window=None, softcap=None)]


@pytest.mark.parametrize("mask", range(len(MASKS)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_ops_pass_opcheck_on_cpu(dtype, mask):
    kw = MASKS[mask]
    args = tuple(kw.values())
    for grad in (False, True):
        q, k, v = _attn_inputs(dtype, 4, 2, 24, 32, grad=grad)
        for with_lse in ((False, True) if not grad else (True,)):
            torch.library.opcheck(ops.flash_attention_fwd, (q, k, v, *args, with_lse))
    q, k, v = _attn_inputs(dtype, 4, 2, 24, 32)
    o, lse = ref.attention_ref(q, k, v, return_lse=True, **kw)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    torch.library.opcheck(ops.flash_attention_bwd, (q, k, v, o, do, lse, *args))


def test_attention_ops_count_flops_and_fake_outputs():
    """The FLOP formulas (forward 4 B Hq Sq Skv D, backward 10 B Hq Sq Skv D)
    and the fake outputs' shapes; no launch is counted."""
    q, k, v = _attn_inputs(torch.float32, 4, 2, 24, 32)
    before = ops.attention.launches, ops.attention_bwd.launches
    with FlopCounterMode(display=False) as counter:
        o, lse = ops.flash_attention_fwd(q, k, v, True, None, None, True)
        ops.flash_attention_bwd(q, k, v, o, o, lse, True, None, None)
    counts = {str(op): n for op, n in counter.get_flop_counts()["Global"].items()}
    assert counts == {"repro_torch.flash_attention_fwd": 4 * 4 * 24 * 24 * 32,
                      "repro_torch.flash_attention_bwd": 10 * 4 * 24 * 24 * 32}
    o2, lse2 = ops.flash_attention_fwd(q, k, v, True, None, None, False)
    assert lse2.shape == (0,) and torch.equal(o2, o)
    assert (ops.attention.launches, ops.attention_bwd.launches) == before
    assert ops.launch_scratch_bytes(torch.ops.repro_torch.flash_attention_fwd.default,
                                    (q, k, v)) == 0
