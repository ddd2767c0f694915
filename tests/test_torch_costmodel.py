"""The port's cost model and the LM half of its roofline against the
reference's.

``analysis/costmodel`` is pure arithmetic on the config: ``fwd_flops``,
``step_flops`` and ``step_bytes`` must equal the reference's exactly for
every arch at every assigned shape and the smoke shape.  ``count_params``
(the port builds the model on the meta device) must give the reference's
``(total, active)`` at full size, ``model_flops`` the same number, and
``Roofline`` the same terms, ``dominant`` and ``roofline_fraction`` once
the reference's peaks are set to the port's (the H100's).  The validation
twin of tests/test_costmodel.py: ``FlopCounterMode`` over the port's loss
and gradient at reduced size lies within the reference's bands of
``step_flops`` (0.75-1.45 train, 0.5-2.0 decode).
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.analysis import costmodel as j_costmodel
from repro.analysis import roofline as j_roofline
from repro.configs import get_config as j_get_config
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import SMOKE as J_SMOKE
from repro_torch.analysis import costmodel
from repro_torch.analysis import roofline as rl
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES, SMOKE, ShapeConfig
from repro_torch.launch import specs
from repro_torch.models import model as model_lib
from repro_torch.models import runtime_flags
from repro_torch.training import train_loop

SHAPE_NAMES = list(SHAPES) + ["smoke"]


def _shapes(name):
    return (SMOKE, J_SMOKE) if name == "smoke" else (SHAPES[name], J_SHAPES[name])


def _same_config(cfg, jcfg):
    """The two packages' configs agree field for field (``attn_impl`` names
    each package's own implementations)."""
    a, b = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
    a.pop("attn_impl"), b.pop("attn_impl")
    assert a == b


@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cost_model_equals_the_reference(arch, shape_name):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    _same_config(cfg, jcfg)
    shape, jshape = _shapes(shape_name)
    B, S = shape.global_batch, shape.seq_len
    for args in ((B, S), (B, S, S // 2), (B, 1, S)):
        assert costmodel.fwd_flops(cfg, *args) == j_costmodel.fwd_flops(jcfg, *args)
    assert costmodel.step_flops(cfg, shape) == j_costmodel.step_flops(jcfg, jshape)
    n = 1_234_567_891
    assert costmodel.step_bytes(cfg, shape, n) == j_costmodel.step_bytes(jcfg, jshape, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_equals_the_reference(arch):
    cfg = get_config(arch)
    assert rl.count_params(cfg) == j_roofline.count_params(j_get_config(arch))


@pytest.fixture
def h100_peaks(monkeypatch):
    """The reference's roofline priced at the port's peaks."""
    monkeypatch.setattr(j_roofline, "PEAK_FLOPS", rl.PEAK_FLOPS)
    monkeypatch.setattr(j_roofline, "HBM_BW", rl.HBM_BW)
    monkeypatch.setattr(j_roofline, "ICI_BW", rl.NVLINK_BW)


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-moe-16b", "xlstm-125m",
                                  "seamless-m4t-large-v2"])
def test_model_flops_and_roofline_equal_the_reference(arch, shape_name, h100_peaks):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    shape, jshape = _shapes(shape_name)
    active, embed = 2_830_747_648, cfg.vocab_size * cfg.d_model
    mf = rl.model_flops(cfg, shape, active, embed)
    assert mf == j_roofline.model_flops(jcfg, jshape, active, embed)
    flops = costmodel.step_flops(cfg, shape)
    hbm = costmodel.step_bytes(cfg, shape, active)
    for chips, coll in ((1, 0.0), (4, 3.5e12)):
        kw = dict(arch=arch, shape=shape_name, chips=chips, hlo_flops=flops, hlo_bytes=hbm,
                  coll_bytes=coll, coll_breakdown={"all-reduce": coll}, model_flops=mf,
                  bytes_per_device=123.0)
        got, want = rl.Roofline(**kw), j_roofline.Roofline(**kw)
        assert got.row() == want.row()
        assert (got.dominant, got.roofline_fraction) == (want.dominant, want.roofline_fraction)


def test_roofline_is_priced_at_the_h100s_peaks():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    r = rl.Roofline("a", "s", 1, 989e12, 3.35e12 * 2, 0.0, {}, 989e12 / 2)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 2.0, 0.0)
    assert r.dominant == "memory" and r.roofline_fraction == 0.25


def test_shape_bytes_and_format_table_equal_the_reference():
    for dtype, dims in (("bf16", "2,3"), ("f32", ""), ("s8", "7"), ("c128", "1,1"),
                        ("weird", "5")):
        assert rl.shape_bytes(dtype, dims) == j_roofline.shape_bytes(dtype, dims)
    rows = [rl.Roofline("gemma2-2b", s, 1, 1e15 * i, 2e12 * i, 0.0, {}, 5e14 * i).row()
            for i, s in enumerate(SHAPES, 1)]
    assert rl.format_table(rows) == j_roofline.format_table(rows)


@pytest.fixture
def unrolled():
    runtime_flags.UNROLL_SCANS = True
    yield
    runtime_flags.UNROLL_SCANS = False


FAMILIES = ["tspm-mlho", "gemma2-2b", "deepseek-moe-16b", "xlstm-125m",
            "zamba2-2.7b", "seamless-m4t-large-v2", "pixtral-12b"]


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_flops_model_matches_the_counted_step(arch, unrolled):
    """tests/test_costmodel.py's train case: the counted FLOPs of loss and
    gradient over the reference's unrolled HLO band."""
    cfg = get_config(arch, reduced=True).replace(remat="none", capacity_factor=1.25)
    mdl = model_lib.build(cfg)
    model = train_loop.trainable(mdl.init(torch.Generator().manual_seed(0)))
    shape = ShapeConfig("t", 64, 2, "train")
    batch = specs.train_batch(cfg, shape, concrete=True)
    loss_fn = train_loop.make_loss_fn(mdl, z_coef=0.0)

    def step():
        loss, _ = loss_fn(model, batch)
        torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)

    ratio = _counted(step) / costmodel.step_flops(cfg, shape)
    assert 0.75 < ratio < 1.45, (arch, ratio)


@pytest.mark.parametrize("arch", ["gemma2-2b", "xlstm-125m", "zamba2-2.7b"])
def test_decode_flops_model_matches_the_counted_step(arch, unrolled):
    cfg = get_config(arch, reduced=True)
    mdl = model_lib.build(cfg)
    params = mdl.init(torch.Generator().manual_seed(0))
    shape = ShapeConfig("d", 32, 2, "decode")
    caches = mdl.init_caches(2, 32, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    got = _counted(lambda: mdl.apply(params, {"tokens": tok}, mode="decode", caches=caches))
    ratio = got / costmodel.step_flops(cfg, shape)
    assert 0.5 < ratio < 2.0, (arch, ratio)


def test_flops_scale_linearly_in_depth():
    cfg = get_config("tspm-mlho", reduced=True)
    shape = ShapeConfig("t", 128, 4, "train")
    s1, s2, s3 = (costmodel.step_flops(cfg.replace(n_layers=n), shape) for n in (2, 4, 6))
    assert abs((s3 - s2) - (s2 - s1)) / (s2 - s1) < 1e-6


def test_runtime_flags_change_no_count():
    """The port's loops run eagerly: unrolling changes nothing counted."""
    cfg = get_config("xlstm-125m", reduced=True)
    mdl = model_lib.build(cfg)
    params = mdl.init(torch.Generator().manual_seed(0))
    batch = specs.train_batch(cfg, ShapeConfig("t", 64, 2, "train"), concrete=True)
    counts = []
    for flag in (False, True):
        runtime_flags.UNROLL_SCANS = flag
        try:
            assert runtime_flags.scan_unroll() == (True if flag else 1)
            counts.append(_counted(lambda: mdl.apply(params, batch, mode="train")))
        finally:
            runtime_flags.UNROLL_SCANS = False
    assert counts[0] == counts[1] > 0
    assert np.isfinite(counts[0])
