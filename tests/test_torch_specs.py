"""The port's ``launch/specs`` against the reference's.

A concrete batch (``concrete=True``, ``np.random.default_rng(seed)``) must
equal the reference's byte for byte, dtype and shape included, for every
family at a reduced config and at full width; an abstract one (meta tensors) must have the
reference's shapes and dtypes for every arch at every assigned shape; and
``cache_specs`` must give, layer for layer, the reference's cache shapes
(the reference stacks a pattern position's layers, the port keeps a list)
and the same total bytes of keys, values and states, without allocating.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import SHAPES as J_SHAPES
from repro.launch import specs as j_specs
from repro.models import model as j_model
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import specs
from repro_torch.models import model as model_lib

FAMILY_ARCHS = ["tspm-mlho", "gemma2-2b", "deepseek-moe-16b", "pixtral-12b",
                "xlstm-125m", "zamba2-2.7b", "seamless-m4t-large-v2"]


def _bytes_of(x) -> tuple:
    """(dtype name, shape, raw bytes): bfloat16 as its 16-bit patterns."""
    if torch.is_tensor(x):
        t = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        name = {torch.bfloat16: "bfloat16", torch.int32: "int32", torch.bool: "bool",
                torch.float32: "float32"}[x.dtype]
        return name, tuple(x.shape), t.numpy().tobytes()
    a = np.asarray(x)
    name = str(a.dtype)
    if name == "bfloat16":
        a = a.view(np.int16)
    return name, a.shape, a.tobytes()


@pytest.mark.parametrize("reduced,seed", [(True, 0), (False, 3)])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_concrete_batches_equal_the_references_byte_for_byte(arch, reduced, seed):
    """At the reduced config (float32) and at full width (the config's
    dtype, bfloat16 for most: numpy's float64 draws rounded once)."""
    cfg, jcfg = get_config(arch, reduced=reduced), j_get_config(arch, reduced=reduced)
    shape = ShapeConfig("t", 64, 2, "train")
    got = specs.train_batch(cfg, shape, concrete=True, seed=seed)
    want = j_specs.train_batch(jcfg, shape, concrete=True, seed=seed)
    assert list(got) == list(want)
    for k in got:
        assert got[k].device.type == "cpu"
        assert _bytes_of(got[k]) == _bytes_of(want[k]), k
    got = specs.decode_batch(cfg, shape, concrete=True, seed=seed)
    want = j_specs.decode_batch(jcfg, shape, concrete=True, seed=seed)
    assert _bytes_of(got["tokens"]) == _bytes_of(want["tokens"])


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_batches_have_the_references_shapes(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name in SHAPES:
        got = specs.train_batch(cfg, SHAPES[name])
        want = j_specs.train_batch(jcfg, J_SHAPES[name])
        assert list(got) == list(want)
        for k in got:
            assert got[k].device.type == "meta"
            assert (tuple(got[k].shape), _dtype_name(got[k])) \
                == (tuple(want[k].shape), str(want[k].dtype)), (name, k)
        got = specs.decode_batch(cfg, SHAPES[name])["tokens"]
        want = j_specs.decode_batch(jcfg, J_SHAPES[name])["tokens"]
        assert (got.device.type, tuple(got.shape), _dtype_name(got)) \
            == ("meta", tuple(want.shape), str(want.dtype))


def _layer_shapes(tree, stacked: bool) -> tuple[list, int]:
    """(sorted per-layer (shape, dtype) of the tensors, their total bytes);
    a reference leaf's leading layer axis is unstacked, ``pos`` skipped."""
    shapes, total = [], 0

    def walk(node, key=None):
        nonlocal total
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, key)
        elif key != "pos" and hasattr(node, "shape"):
            dtype = str(node.dtype).replace("torch.", "")
            shp = tuple(node.shape)
            size = int(np.prod(shp)) * (torch.empty(0, dtype=node.dtype).element_size()
                                        if torch.is_tensor(node)
                                        else np.dtype(node.dtype).itemsize)
            total += size
            n, one = (shp[0], shp[1:]) if stacked and key != "memory" else (1, shp)
            shapes.extend([(one, dtype)] * n)

    walk(tree)
    return sorted(shapes), total


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_references_layer_for_layer(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name in ("decode_32k", "long_500k"):
        got = specs.cache_specs(cfg, SHAPES[name], model_lib.build(cfg))
        want = j_specs.cache_specs(jcfg, J_SHAPES[name], j_model.build(jcfg))
        for t in jax.tree.leaves(got):
            if torch.is_tensor(t):
                assert t.device.type == "meta"
        g_shapes, g_total = _layer_shapes(got, stacked=False)
        w_shapes, w_total = _layer_shapes(want, stacked=True)
        if cfg.family == "hybrid":    # the reference stacks its Mamba2 states twice
            w_shapes = _zamba_unstack(want)
        assert g_shapes == w_shapes, name
        assert g_total == w_total, name


def _zamba_unstack(want) -> list:
    """The reference's hybrid caches per layer: Mamba2 states are stacked
    ``[n_groups, every, ...]``, the attention caches ``[n_groups, ...]``."""
    shapes = []
    for leaf in jax.tree.leaves(want["mamba"]):
        n = leaf.shape[0] * leaf.shape[1]
        shapes.extend([(tuple(leaf.shape[2:]), str(leaf.dtype))] * n)
    for k in ("k", "v"):
        leaf = want["attn"][k]
        shapes.extend([(tuple(leaf.shape[1:]), str(leaf.dtype))] * leaf.shape[0])
    return sorted(shapes)
