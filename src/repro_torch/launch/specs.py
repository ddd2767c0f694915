"""Per-(arch x shape) input specs: abstract tensors for the dry run,
concrete random batches for smoke tests.  Modality frontends are stubs:
[audio]/[vlm] entries receive precomputed frame/patch embeddings here.

``concrete=True`` draws from ``np.random.default_rng(seed)`` in the
reference's order, so a batch equals the reference's byte for byte (on
the CPU).  ``concrete=False`` gives tensors of the same shapes and dtypes
that hold nothing: on the meta device by default, or fake tensors on
``device`` when called under a ``FakeTensorMode`` (``launch/dryrun``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import layers


def _mk(shape, dtype, concrete, rng, kind="normal", maxval=None, device="meta"):
    if not concrete:
        return torch.empty(shape, dtype=dtype, device=device)
    if kind == "tokens":
        return torch.from_numpy(rng.integers(0, maxval, shape)).to(dtype)
    if kind == "ones":
        return torch.ones(shape, dtype=dtype)
    return torch.from_numpy(rng.standard_normal(shape) * 0.1).to(dtype)


def train_batch(cfg: ModelConfig, shape: ShapeConfig, *, concrete=False, seed=0,
                device="meta"):
    """Training/prefill inputs for one global batch (``device`` is where an
    abstract batch lies; a concrete one is made on the CPU)."""
    rng = np.random.default_rng(seed) if concrete else None
    b, s = shape.global_batch, shape.seq_len
    v = cfg.vocab_size
    i32, flag, dt = torch.int32, torch.bool, layers.dt(cfg)

    def mk(shp, dtype, kind="normal", maxval=None):
        return _mk(shp, dtype, concrete, rng, kind, maxval, device)

    if cfg.family == "encdec":
        ss = st = s // 2
        return {
            "src_embeds": mk((b, ss, cfg.d_model), dt),
            "tokens": mk((b, st), i32, "tokens", v),
            "labels": mk((b, st), i32, "tokens", v),
            "loss_mask": mk((b, st), flag, "ones"),
        }
    if cfg.family == "vlm":
        st = max(s - cfg.n_patches, 8)
        return {
            "patch_embeds": mk((b, cfg.n_patches, cfg.frontend_dim), dt),
            "tokens": mk((b, st), i32, "tokens", v),
            # labels cover the full (patch + text) sequence
            "labels": mk((b, st + cfg.n_patches), i32, "tokens", v),
            "loss_mask": mk((b, st + cfg.n_patches), flag, "ones"),
        }
    return {
        "tokens": mk((b, s), i32, "tokens", v),
        "labels": mk((b, s), i32, "tokens", v),
        "loss_mask": mk((b, s), flag, "ones"),
    }


def decode_batch(cfg: ModelConfig, shape: ShapeConfig, *, concrete=False, seed=0,
                 device="meta"):
    """One-token decode inputs (the caches come from ``model.init_caches``
    and are an argument of the serve step)."""
    rng = np.random.default_rng(seed) if concrete else None
    b = shape.global_batch
    return {"tokens": _mk((b, 1), torch.int32, concrete, rng, "tokens", cfg.vocab_size,
                          device)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, model, device="meta"):
    """The decode caches at this shape, in the port's layout
    (``model.init_caches``' structure: per-layer lists where the reference
    stacks), holding nothing: meta tensors, or fake ones on ``device``
    under a ``FakeTensorMode``."""
    b, s = shape.global_batch, shape.seq_len
    return model.init_caches(b, s, src_len=s // 2 if cfg.family == "encdec" else None,
                             device=device)
