"""Model registry: family -> (init, apply, init_caches).

The dense family (``transformer``) is ported; the others raise
``NotImplementedError`` naming their ROADMAP item.  ``init`` takes an
explicit ``torch.Generator`` in place of the reference's PRNG key and
allocates on the generator's device; the entry points default to the card.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models import transformer

_NOT_PORTED = {
    "moe": "MoE layers", "vlm": "the VLM family (patch-embed prefix)",
    "xlstm": "the xLSTM family", "hybrid": "the hybrid (Zamba) family",
    "encdec": "the encoder-decoder family",
}


class Model(NamedTuple):
    cfg: Any
    init: Callable            # (generator=None, device="cuda") -> params
    apply: Callable            # (params, batch, mode=..., caches=...) -> ...
    init_caches: Callable      # (batch, max_len, device="cuda") -> caches


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index (``'cuda'`` is the
    current CUDA device); a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but no CUDA device is visible; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def build(cfg) -> Model:
    fam = cfg.family
    if fam in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: {_NOT_PORTED[fam]} is not ported yet "
            "(ROADMAP queue 1, item 17)")
    if fam != "dense":
        raise ValueError(f"unknown family {fam!r}")
    transformer.pattern_of(cfg)            # refuses what the family lacks

    def init(generator=None, device="cuda"):
        device = resolve_device(generator.device if generator is not None else device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        return transformer.init(generator, cfg, device)

    return Model(
        cfg, init,
        lambda p, b, **kw: transformer.apply(p, b, cfg, **kw),
        lambda batch, max_len, device="cuda":
            transformer.init_caches(cfg, batch, max_len,
                                    device=resolve_device(device)),
    )


def param_count(params) -> int:
    return sum(x.numel() for x in params.parameters())
