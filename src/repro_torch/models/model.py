"""Model registry: family -> (init, apply, init_caches).

Every family of the reference is ported: the dense, MoE and VLM families
(``transformer``), ``xlstm``, ``hybrid`` (``zamba``) and ``encdec``.
``init`` takes an explicit ``torch.Generator`` in place of the
reference's PRNG key and allocates on the generator's device;
``init_caches`` takes the reference's ``src_len`` (the encoder's length,
default ``max_len``), which only ``encdec`` reads.  The entry points
default to the card.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models import encdec, transformer, xlstm, zamba

# family -> the module that builds, applies and caches it
FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "xlstm": xlstm, "hybrid": zamba, "encdec": encdec}
# family -> the model's nn.Module class
MODULES = {"dense": transformer.Transformer, "moe": transformer.Transformer,
           "vlm": transformer.Transformer, "xlstm": xlstm.XLSTM, "hybrid": zamba.Zamba,
           "encdec": encdec.EncDec}


class Model(NamedTuple):
    cfg: Any
    init: Callable            # (generator=None, device="cuda") -> params
    apply: Callable            # (params, batch, mode=..., caches=...) -> ...
    init_caches: Callable      # (batch, max_len, src_len=None, device="cuda") -> caches


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
    if fam not in FAMILIES:
        raise ValueError(f"unknown family {fam!r}")
    family = FAMILIES[fam]

    def init(generator=None, device="cuda"):
        device = resolve_device(generator.device if generator is not None else device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        return family.init(generator, cfg, device)

    def init_caches(batch, max_len=None, src_len=None, device="cuda"):
        device = resolve_device(device)
        if fam == "encdec":
            return encdec.init_caches(cfg, batch, max_len, src_len or max_len, device=device)
        return family.init_caches(cfg, batch, max_len, device=device)

    return Model(cfg, init, lambda p, b, **kw: family.apply(p, b, cfg, **kw), init_caches)


def param_count(params) -> int:
    return sum(x.numel() for x in params.parameters())
