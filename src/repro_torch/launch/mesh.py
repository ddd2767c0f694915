"""The patient-sharding "mesh": a 1-D tuple of devices.

The reference's ``('data',)`` mesh is a JAX device mesh; here it is the
tuple of ``torch.device``s the shards of the streaming service pin to:
``cuda:0 .. cuda:k-1`` for the visible cards, or ``(cpu,)`` when the
caller asks for the CPU.  The LM side's 2-D and 3-D meshes
(``make_production_mesh``, ``make_test_mesh``) wait for the LM side's
port (ROADMAP.md queue 1 item 17).
"""
from __future__ import annotations

import torch


def make_data_mesh(n: int | None = None, device="cuda") -> tuple:
    """1-D mesh over up to ``n`` devices of ``device``'s type: every
    visible card for ``'cuda'`` (raises when none is visible), one CPU
    for ``'cpu'``."""
    kind = torch.device(device).type
    if kind == "cpu":
        return (torch.device("cpu"),)
    if kind != "cuda":
        raise ValueError(f"no data mesh over {kind!r} devices")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device is visible; pass device='cpu'")
    count = count if n is None else min(n, count)
    return tuple(torch.device("cuda", i) for i in range(count))


def shard_devices(n_shards: int, mesh=None) -> list:
    """One device per shard slot, in mesh position order.

    Shard ``s`` of the streaming service lives at mesh position ``s``;
    with fewer devices than shards the assignment wraps round-robin
    (co-resident shards still mine correctly, they share a device).
    Without a mesh, the mesh of every visible card."""
    devices = list(mesh) if mesh is not None else list(make_data_mesh())
    return [devices[s % len(devices)] for s in range(n_shards)]
