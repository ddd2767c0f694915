"""Fault tolerance: preemption hook, elastic re-meshing, straggler watchdog.

* ``PreemptionGuard`` — SIGTERM/SIGINT flips a flag; the train loop
  checkpoints and exits cleanly at the next step boundary (tested by
  setting the flag directly).
* ``reshard`` — places a (checkpointed or live) state tree onto a NEW
  ``DeviceMesh``: the elastic-scaling path after losing or gaining ranks.
  Checkpoints are mesh-agnostic host numpy (``training/checkpoint``), so a
  restart onto any mesh whose axes divide the tensors' dims is a restore
  and a ``reshard`` by the new mesh's shardings.  The new mesh may span
  only some ranks of the group; the others hold no shard of the result.
* ``StepWatchdog`` — flags steps slower than ``factor`` x the trailing
  median: persistent outliers get reported for replacement.
"""
from __future__ import annotations

import signal
import time

import torch
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_map

from repro_torch.distributed.sharding import NamedSharding, distribute, param_shardings


class PreemptionGuard:
    def __init__(self, install_handlers: bool = False):
        self.preempted = False
        if install_handlers:
            for sig in (signal.SIGTERM, signal.SIGINT):
                signal.signal(sig, self._handler)

    def _handler(self, signum, frame):
        self.preempted = True

    def trigger(self):  # tests / external pod-manager hook
        self.preempted = True


def _place(x, sharding: NamedSharding):
    if isinstance(x, DTensor):
        if x.device_mesh is sharding.mesh:
            return x.redistribute(sharding.mesh, sharding.placements)
        x = x.full_tensor()      # every rank of its mesh joins the gather
    return distribute(torch.as_tensor(x).detach(), sharding)


def reshard(tree, new_mesh, spec_tree):
    """Place a host, tensor or DTensor tree onto ``new_mesh`` with the
    given specs (``sharding.param_shardings``).  A DTensor on another mesh
    is gathered first, on every rank of that mesh."""
    shardings = param_shardings(new_mesh, spec_tree)
    return tree_map(_place, tree, shardings)


class StepWatchdog:
    """Flags steps slower than ``factor`` x trailing-median (stragglers)."""

    def __init__(self, factor: float = 2.0, window: int = 16):
        self.factor = factor
        self.window = window
        self.times: list[float] = []
        self.flagged: list[int] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> bool:
        dt = time.perf_counter() - self._t0
        hist = self.times[-self.window:]
        slow = bool(hist) and dt > self.factor * sorted(hist)[len(hist) // 2]
        self.times.append(dt)
        if slow:
            self.flagged.append(step)
        return slow
