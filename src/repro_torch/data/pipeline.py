"""Input pipeline: balancing patients over shards by pair cost.

Patients are sharded by *pair count*, not patient count: a patient with
4x the events costs 16x the pairs, which is exactly the imbalance the
paper's per-patient OpenMP scheduling suffers from.  ``balance_buckets``
is the longest-processing-time-first assignment the sharded stream's
balanced router pins (``stream.shard.ShardRouter.balanced``);
``ChunkScheduler`` implements work-stealing over chunk queues for the
host-side (file-based) mode.  All of it is host numpy and threads.

``shard_batch`` places an LM batch on a ``DeviceMesh``: each array
becomes a DTensor sharded on its leading dim over the mesh's batch axes
(``('pod', 'data')``, those the mesh has) and replicated over the rest.
"""
from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch

from repro_torch.core import chunking
from repro_torch.data.dbmart import DBMart
from repro_torch.distributed.sharding import NamedSharding, P, distribute


def balance_buckets(nevents: np.ndarray, n_shards: int) -> list[list[int]]:
    """LPT assignment of patients to shards by pair-count cost.

    Bucket capacity rounds *up* (``ceil(P / n_shards)``), so the
    ``P % n_shards`` remainder patients spread over the buckets instead of
    all landing in shard 0; ties go to the lowest shard (``np.argmin``)."""
    cost = nevents.astype(np.int64) * (nevents.astype(np.int64) - 1) // 2
    order = np.argsort(-cost)
    loads = np.zeros(n_shards, np.int64)
    buckets: list[list[int]] = [[] for _ in range(n_shards)]
    per = -(-len(nevents) // n_shards)
    for p in order:
        k = int(np.argmin(np.where(
            np.asarray([len(b) for b in buckets]) < per, loads,
            np.iinfo(np.int64).max)))
        buckets[k].append(int(p))
        loads[k] += int(cost[p])
    return buckets


def balance_patients(nevents: np.ndarray, n_shards: int) -> np.ndarray:
    """Permutation such that contiguous equal slices of the permuted patient
    axis have near-equal total n(n-1)/2 cost (see :func:`balance_buckets`).

    Exact only when ``len(nevents) % n_shards == 0``; with a remainder,
    bucket sizes differ by one and equal-slice cuts straddle bucket
    boundaries — slice by :func:`balance_buckets` sizes instead."""
    return np.concatenate([
        np.asarray(b, np.int64)
        for b in balance_buckets(nevents, n_shards)])


def shard_batch(batch: dict, mesh, batch_axes=("pod", "data")) -> dict:
    """Host batch -> DTensors on ``mesh``, sharded over its batch axes.

    Every rank passes the same global batch and keeps its own slice
    (nothing is sent); the slices land on the mesh's device type."""
    axes = tuple(a for a in batch_axes if a in mesh.mesh_dim_names)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = distribute(t, NamedSharding(mesh, P(axes, *([None] * (t.ndim - 1)))))
    return out


class ChunkScheduler:
    """Work-stealing queue over mining chunks (host-side, file-based mode).

    Worker threads pop chunks; a straggler's remaining chunks are visible
    to idle peers because the queue is global."""

    def __init__(self, db: DBMart, budget_bytes: int):
        self.db = db
        self.chunks = chunking.plan_chunks(np.asarray(db.nevents), budget_bytes)
        self._lock = threading.Lock()
        self._next = 0
        self.completed: list[int] = []

    def steal(self) -> chunking.Chunk | None:
        with self._lock:
            if self._next >= len(self.chunks):
                return None
            c = self.chunks[self._next]
            self._next += 1
            return c

    def run(self, worker: Callable[[chunking.Chunk], object],
            n_workers: int = 1) -> list:
        """Run ``worker`` over every chunk on ``n_workers`` threads; returns
        the results in completion order."""
        results = []
        rlock = threading.Lock()

        def loop(wid: int):
            while True:
                c = self.steal()
                if c is None:
                    return
                r = worker(c)
                with rlock:
                    results.append(r)
                    self.completed.append(wid)

        threads = [threading.Thread(target=loop, args=(w,))
                   for w in range(n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return results
