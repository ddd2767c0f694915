"""Snapshot-isolated read replicas of mining state.

A :class:`ReadReplica` sits between a
:class:`~repro_torch.api.session.MiningSession` and the query path.  At
every tick boundary (a typed ``TickCompleted`` subscription on the
service — see :mod:`repro_torch.stream.events`) it *publishes* a fresh
:class:`ReplicaView` — an immutable bundle of the snapshot frame, its
``snapshot_version``, its tick count, and the feature-store presence matrix
folded at the same boundary — and swaps it in as the front view with one
reference assignment.  Double buffering falls out of that discipline: the
next view is assembled off to the side while readers keep using the
current one, so

  * queries never block ``submit``/``tick`` (they only ever *read* the
    front reference and the immutable arrays behind it), and
  * queries never observe a half-applied tick (the hook runs after
    ``tick_finish`` has fully appended the wave, and ``snapshot()`` gathers
    into fresh arrays that later ticks never touch).

A view also lazily materializes the padded *evaluation columns* the
batched predicate op consumes — per-row start/end phenX, duration, and the
screen statistic (exact support or hash-bucket count, matching the frame's
screen mode) — as tensors on the session's device (the card unless the
session runs on the CPU), padded to a power-of-two row count (at least
1,024) so heterogeneous snapshots share a handful of shapes.  The columns
and the view's cached predicate rows are the view's only device memory;
they go with the view.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import queries, sparsity


def _pow2(n: int, floor: int = 1024) -> int:
    """Smallest power of two >= n (>= floor) — quantizes column shapes."""
    out = floor
    while out < n:
        out *= 2
    return out


class EvalColumns(NamedTuple):
    """Padded per-row predicate inputs of the batched predicate op."""

    start: torch.Tensor   # [Npad] int32 start phenX (fuse-aware)
    end: torch.Tensor     # [Npad] int32 end phenX
    dur: torch.Tensor     # [Npad] int32 duration
    screen: torch.Tensor  # [Npad] int32 support or bucket count (per mode)
    valid: torch.Tensor   # [Npad] bool, False on padding rows
    n_rows: int           # real (unpadded) row count


class ReplicaView:
    """One published, immutable snapshot of mining state.

    ``frame`` is a plain :class:`SequenceFrame` over the snapshot corpus —
    the conformance oracle *and* the host evaluator for barrier ops;
    ``version``/``tick`` identify the publication (the result-cache key and
    the staleness basis); ``feature_x`` is the feature store's presence
    matrix as of this tick (point-in-time consistent with the corpus);
    ``device`` is where the evaluation columns and predicate rows live.
    """

    __slots__ = ("frame", "version", "tick", "feature_x", "device", "_cols",
                 "_lock", "pred_cache")

    def __init__(self, frame, version: int, tick: int, feature_x=None, *,
                 device):
        self.frame = frame
        self.version = version
        self.tick = tick
        self.feature_x = feature_x
        self.device = torch.device(device)
        self._cols: EvalColumns | None = None
        self._lock = threading.Lock()
        # (kind, arg) -> [Npad] bool predicate row on ``device``, filled by
        # the server's wave evaluator.  Rows are deterministic functions of
        # the immutable columns, so a racing double-compute stores equal
        # values
        self.pred_cache: dict[tuple, torch.Tensor] = {}

    @property
    def n_rows(self) -> int:
        return len(self.frame._corpus)

    def columns(self) -> EvalColumns:
        """The padded evaluation columns, built once per view (thread-safe:
        concurrent query waves double-check under the view lock)."""
        if self._cols is None:
            with self._lock:
                if self._cols is None:
                    self._cols = self._build_columns()
        return self._cols

    def _build_columns(self) -> EvalColumns:
        fr = self.frame
        c = fr._corpus
        n = len(c)
        npad = _pow2(max(n, 1))
        dev = self.device
        seq = torch.from_numpy(c.seq).to(dev)
        s, e = queries.unpack_seq(seq, fr.codec, fused=fr.fuse_duration)
        if fr.screen_mode in ("hash", "fused"):
            # same statistic the frame's screen op reads: the shared
            # bucket-count table, gathered per row
            h = sparsity.hash_bucket(seq, c.n_buckets_log2)
            scr = torch.from_numpy(c.counts()).to(dev)[h.long()]
        else:
            scr = torch.from_numpy(c.support()).to(dev)
        del seq

        def pad(a, dtype):
            out = torch.zeros(npad, dtype=dtype, device=dev)
            out[:n] = torch.as_tensor(a, device=dev).to(dtype)
            return out

        valid = torch.zeros(npad, dtype=torch.bool, device=dev)
        valid[:n] = True
        return EvalColumns(pad(s, torch.int32), pad(e, torch.int32),
                           pad(torch.from_numpy(c.dur), torch.int32),
                           pad(scr, torch.int32), valid, n)


class ReadReplica:
    """Double-buffered front/back publication of session state.

    Writers (the ingest thread's tick hook, or an explicit ``publish()``)
    assemble the next view under ``_pub_lock`` — the back buffer — then
    install it as ``_front`` with a single reference store.  Readers call
    :meth:`view` with no lock at all.
    """

    def __init__(self, session, feature_store=None):
        self.session = session
        self.feature_store = feature_store
        self._front: ReplicaView | None = None
        self._pub_lock = threading.Lock()
        self.published = 0   # publication count (plain int; obs-agnostic)

    def view(self) -> ReplicaView:
        """The current front view (publishing one first if none exists)."""
        v = self._front
        if v is None:
            v = self.publish()
        return v

    def publish(self) -> ReplicaView:
        """Assemble and atomically install a fresh view of the session's
        current state.  Cheap at publish time: the frame's canonical
        lexsort and the evaluation columns are lazy, paid by the first
        query against the view — off the ingest thread."""
        with self._pub_lock:
            svc = self.session.service
            frame = self.session.frame()
            version = svc.snapshot_version if svc is not None else 0
            tick = svc.n_ticks if svc is not None else 0
            fx = (self.feature_store.fold()
                  if self.feature_store is not None else None)
            view = ReplicaView(frame, version, tick, feature_x=fx,
                               device=self.session.device)
            self.published += 1
            self._front = view
            return view

    def staleness_ticks(self) -> int:
        """Ticks the front view lags the live service (0 for batch/fresh)."""
        svc = self.session.service
        v = self._front
        if svc is None or v is None:
            return 0
        return max(0, svc.n_ticks - v.tick)


def uncompacted_rows(session) -> tuple[np.ndarray, np.ndarray]:
    """(seq, patient-key) rows for feature-store bootstrap.

    Live services hand back the *uncompacted* snapshot with pids translated
    to original integer keys — bootstrapping from a fused-compacted frame
    would silently drop rows of ids below today's threshold that later
    ticks push over it.  Batch sessions return the fitted frame's corpus
    (exact even when fused: a batch fit's counts are frozen, so its
    survivor set can never grow).  Non-integer patient keys are rejected —
    the presence matrix is indexed by key.
    """
    svc = session.service
    if svc is None:
        c = session.frame()._corpus
        return c.seq, c.patient.astype(np.int64)
    from repro_torch.stream.shard import ShardedStreamService
    if isinstance(svc, ShardedStreamService):
        p2k = svc.pid_to_key()
    else:
        p2k = {pid: k for k, pid in svc.store.pids.items()}
    if not all(isinstance(k, (int, np.integer)) for k in p2k.values()):
        raise TypeError("the streaming feature store needs integer patient "
                        "keys (the presence matrix is indexed by key); "
                        "serve without feature_ids for keyed cohorts")
    snap = svc.snapshot()
    if not p2k:
        return snap.seq, np.asarray(snap.patient, np.int64)
    lut = np.full(max(p2k) + 1, -1, np.int64)
    for pid, key in p2k.items():
        lut[pid] = key
    return snap.seq, lut[np.asarray(snap.patient)]
