"""Sharded streaming mining: patient->shard router over per-shard services.

One :class:`~repro_torch.stream.service.StreamService` (PatientStore +
OnlineSupportSketch + delta miner) runs per shard, on the session's
device or pinned to a device of the mesh (``launch.mesh``), with three
pieces on top:

  * **router** — a patient key is *sticky until migrated*: it routes to
    one shard (its history planes and sketch rows live there) either by a
    stable hash (streaming default: keys arrive unannounced) or by a
    pinned LPT assignment from ``data/pipeline.balance_buckets`` when
    per-patient event counts are known up front (replays, backfills) —
    pair cost is quadratic in events, so hash-balance is not
    work-balance.  ``migrate`` re-pins the key (``ShardRouter.assign``),
    so submissions after a handoff land on the new home;
  * **global screen** — per-shard sketch tables count distinct
    (patient, sequence) pairs over disjoint patient sets, so the global
    table is their elementwise sum
    (``distributed.sharding.merge_sharded_counts``, device to device).
    Queries compose snapshot masks with the merged table, so every query
    sees the whole cohort;
  * **live migration** — ``migrate(key, dst)`` hands a patient between
    shards mid-stream, and ``rebalance`` triggers migrations whenever the
    hottest shard's resident pair cost (``chunking.BYTES_PER_PAIR``, the
    model batch chunking and the LPT router already use) exceeds
    ``imbalance_threshold`` x the mean — a hash-hot shard stops being hot.

Handoff invariants (tests/test_torch_shard.py holds them against the
reference):

  * *sticky-until-migrated routing* — a key's queued deltas move with it
    in arrival order and the router override lands every later submit on
    the destination, so no delta is ever mined against a partial history;
  * *subtract/add sketch transfer* — the patient's sorted distinct-id set
    moves wholesale; bucket counts are decremented at the source and
    incremented at the destination, so each shard table remains exactly
    ``local_bucket_counts`` of its own patients and the merged table is
    invariant under any migration schedule;
  * *spill-format compatibility* — the store handoff payload is the
    host-spill format (1-D phenx/date numpy arrays), admitted into the
    destination's spill slot: a migrated patient restores on first touch,
    onto the destination's device, exactly like an evicted one, and plane
    capacity freed at the source shrinks when the patient was the
    high-water mark.

Replaying a dbmart through the sharded service with any interleaving of
migrations and rebalances equals the single-shard service and batch
mine+screen on corpus, support counts, and query masks, for any shard
count, router, and per-shard eviction budget; and equals the reference's
sharded service byte for byte.
"""
from __future__ import annotations

import time
import zlib
from collections import deque

import numpy as np
import torch

from repro_torch import obs as obs_lib
from repro_torch.core import chunking, sparsity
from repro_torch.core.encoding import as_tensor
from repro_torch.data import pipeline
from repro_torch.distributed.sharding import merge_sharded_counts
from repro_torch.launch.mesh import make_data_mesh, shard_devices
from repro_torch.storage.codec import decode_key, encode_key
from repro_torch.stream import counts as counts_lib
from repro_torch.stream.events import DeltaSubmitted, Evicted, \
    EventDispatcher, Migrated, Rebalanced, TickCompleted
from repro_torch.stream.service import PatientState, Snapshot, \
    SnapshotQueries, StreamService, TickStats

PLACEMENTS = ("host", "devices")


def stable_shard_hash(key) -> int:
    """Process-stable key hash (python ``hash`` is salted for strings)."""
    if isinstance(key, (int, np.integer)):
        # splitmix64 finalizer: avalanches dense patient ids
        h = (int(key) + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        return h ^ (h >> 31)
    return zlib.crc32(repr(key).encode())


class ShardRouter:
    """Patient key -> shard id; sticky *until migrated* (a pure function of
    the key, overridden by the pinned table — balanced placement and
    migration handoffs both write there)."""

    def __init__(self, n_shards: int, pinned: dict | None = None):
        self.n_shards = n_shards
        self.pinned = pinned or {}

    def route(self, key) -> int:
        s = self.pinned.get(key)
        if s is None:
            s = stable_shard_hash(key) % self.n_shards
        return s

    def assign(self, key, shard: int) -> None:
        """Re-pin a key (migration handoff); later routes land on ``shard``."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range [0, {self.n_shards})")
        self.pinned[key] = shard

    @classmethod
    def balanced(cls, keys, nevents, n_shards: int) -> "ShardRouter":
        """Pin known patients by pair-count LPT (``balance_buckets``); keys
        not in the table still hash — cold starts keep working."""
        buckets = pipeline.balance_buckets(
            np.asarray(nevents, np.int64), n_shards)
        pinned = {keys[p]: s for s, b in enumerate(buckets) for p in b}
        return cls(n_shards, pinned)


class ShardedStreamService(SnapshotQueries):
    """StreamService API over ``n_shards`` shard-local services.

    ``mesh`` (``launch.mesh.make_data_mesh``: a tuple of devices) is where
    the global table is merged (its first device) and, under
    ``'devices'``, where the shards live; without one the merge runs on
    the first shard's device — results are identical.
    ``rebalance_every`` (ticks) turns on load-triggered rebalancing:
    whenever the hottest shard's resident pair cost exceeds
    ``imbalance_threshold`` x the mean, its largest patients migrate to
    the coldest shard (greedy LPT, same ``BYTES_PER_PAIR`` cost model as
    batch chunking).  Remaining kwargs configure each shard's
    StreamService (note ``budget_bytes`` is *per shard*: the eviction
    working set is a shard-local property, like the per-chunk byte budget
    of batch chunking).

    ``placement`` picks where shard state lives and how ticks dispatch:

      * ``'host'`` — every shard on ``device`` (the card unless the
        caller passes ``'cpu'``), ticks run shard-serial (the conformance
        reference);
      * ``'devices'`` — shard ``s``'s store planes and sketch table are
        pinned to mesh position ``s`` (``launch.mesh.shard_devices`` over
        ``mesh``, or over every device of ``device``'s type; round-robin
        when shards outnumber devices, so on one card every shard sits on
        ``cuda:0``), and ``tick`` runs in two passes: every shard's wave
        is *dispatched* (``StreamService.tick_begin``) before any shard's
        results are collected.  Results are byte-identical to ``'host'``
        (same programs on the same values, one sum for the screen).

    ``async_migration`` (default: on exactly for ``'devices'``) makes
    ``migrate`` two-phase: phase 1 snapshots the source patient's
    spill-format state and enqueues it for the destination; phase 2 admits
    it at the next tick boundary, after the *other* shards' waves are
    already dispatched.  Any read that needs whole-cohort state
    (snapshot, global counts, load accounting) flushes pending admits
    first, so results are again schedule-invariant.
    """

    def __init__(self, n_shards: int = 1, router: ShardRouter | None = None,
                 mesh=None, rebalance_every: int | None = None,
                 imbalance_threshold: float = 1.5, min_gain: float = 0.05,
                 placement: str = "host", async_migration: bool | None = None,
                 telemetry=None, busy_weighted_rebalance: bool = False,
                 device="cuda", **service_kwargs):
        if router is not None and router.n_shards != n_shards:
            raise ValueError(f"router covers {router.n_shards} shards, "
                             f"service has {n_shards}")
        if placement not in PLACEMENTS:
            raise ValueError(
                f"unknown placement {placement!r}; one of {PLACEMENTS}")
        self.router = router or ShardRouter(n_shards)
        self.mesh = mesh
        self.rebalance_every = rebalance_every
        self.imbalance_threshold = imbalance_threshold
        self.min_gain = min_gain
        self.busy_weighted_rebalance = busy_weighted_rebalance
        self.placement = placement
        self.async_migration = (placement == "devices"
                                if async_migration is None else async_migration)
        self.devices = (shard_devices(n_shards, mesh if mesh is not None
                                      else make_data_mesh(device=device))
                        if placement == "devices"
                        else [torch.device(device)] * n_shards)
        self.obs = telemetry if telemetry is not None else obs_lib.NOOP
        # one specialization tracker for the whole sharded service: the
        # hot functions' shape sets are process-global, so per-shard
        # trackers would each count the same shape
        retrace = obs_lib.RetraceTracker() if self.obs.enabled else None
        self.shards = [StreamService(device=d, telemetry=self.obs,
                                     shard_tag=s, retrace_tracker=retrace,
                                     **service_kwargs)
                       for s, d in enumerate(self.devices)]
        m = self.obs.metrics
        self._m_migrations = m.counter("shard.migrations")
        self._m_rebalances = m.counter("shard.rebalances")
        self._m_pending = m.gauge("shard.pending_admits")
        self.codec = self.shards[0].codec
        self.fuse_duration = self.shards[0].fuse_duration
        self.n_buckets_log2 = self.shards[0].sketch.n_buckets_log2
        self.pids: dict = {}        # key -> global pid (first-submit order)
        self.migrations: list[tuple] = []   # (key, src, dst) history
        self.migration_wall_s = 0.0         # host time spent in handoffs
        self.admit_wall_s = 0.0     # phase-2 admits (overlaps mining)
        self._pending_admits: list[list] = [[] for _ in range(n_shards)]
        self._pending_keys: dict = {}       # key -> dst with state in flight
        self._tick_count = 0
        # whole-cohort snapshot + merged-counts caches, keyed (implicitly)
        # on ``snapshot_version`` — invalidated together on any mutation
        self._snap: Snapshot | None = None
        self._gcounts: np.ndarray | None = None
        self._snap_version = 0
        self.events = EventDispatcher(self.obs)
        # per-shard events buffered during a sharded tick, re-emitted at
        # the cohort boundary in *shard-index* order (dispatch order
        # depends on which shards have pending admits — not a property
        # consumers, least of all the journal, should observe)
        self._collected: list[list] = [[] for _ in range(n_shards)]
        self._collector_installed = False
        # device-timed busy window for shard_load(): per-shard completion
        # -timed seconds (TickStats.device_s) accumulated since the last
        # shard_load() poll — maintained unconditionally (plain float
        # adds), so the busy signal works with telemetry disabled
        self._busy_acc = [0.0] * n_shards
        self._busy_t0 = time.perf_counter()

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def stats(self) -> list[TickStats]:
        return [st for svc in self.shards for st in svc.stats]

    @property
    def n_ticks(self) -> int:
        """Sharded tick count (one per cohort-wide wave) — the publication
        clock for serving replicas, mirroring StreamService.n_ticks."""
        return self._tick_count

    @property
    def snapshot_version(self) -> int:
        """Monotone whole-cohort state version (see
        StreamService.snapshot_version); bumps on tick, migrate, pending
        flush, and restore."""
        return self._snap_version

    def _invalidate_snapshot(self) -> None:
        self._snap = None
        self._gcounts = None
        self._snap_version += 1

    def _ensure_collector(self) -> None:
        """Install the per-shard event collector on first subscription —
        a service nobody listens to pays nothing per tick (the shard
        dispatchers' ``wants`` stays False)."""
        if self._collector_installed:
            return
        self._collector_installed = True
        # the collector holds the buffers, not the service: a closure over
        # ``self`` would make every subscribed service a reference cycle,
        # whose device tensors outlive ``del`` until the garbage collector
        # runs
        collected = self._collected
        for svc in self.shards:
            svc.events.subscribe(
                lambda ev: collected[ev.shard].append(ev),
                kinds=(TickCompleted, Evicted), isolate=False)

    def subscribe(self, fn, kinds=None, isolate: bool = True):
        """Register ``fn(event)`` on the cohort-level typed event stream
        (see :mod:`repro_torch.stream.events`): one ``TickCompleted`` per
        sharded tick with the per-shard delta feeds concatenated in
        shard-index order, ``Evicted`` per shard, ``Migrated`` /
        ``Rebalanced`` at migration time."""
        self._ensure_collector()
        return self.events.subscribe(fn, kinds=kinds, isolate=isolate)

    def subscribe_delta(self, fn) -> None:
        """Deprecated shim over :meth:`subscribe`: ``fn(keys, slot_idx,
        seq, dur)`` with the cohort's newly-mined rows once per sharded
        tick (rows are keyed by patient key, so migrations don't
        re-deliver)."""
        self.subscribe(lambda ev: fn(ev.keys, ev.slot_idx, ev.seq, ev.dur),
                       kinds=TickCompleted)

    def subscribe_tick(self, fn) -> None:
        """Deprecated shim over :meth:`subscribe`: ``fn(service)`` after
        every completed *sharded* tick (all shard waves collected,
        pending admits flushed) — the publication boundary for replicas.
        Fires *before* any auto-rebalance triggered by the tick: the
        journal needs the tick's record ahead of the migrations it
        triggers, and a pre-rebalance view is the same cohort content."""
        self.subscribe(lambda ev: fn(ev.service), kinds=TickCompleted)

    def _emit_tick_events(self) -> None:
        """Re-emit the tick's buffered per-shard events at the cohort
        boundary: evictions per shard, then one aggregated
        ``TickCompleted`` — all in shard-index order."""
        col = [list(evs) for evs in self._collected]
        for evs in self._collected:
            evs.clear()
        if not (self.events.wants(TickCompleted)
                or self.events.wants(Evicted)):
            return
        for evs in col:
            for ev in evs:
                if isinstance(ev, Evicted) and self.events.wants(Evicted):
                    self.events.emit(ev)
        if not self.events.wants(TickCompleted):
            return
        keys: list = []
        slots, seqs, durs = [], [], []
        for evs in col:
            for ev in evs:
                if isinstance(ev, TickCompleted):
                    slots.append(np.asarray(ev.slot_idx) + len(keys))
                    seqs.append(ev.seq)
                    durs.append(ev.dur)
                    keys.extend(ev.keys)
        self.events.emit(TickCompleted(
            tick=self._tick_count, service=self, keys=keys,
            slot_idx=(np.concatenate(slots) if slots
                      else np.zeros(0, np.int64)),
            seq=(np.concatenate(seqs) if seqs else np.zeros(0, np.int64)),
            dur=(np.concatenate(durs) if durs else np.zeros(0, np.int32)),
            shard=None))

    # --- ingest -------------------------------------------------------------
    def submit(self, key, dates, phenx) -> None:
        if len(np.asarray(dates).reshape(-1)) == 0:
            return
        if key not in self.pids:
            self.pids[key] = len(self.pids)
        shard = self.router.route(key)
        self.shards[shard].submit(key, dates, phenx)
        if self.events.wants(DeltaSubmitted):
            self.events.emit(DeltaSubmitted(
                key, np.asarray(dates, np.int32).reshape(-1),
                np.asarray(phenx, np.int32).reshape(-1), shard=shard))

    def tick(self) -> list[TickStats]:
        """One wave on every shard with queued work.  Empty list == all
        queues drained (and no migration state left in flight).

        ``'devices'`` placement dispatches every shard's wave before
        collecting any (each device mines while the host assembles the
        next shard's wave); ``'host'`` keeps the serial per-shard tick.
        Pending migration admits land here, at the tick boundary: shards
        with no admit dispatch first, so a destination's restore overlaps
        their mining instead of delaying it."""
        order = sorted(range(self.n_shards),
                       key=lambda s: bool(self._pending_admits[s]))
        sp = self.obs.tracer.begin("sharded.tick", cat="host")
        if self.placement == "devices":
            begun = []
            for s in order:
                self._flush_pending(s)
                svc = self.shards[s]
                if svc.queue:
                    p = svc.tick_begin()
                    if p is not None:
                        begun.append((s, svc, p))
            out = []
            for s, svc, p in begun:
                st = svc.tick_finish(p)
                self._busy_acc[s] += st.device_s
                out.append(st)
        else:
            out = []
            for s in order:
                self._flush_pending(s)
                svc = self.shards[s]
                if svc.queue:
                    st = svc.tick()
                    if st is not None:
                        self._busy_acc[s] += st.device_s
                        out.append(st)
        self.obs.tracer.finish(sp, shards=len(out))
        if out:
            self._invalidate_snapshot()
            self._tick_count += 1
            # cohort events fire *before* any auto-rebalance: the journal
            # must record the tick ahead of the migrations it triggers
            # (replay applies them in that order), and the pre-rebalance
            # view is the same cohort content
            self._emit_tick_events()
            if self.rebalance_every \
                    and self._tick_count % self.rebalance_every == 0:
                self.rebalance(busy_weights=self.shard_load()
                               if self.busy_weighted_rebalance else None)
        return out

    def run(self) -> list[TickStats]:
        out: list[TickStats] = []
        while any(svc.queue for svc in self.shards):
            out.extend(self.tick())
        # no queued work never means no parked work: a migrate() with
        # nothing left to mine would otherwise strand its patient in the
        # admit queue past the drain
        self._flush_pending()
        return out

    # --- migration / rebalancing --------------------------------------------
    def migrate(self, key, dst: int) -> None:
        """Hand a patient to shard ``dst``: queued deltas move in arrival
        order, then store history (spill format), sketch row (subtract/add)
        and mined corpus rows, and the router re-pins the key.  A no-op if
        the key already lives on ``dst``.

        With ``async_migration`` only phase 1 runs here — the source-side
        extract (host copies off the source device) — and the state parks
        in the destination's admit queue; the destination-side restore
        (plane growth, sketch scatter, a new slab shape) is paid
        at the next tick boundary, overlapped with the other shards'
        dispatched mining.  The router re-pins immediately, so submits
        after the handoff queue on the destination and mine only after its
        state has landed (the tick admits before assembling that shard's
        wave)."""
        if key not in self.pids:
            raise KeyError(f"unknown patient key {key!r}")
        if not 0 <= dst < self.n_shards:
            # before any mutation: a negative dst would otherwise index
            # shards[-1] and strand the state off-route
            raise ValueError(f"dst {dst} out of range [0, {self.n_shards})")
        if key in self._pending_keys:
            # the key's state is parked in an admit queue; land it so the
            # source below is a real shard, not the queue
            self._flush_pending()
        src = self.router.route(key)
        if src == dst:
            return
        t0 = time.perf_counter()
        sp = self.obs.tracer.begin("migrate", cat="migration",
                                   track=f"shard{src}", key=repr(key),
                                   src=src, dst=dst)
        src_svc, dst_svc = self.shards[src], self.shards[dst]
        queued = [d for d in src_svc.queue if d.key == key]
        if queued:
            src_svc.queue = deque(
                d for d in src_svc.queue if d.key != key)
            dst_svc.queue.extend(queued)
        state = None
        if key in src_svc.store.pids:
            state = src_svc.extract_patient(key)
            if self.async_migration:
                self._pending_admits[dst].append(state)
                self._pending_keys[key] = dst
            else:
                dst_svc.admit_patient(state)
        self.router.assign(key, dst)
        self.migrations.append((key, src, dst))
        if self.events.wants(Migrated):
            self.events.emit(Migrated(key, src=src, dst=dst, state=state))
        self.migration_wall_s += time.perf_counter() - t0
        self.obs.tracer.finish(sp)
        self._m_migrations.inc()
        self._invalidate_snapshot()

    def admit_patient(self, state: PatientState,
                      dst: int | None = None) -> int:
        """Admit an externally-extracted patient (cross-service handoff:
        ``extract_patient`` elsewhere, admit here).  Routes to ``dst``
        (or the router's home for the key), registers a global pid, pins
        the router, and emits :class:`Migrated` with ``src=None`` so
        feed consumers (the serving feature store) see the patient's
        already-mined rows arrive."""
        key = state.key
        if key in self.pids or key in self._pending_keys:
            raise ValueError(f"key {key!r} already admitted")
        dst = self.router.route(key) if dst is None else dst
        if not 0 <= dst < self.n_shards:
            raise ValueError(f"dst {dst} out of range [0, {self.n_shards})")
        self.pids[key] = len(self.pids)
        pid = self.shards[dst].admit_patient(state)
        self.router.assign(key, dst)
        self._invalidate_snapshot()
        if self.events.wants(Migrated):
            self.events.emit(Migrated(key, src=None, dst=dst, state=state))
        return pid

    def _flush_pending(self, shard: int | None = None) -> None:
        """Phase 2 of async migration: land parked patient states on their
        destination shard (all shards when ``shard`` is None).  Called per
        shard at the tick boundary, and by any whole-cohort read — a
        snapshot taken between migrate() and the next tick must already
        see the patient on its new home."""
        targets = range(self.n_shards) if shard is None else (shard,)
        for s in targets:
            pending = self._pending_admits[s]
            if not pending:
                continue
            t0 = time.perf_counter()
            sp = self.obs.tracer.begin("migration.admit", cat="migration",
                                       track=f"shard{s}", n=len(pending))
            for state in pending:
                self.shards[s].admit_patient(state)
                del self._pending_keys[state.key]
            pending.clear()
            self.admit_wall_s += time.perf_counter() - t0
            self.obs.tracer.finish(sp)
            self._invalidate_snapshot()
        self._m_pending.set(sum(len(p) for p in self._pending_admits))

    def _patient_costs(self, svc: StreamService) -> dict:
        """Per-patient mining cost on one shard: n^2 * BYTES_PER_PAIR over
        held patients (resident, host-spilled, or disk-demoted; disk
        counts come from the block index, no decode) — the dense
        pair-slab model of chunking / store eviction."""
        return {k: n ** 2 * chunking.BYTES_PER_PAIR
                for k, n in svc.store.event_counts().items()}

    def shard_loads(self) -> list[int]:
        """Resident pair-cost bytes per shard (the rebalance signal)."""
        self._flush_pending()
        return [sum(self._patient_costs(svc).values())
                for svc in self.shards]

    def shard_load(self) -> list[float]:
        """Device-timed busy fraction per shard over the window since the
        last poll (completion-read seconds / window elapsed, clamped to
        [0, 1]).  Unlike :meth:`shard_loads` this measures *observed* device
        occupancy, not the static pair-cost model: a shard whose device is
        slower, contended, or serving a pathological history mix reads hot
        even when its resident bytes look balanced.  The window resets on
        every call, so callers poll it like a rate counter; with nothing
        ticked since the last poll all fractions are 0."""
        now = time.perf_counter()
        window = max(now - self._busy_t0, 1e-9)
        fracs = [min(b / window, 1.0) for b in self._busy_acc]
        self._busy_acc = [0.0] * self.n_shards
        self._busy_t0 = now
        return fracs

    def rebalance(self, imbalance_threshold: float | None = None,
                  max_moves: int | None = None,
                  min_gain: float | None = None,
                  busy_weights: list[float] | None = None) -> list[tuple]:
        """Greedy LPT rebalancing: while the hottest shard's load exceeds
        ``imbalance_threshold`` x the mean, migrate its costliest patient
        that still lowers the maximum to the coldest shard.  Every move
        strictly decreases the load spread (sum of squares), so this
        terminates; returns the (key, src, dst) moves made.

        ``min_gain`` is the migration-cost hysteresis: a handoff pays host
        copies plus a new slab shape at the destination, so a move is
        only worth it when it lowers ``max(hot, cold)`` by more than
        ``min_gain`` x the mean load.  A borderline patient whose move
        would barely dent the imbalance stays put instead of ping-ponging
        between two near-equal shards on alternating rebalance passes.

        ``busy_weights`` (typically :meth:`shard_load` fractions) scales
        each shard's cost model by its observed device occupancy: weights
        are normalized to mean 1 and a patient's effective cost on shard
        ``s`` is ``bytes * w[s]`` — the same bytes cost more on a busy
        device, so patients drain toward shards that are measurably idle,
        not just byte-light.  All-zero weights (nothing ticked since the
        last poll) fall back to the unweighted model.  Weighted moves no
        longer strictly shrink the sum of squares (a patient's cost changes
        as it moves), so the loop carries an iteration safety cap."""
        thr = (self.imbalance_threshold if imbalance_threshold is None
               else imbalance_threshold)
        gain_floor = self.min_gain if min_gain is None else min_gain
        self._flush_pending()   # cost accounting needs every patient homed
        costs = [self._patient_costs(svc) for svc in self.shards]
        w = [1.0] * self.n_shards
        if busy_weights is not None:
            if len(busy_weights) != self.n_shards:
                raise ValueError(
                    f"busy_weights covers {len(busy_weights)} shards, "
                    f"service has {self.n_shards}")
            wmean = sum(busy_weights) / len(busy_weights)
            if wmean > 0:
                w = [bw / wmean for bw in busy_weights]
        loads = [sum(c.values()) * w[s] for s, c in enumerate(costs)]
        mean = sum(loads) / len(loads)
        moves: list[tuple] = []
        cap = 4 * sum(len(c) for c in costs) + 4  # weighted-cost safety cap
        while (max_moves is None or len(moves) < max_moves) \
                and len(moves) < cap:
            hot = max(range(len(loads)), key=loads.__getitem__)
            cold = min(range(len(loads)), key=loads.__getitem__)
            if loads[hot] <= thr * mean or loads[hot] == 0:
                break
            cands = [(c, k) for k, c in costs[hot].items()
                     if loads[cold] + c * w[cold] < loads[hot]
                     and loads[hot] - max(loads[hot] - c * w[hot],
                                          loads[cold] + c * w[cold])
                     > gain_floor * mean]
            if not cands:
                break
            c, key = max(cands, key=lambda t: t[0])
            self.migrate(key, cold)
            costs[cold][key] = costs[hot].pop(key)
            loads[hot] -= c * w[hot]
            loads[cold] += c * w[cold]
            moves.append((key, hot, cold))
        if moves:
            self._m_rebalances.inc()
            if self.events.wants(Rebalanced):
                self.events.emit(Rebalanced(tuple(moves)))
        return moves

    def sample_metrics(self) -> None:
        """Refresh snapshot-time gauges on every shard (store plane bytes /
        occupancy, sketch load factor) plus the sharded-level pending-admit
        queue depth.  Called by ``Telemetry``-aware snapshot paths, never
        per tick."""
        if not self.obs.enabled:
            return
        for svc in self.shards:
            svc.sample_metrics()
        self._m_pending.set(sum(len(p) for p in self._pending_admits))

    # --- checkpoint ---------------------------------------------------------
    def state_dict(self) -> dict:
        """Whole-sharded-service state: every shard's service state plus
        the cross-shard pieces a restored process needs to continue
        byte-identically — router pins (sticky-until-migrated homes),
        global pid table, *in-flight* migration payloads (pending admits
        are captured, not flushed: a checkpoint must not advance the
        schedule), migration history, and the tick counter that phases
        rebalancing."""
        def pack_patient(st: PatientState) -> dict:
            return {"key": encode_key(st.key),
                    "phenx": np.asarray(st.phenx),
                    "date": np.asarray(st.date),
                    "seq_ids": np.asarray(st.seq_ids),
                    "corpus_seq": np.asarray(st.corpus_seq),
                    "corpus_dur": np.asarray(st.corpus_dur)}
        return {
            "shards": [svc.state_dict() for svc in self.shards],
            "router_pinned": [[encode_key(k), int(s)]
                              for k, s in self.router.pinned.items()],
            "pids": [[encode_key(k), int(p)] for k, p in self.pids.items()],
            "pending_admits": [[pack_patient(st) for st in p]
                               for p in self._pending_admits],
            "migrations": [[encode_key(k), int(a), int(b)]
                           for k, a, b in self.migrations],
            "tick_count": self._tick_count,
        }

    def load_state_dict(self, state: dict) -> None:
        if len(state["shards"]) != self.n_shards:
            raise ValueError(f"checkpoint has {len(state['shards'])} shards, "
                             f"service has {self.n_shards}")
        for svc, st in zip(self.shards, state["shards"]):
            svc.load_state_dict(st)
        self.router.pinned = {decode_key(k): int(s)
                              for k, s in state["router_pinned"]}
        self.pids = {decode_key(k): int(p) for k, p in state["pids"]}
        self._pending_admits = [
            [PatientState(decode_key(d["key"]),
                          np.asarray(d["phenx"], np.int32),
                          np.asarray(d["date"], np.int32),
                          np.asarray(d["seq_ids"], np.int64),
                          np.asarray(d["corpus_seq"], np.int64),
                          np.asarray(d["corpus_dur"], np.int32))
             for d in p]
            for p in state["pending_admits"]]
        self._pending_keys = {st.key: s
                              for s, p in enumerate(self._pending_admits)
                              for st in p}
        self.migrations = [(decode_key(k), int(a), int(b))
                           for k, a, b in state["migrations"]]
        self._tick_count = int(state["tick_count"])
        self._invalidate_snapshot()

    # --- snapshot / queries -------------------------------------------------
    def _global_pids(self, svc: StreamService, local_pat: np.ndarray):
        """Translate one shard's local pids to global pids (via keys)."""
        if len(local_pat) == 0:
            return local_pat
        # pid_capacity, not n_patients: local pids are retired (never
        # reused) when a patient migrates out, so the dense range has holes
        lut = np.full(svc.store.pid_capacity, -1, np.int32)
        for key, lpid in svc.store.pids.items():
            lut[lpid] = self.pids[key]
        return lut[local_pat]

    def global_counts(self) -> np.ndarray:
        """The merged support table (summed on the mesh's first device, or
        the first shard's), cached alongside the snapshot — repeated
        same-version reads pay the merge once.  It is int64 on the host:
        the reference runs with 64-bit types on, where its sum of the
        int32 shard tables widens, and its snapshots, digests and merged
        tables carry that dtype."""
        self._flush_pending()   # an in-flight patient's ids are subtracted
        if self._gcounts is None:
            self._gcounts = counts_lib.to_host(merge_sharded_counts(
                [svc.sketch.counts for svc in self.shards],
                self.mesh)).astype(np.int64)
        return self._gcounts

    def snapshot(self) -> Snapshot:
        """Whole-cohort corpus (global pids) + merged support table."""
        self._flush_pending()   # in-flight corpus rows belong to no shard
        if self._snap is not None:
            return self._snap
        snaps = [svc.snapshot() for svc in self.shards]
        self._snap = Snapshot(
            seq=np.concatenate([s.seq for s in snaps]),
            dur=np.concatenate([s.dur for s in snaps]),
            patient=np.concatenate([
                self._global_pids(svc, s.patient)
                for svc, s in zip(self.shards, snaps)]).astype(np.int32),
            counts=self.global_counts(),
            n_buckets_log2=self.n_buckets_log2)
        return self._snap

    def pid_to_key(self) -> dict:
        return {pid: k for k, pid in self.pids.items()}

    def screened_keep(self, threshold: int,
                      snap: Snapshot | None = None) -> np.ndarray:
        """Hash-screen keep mask over the whole cohort's live corpus (the
        merged table; one-sided error)."""
        snap = snap if snap is not None else self.snapshot()
        return sparsity.screen_hash_from_counts(
            snap.seq, np.ones(len(snap.seq), bool), snap.counts, threshold,
            self.n_buckets_log2).cpu().numpy()

    def merged_counts(self, batch_counts) -> np.ndarray:
        """Global live table merged with batch-screen counts, summed on the
        first shard's device."""
        dev = self.shards[0].device
        return counts_lib.to_host(sparsity.merge_bucket_counts(
            torch.from_numpy(self.global_counts()).to(dev),
            as_tensor(batch_counts, torch.int32).to(dev)))
