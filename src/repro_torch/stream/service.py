"""Micro-batching streaming ingest service + snapshot queries.

Modeled on serving/engine.py's wave scheduler: ``(patient, events)`` deltas
queue up, each tick admits up to ``tick_patients`` *patient slots* — a
patient's queued deltas coalesce chronologically into its slot, so one
flooding patient fills one slot with one big delta instead of deferring
the rest of its queue tick after tick — pads the slots to a ``[B, D]``
batch and runs one ingest step on the service's device (the card unless
the caller asks for the CPU):

    admit -> append at cursors -> delta-mine [B, E, D] slab (tspm_delta)
          -> online sketch update (seq_hist) -> corpus log append

Shapes are bucketed (D and E round up to power-of-two multiples of the pad
multiple, capacities grow geometrically), so the hot functions run O(log)
distinct shapes, not one per tick (``obs.RetraceTracker`` counts them).

Snapshots expose the live corpus as flat (seq, dur, patient) arrays plus
the sketch's bucket table; ``starts_with`` / ``ends_with`` /
``min_duration`` masks come from core/queries and compose with the
hash-screen keep mask, exactly as on the batch path.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs as obs_lib
from repro_torch.core import chunking
from repro_torch.core import queries as queries_lib
from repro_torch.core import sparsity
from repro_torch.core.encoding import as_tensor
from repro_torch.storage.codec import decode_key, encode_key
from repro_torch.stream import counts as counts_lib
from repro_torch.stream import delta as delta_lib
from repro_torch.stream.events import DeltaSubmitted, Evicted, \
    EventDispatcher, Migrated, TickCompleted
from repro_torch.stream.store import PatientStore


def _pow2_bucket(n: int, pad_multiple: int) -> int:
    """Smallest power-of-two multiple of ``pad_multiple`` >= n (it bounds
    the slab shapes a growing stream runs to O(log))."""
    w = pad_multiple
    while w < n:
        w *= 2
    return w


@dataclasses.dataclass
class Delta:
    """One patient's new events (dates non-decreasing, and >= the dates
    already stored for the patient — streams arrive in time order)."""

    key: object
    dates: np.ndarray   # [d] int32
    phenx: np.ndarray   # [d] int32


class Snapshot(NamedTuple):
    """Flat live corpus + support table (masks all-true: only real pairs)."""

    seq: np.ndarray       # [N] int64
    dur: np.ndarray       # [N] int32
    patient: np.ndarray   # [N] int32 stable pids (admission order)
    counts: np.ndarray    # [2^H] int32 bucket support table
    n_buckets_log2: int


@dataclasses.dataclass
class TickStats:
    n_patients: int
    n_events: int
    n_pairs: int          # new pairs mined this tick (Delta * n work)
    wall_s: float         # begin-to-finish; concurrently-pending ticks on
                          # other shards overlap inside it, so summed
                          # per-shard walls exceed real elapsed time —
                          # sum dispatch_s + collect_s instead
    dispatch_s: float = 0.0   # host work in tick_begin (wave assembly +
                              # async enqueue); never overlaps (host-serial)
    collect_s: float = 0.0    # host work in tick_finish after the device
                              # completed (selection of the real rows,
                              # device-to-host copy, bookkeeping, eviction)
    device_s: float = 0.0     # dispatch-end -> the wait on an event
                              # recorded after the tick's last launch: the
                              # device-timed busy signal (an upper bound —
                              # a result collected late reads as busy
                              # through its idle tail)


@dataclasses.dataclass
class PendingTick:
    """A dispatched-but-uncollected tick: the mined slab and sketch fold
    are in flight on the service's device; ``tick_finish`` materializes
    them.  Lets a sharded tick enqueue every shard's mining before the
    first host-blocking read."""

    B: int
    pids: np.ndarray
    mined: object                 # Mined (device tensors, queued)
    sketch_pending: object        # counts_lib._PendingSketchUpdate
    n_old: np.ndarray
    n_new: np.ndarray
    t0: float   # begin time; the resulting TickStats.wall_s spans
                # begin-to-finish, so concurrently-pending ticks on other
                # shards overlap inside it (sum != aggregate busy time)
    t_disp: float = 0.0           # dispatch-end time (tick_begin return)
    span_device: object = None    # open obs device span (dispatch->ready)
    keys: list = None             # wave patient keys, aligned with pids —
                                  # delta subscribers need keys, not pids
    done: object = None           # CUDA event recorded after the tick's
                                  # last launch (None on the CPU)


@dataclasses.dataclass
class PatientState:
    """Everything a patient owns on a shard — the migration payload.

    ``phenx``/``date`` are in the store's host-spill format, ``seq_ids``
    is the sketch's sorted distinct-sequence set, and the corpus arrays
    are the patient's already-mined (seq, dur) pairs; local pids stay
    behind (the destination assigns a fresh one)."""

    key: object
    phenx: np.ndarray        # [n] int32 event codes
    date: np.ndarray         # [n] int32 event dates
    seq_ids: np.ndarray      # [k] int64 sorted distinct sequence ids
    corpus_seq: np.ndarray   # [m] int64 mined pairs
    corpus_dur: np.ndarray   # [m] int32


class SnapshotQueries:
    """Snapshot query surface shared by the single- and sharded-shard
    services: core/queries masks over ``snapshot()`` composed with the
    ``screened_keep`` hash-screen mask, exactly as on the batch path.
    Hosts need ``snapshot()``, ``screened_keep(threshold, snap)``,
    ``self.codec`` and ``self.fuse_duration`` (fused snapshot ids carry
    the bucket in the low bits; unpacking them raw reads garbage)."""

    def _base(self, threshold: int | None) -> tuple[Snapshot, np.ndarray]:
        snap = self.snapshot()
        keep = (np.ones(len(snap.seq), bool) if threshold is None
                else self.screened_keep(threshold, snap))
        return snap, keep

    def query_starts_with(self, phenx_id: int, threshold: int | None = None):
        snap, keep = self._base(threshold)
        return queries_lib.starts_with(
            snap.seq, phenx_id, self.codec,
            fused=self.fuse_duration).numpy() & keep

    def query_ends_with(self, phenx_id: int, threshold: int | None = None):
        snap, keep = self._base(threshold)
        return queries_lib.ends_with(
            snap.seq, phenx_id, self.codec,
            fused=self.fuse_duration).numpy() & keep

    def query_min_duration(self, days: int, threshold: int | None = None):
        snap, keep = self._base(threshold)
        return queries_lib.min_duration(snap.dur, days).numpy() & keep


class StreamService(SnapshotQueries):
    """Continuously-mined corpus: ingest deltas, query any time.

    The store planes, the sketch and every tick's slab live on ``device``
    (the card unless the caller passes ``'cpu'``); ``backend`` follows
    ``mining.resolve_backend``: 'auto' launches the ``tspm_delta`` kernel
    for the card and takes the plain version on the CPU.

    The reference's ``shard_tag`` and ``retrace_tracker`` parameters, which
    only its sharded service passes, are not taken here: this service is
    always the single, unlabelled shard (track ``"stream"``, events with
    ``shard=None``) and owns its specialization tracker."""

    def __init__(self, tick_patients: int = 8, codec: str = "bit",
                 backend: str = "auto", n_buckets_log2: int = 20,
                 budget_bytes: int | None = None, pad_multiple: int = 8,
                 fuse_duration: bool = False, bucket_days: int = 30,
                 max_slot_events: int = 512, device="cuda", telemetry=None,
                 shard_tag: int | None = None, retrace_tracker=None,
                 disk_bytes: int | None = None, disk_dir: str | None = None):
        self.tick_patients = tick_patients
        self.max_slot_events = max_slot_events
        self.codec = codec
        self.backend = backend
        self.fuse_duration = fuse_duration
        self.bucket_days = bucket_days
        self.device = torch.device(device)
        self.obs = telemetry if telemetry is not None else obs_lib.NOOP
        self.shard_tag = shard_tag
        self.events = EventDispatcher(self.obs)
        self.track = "stream" if shard_tag is None else f"shard{shard_tag}"
        labels = {} if shard_tag is None else {"shard": shard_tag}
        if disk_dir is not None and shard_tag is not None:
            # one blockstore per shard: a shared segment file would
            # interleave two shards' appends
            disk_dir = os.path.join(disk_dir, f"shard{shard_tag}")
        self.store = PatientStore(pad_multiple=pad_multiple,
                                  budget_bytes=budget_bytes, device=self.device,
                                  telemetry=self.obs, labels=labels,
                                  disk_bytes=disk_bytes, disk_dir=disk_dir)
        self.sketch = counts_lib.OnlineSupportSketch(n_buckets_log2,
                                                     device=self.device,
                                                     telemetry=self.obs,
                                                     labels=labels)
        self.queue: deque[Delta] = deque()
        self._corpus: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        # snapshot cache keyed (implicitly) on ``snapshot_version``: any
        # corpus/sketch mutation — tick, migration admit/extract, restore —
        # bumps the version and drops the cached gather, so two same-tick
        # snapshot() calls return the identical arrays
        self._snap: Snapshot | None = None
        self._snap_version = 0
        self.stats: list[TickStats] = []
        self._ticks_restored = 0    # ticks before the checkpoint we resumed
        self._retrace = retrace_tracker if retrace_tracker is not None \
            else (obs_lib.RetraceTracker() if self.obs.enabled else None)
        # metric objects resolved once; per-tick cost is inc/observe only
        m = self.obs.metrics
        self._m_ticks = m.counter("stream.ticks", **labels)
        self._m_events = m.counter("stream.events", **labels)
        self._m_pairs = m.counter("stream.pairs", **labels)
        self._m_retraces = m.counter("jit.retraces", **labels)
        self._m_dispatch = m.histogram("stream.tick.dispatch_s", **labels)
        self._m_collect = m.histogram("stream.tick.collect_s", **labels)
        self._m_device = m.histogram("stream.tick.device_s", **labels)
        self._m_queue = m.gauge("stream.queue_depth", **labels)

    # --- ingest -------------------------------------------------------------
    def submit(self, key, dates, phenx) -> None:
        dates = np.asarray(dates, np.int32).reshape(-1)
        phenx = np.asarray(phenx, np.int32).reshape(-1)
        if len(dates) == 0:
            return
        self.queue.append(Delta(key, dates, phenx))
        if self.events.wants(DeltaSubmitted):
            self.events.emit(DeltaSubmitted(key, dates, phenx,
                                            shard=self.shard_tag))

    def _next_wave(self) -> list[Delta]:
        """Slot-level admission: up to ``tick_patients`` patient slots, and
        queued deltas for an admitted patient coalesce into its slot
        (dates arrive in order, and the delta slab's triangular mask makes
        one concatenated delta mine the same pairs as its parts ticked
        separately).  A slot stops coalescing at ``max_slot_events`` —
        the wave's slab is padded to its *widest* slot, so an unbounded
        slot would multiply every other patient's slab row by the flood
        width — and once closed, the patient's remaining deltas defer in
        order.  A flood thus drains in O(total/max_slot_events) ticks
        (instead of one delta per tick), without inflating the batch."""
        slots: dict[object, list[Delta]] = {}
        width: dict[object, int] = {}
        closed: set = set()
        deferred: list[Delta] = []
        for _ in range(len(self.queue)):
            d = self.queue.popleft()
            held = slots.get(d.key)
            if d.key in closed:
                deferred.append(d)
            elif held is not None:
                if width[d.key] + len(d.dates) > self.max_slot_events:
                    closed.add(d.key)       # keep per-patient arrival order
                    deferred.append(d)
                else:
                    held.append(d)
                    width[d.key] += len(d.dates)
            elif len(slots) < self.tick_patients:
                slots[d.key] = [d]
                width[d.key] = len(d.dates)
            else:
                deferred.append(d)
        self.queue.extend(deferred)
        # one concat per slot, not per queued delta: a k-delta flood
        # coalesces in O(k), not O(k^2)
        return [ds[0] if len(ds) == 1 else Delta(
                    key, np.concatenate([d.dates for d in ds]),
                    np.concatenate([d.phenx for d in ds]))
                for key, ds in slots.items()]

    def tick(self) -> TickStats | None:
        """Ingest one padded wave; returns stats (None if queue empty)."""
        pending = self.tick_begin()
        return None if pending is None else self.tick_finish(pending)

    def tick_begin(self) -> PendingTick | None:
        """Assemble and *dispatch* one wave without collecting results.

        Everything device-side (append scatter, delta slab, sketch fold)
        is queued on the device; the cursors are host state, so nothing
        here reads the device back (the copies of pageable host arrays to
        the device may still wait on the stream, so part of the tick's
        device work can finish inside ``dispatch_s``).  ``tick_finish``
        must run before the next ``tick_begin`` on the *same* service (the
        corpus log and eviction are per-wave)."""
        wave = self._next_wave()
        if not wave:
            return None
        t0 = time.perf_counter()
        sp = self.obs.tracer.begin("tick.dispatch", cat="host",
                                   track=self.track)
        B = len(wave)
        pm = self.store.pad_multiple
        # slab widths bucket geometrically (powers of two over the pad
        # multiple), like the store planes: rounding to pad_multiple alone
        # yields a *linear* family of shapes as histories grow
        D = _pow2_bucket(max(len(d.dates) for d in wave), pm)
        new_phenx = np.zeros((B, D), np.int32)
        new_date = np.zeros((B, D), np.int32)
        n_new = np.zeros(B, np.int32)
        for i, d in enumerate(wave):
            n_new[i] = len(d.dates)
            new_phenx[i, : n_new[i]] = d.phenx
            new_date[i, : n_new[i]] = d.dates

        rows, pids = self.store.admit([d.key for d in wave])
        n_old = self.store.nevents[rows].copy()
        dev = self.device
        new_phenx_d = torch.from_numpy(new_phenx).to(dev)
        new_date_d = torch.from_numpy(new_date).to(dev)
        self.store.append(rows, new_phenx_d, new_date_d, n_new)

        # slab i-axis only needs the wave's own history extent, not the
        # longest patient in the whole store; clamped to the plane width
        # (itself geometric) so the slice below stays in bounds
        Ew = min(_pow2_bucket(int((n_old + n_new).max(initial=1)), pm),
                 self.store.max_events)
        rows_d = torch.from_numpy(rows.astype(np.int64)).to(dev)
        mined = delta_lib.delta_mine(
            self.store.phenx[rows_d, :Ew], self.store.date[rows_d, :Ew],
            torch.from_numpy(n_old).to(dev), torch.from_numpy(n_new).to(dev),
            new_phenx_d, new_date_d, codec=self.codec,
            fuse_duration=self.fuse_duration, bucket_days=self.bucket_days,
            backend=self.backend)
        sketch_pending = self.sketch.update_begin(pids, mined.seq, mined.mask)
        done = None
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        t_disp = time.perf_counter()
        self.obs.tracer.finish(sp, patients=B, events=int(n_new.sum()))
        # the device span stays open across the async gap; tick_finish
        # closes it at the completion wait
        sp_dev = self.obs.tracer.begin("tick.device", cat="device",
                                       track=self.track)
        return PendingTick(B, pids, mined, sketch_pending, n_old, n_new, t0,
                           t_disp, sp_dev, keys=[d.key for d in wave],
                           done=done)

    def tick_finish(self, pending: PendingTick) -> TickStats:
        """Collect a dispatched wave: select the slab's real rows on the
        device and copy only them to the host, finish the sketch's host
        bookkeeping, append the corpus log, evict."""
        B, mined, pids = pending.B, pending.mined, pending.pids
        # completion timing: wait on the event recorded after the tick's
        # *last* launch (the sketch fold, which depends on the mined slab),
        # so t_ready - t_disp times the dispatched chain itself, not the
        # host-serial collect work that follows
        if pending.done is not None:
            pending.done.synchronize()
        t_ready = time.perf_counter()
        if pending.span_device is not None:
            self.obs.tracer.finish(pending.span_device)
        sp = self.obs.tracer.begin("tick.collect", cat="host",
                                   track=self.track)
        self.sketch.update_finish(pending.sketch_pending)
        # row-major over [B, Ew, D], the reference's masked-selection order
        seq_d, dur_d, slot_d = chunking.real_rows(mined)
        seq_m, dur_m = seq_d.cpu().numpy(), dur_d.cpu().numpy()
        slot = slot_d.cpu().numpy().astype(np.int64)
        del seq_d, dur_d, slot_d
        self._corpus.append((seq_m, dur_m, pids[slot]))
        self._invalidate_snapshot()
        tick_ev = None
        if self.events.wants(TickCompleted) and pending.keys is not None:
            # the tick's newly-mined rows, keyed by patient *key* (slot
            # index into ``keys``), for incremental consumers; seq/dur are
            # the corpus log's own arrays — subscribers must not mutate
            tick_ev = TickCompleted(
                tick=self.n_ticks + 1, service=self, keys=pending.keys,
                slot_idx=slot, seq=seq_m, dur=dur_m, shard=self.shard_tag)

        evicted, demoted = self.store.evict_over_budget()
        if (evicted or demoted) and self.events.wants(Evicted):
            self.events.emit(Evicted(tuple(evicted), tuple(demoted),
                                     shard=self.shard_tag))
        t_end = time.perf_counter()
        st = TickStats(
            n_patients=B, n_events=int(pending.n_new.sum()),
            n_pairs=int(delta_lib.count_delta_pairs(pending.n_old,
                                                    pending.n_new)),
            wall_s=t_end - pending.t0,
            dispatch_s=pending.t_disp - pending.t0,
            collect_s=t_end - t_ready,
            device_s=t_ready - pending.t_disp)
        self.stats.append(st)
        self.obs.tracer.finish(sp, pairs=st.n_pairs)
        self._m_ticks.inc()
        self._m_events.inc(st.n_events)
        self._m_pairs.inc(st.n_pairs)
        self._m_dispatch.observe(st.dispatch_s)
        self._m_collect.observe(st.collect_s)
        self._m_device.observe(st.device_s)
        self._m_queue.set(len(self.queue))
        if self._retrace is not None:
            self._m_retraces.inc(self._retrace.sample())
        if tick_ev is not None:
            self.events.emit(tick_ev)
        return st

    def run(self) -> list[TickStats]:
        """Drain the queue; returns per-tick stats."""
        out = []
        while self.queue:
            out.append(self.tick())
        return out

    @property
    def n_ticks(self) -> int:
        """Lifetime tick count, surviving checkpoint/restore (``stats``
        holds only the ticks since this process started)."""
        return self._ticks_restored + len(self.stats)

    # --- change feed --------------------------------------------------------
    @property
    def snapshot_version(self) -> int:
        """Monotone corpus/sketch state version: bumps on every mutation
        that would change ``snapshot()`` (tick, migration admit/extract,
        restore).  Two calls at the same version return the identical
        cached snapshot; serving replicas key their published views (and
        staleness gauges) on it."""
        return self._snap_version

    def _invalidate_snapshot(self) -> None:
        self._snap = None
        self._snap_version += 1

    def subscribe(self, fn, kinds=None, isolate: bool = True):
        """Register ``fn(event)`` on this service's typed event stream
        (see :mod:`repro_torch.stream.events`); ``kinds`` filters to a
        SessionEvent subclass or iterable of them."""
        return self.events.subscribe(fn, kinds=kinds, isolate=isolate)

    def subscribe_delta(self, fn) -> None:
        """Deprecated shim over :meth:`subscribe`: ``fn(keys, slot_idx,
        seq, dur)`` per tick's newly-mined corpus rows (``slot_idx``
        indexes ``keys``).  New code should subscribe to
        :class:`~repro_torch.stream.events.TickCompleted` directly."""
        self.events.subscribe(
            lambda ev: fn(ev.keys, ev.slot_idx, ev.seq, ev.dur),
            kinds=TickCompleted)

    def subscribe_tick(self, fn) -> None:
        """Deprecated shim over :meth:`subscribe`: ``fn(service)`` after
        every completed tick — the publication boundary for
        snapshot-isolated read replicas.  New code should subscribe to
        :class:`~repro_torch.stream.events.TickCompleted` directly."""
        self.events.subscribe(lambda ev: fn(ev.service),
                              kinds=TickCompleted)

    def sample_metrics(self) -> None:
        """Set the snapshot-time gauges that are too costly per tick:
        plane occupancy / byte gauges (host ints) and the sketch bucket
        load factor (one device->host table copy).  Called by
        ``MiningSession.metrics()``, never from the tick hot path."""
        if not self.obs.enabled:
            return
        self.store.sample_metrics()
        self.sketch.sample_metrics()
        self._m_queue.set(len(self.queue))

    # --- migration handoff --------------------------------------------------
    def extract_patient(self, key) -> PatientState:
        """Withdraw a patient's full state (store history, sketch row,
        mined corpus rows) for handoff to another service.  Queued deltas
        are the caller's responsibility (the sharded router moves them)."""
        pid, ph, dt = self.store.extract(key)
        ids = self.sketch.extract_row(pid)
        cseq, cdur = self._extract_corpus(pid)
        self._invalidate_snapshot()
        return PatientState(key, ph, dt, ids, cseq, cdur)

    def admit_patient(self, state: PatientState) -> int:
        """Install a migrated patient under a fresh local pid; the inverse
        of ``extract_patient`` (extract there + admit here is exact: the
        two sketch tables transfer by subtract/add, the corpus rows move
        verbatim)."""
        pid = self.store.admit_state(state.key, state.phenx, state.date)
        self.sketch.admit_row(pid, state.seq_ids)
        if len(state.corpus_seq):
            self._corpus.append((
                np.asarray(state.corpus_seq, np.int64),
                np.asarray(state.corpus_dur, np.int32),
                np.full(len(state.corpus_seq), pid, np.int32)))
        self._invalidate_snapshot()
        if self.events.wants(Migrated):
            # an external handoff (the sharded service journals its own
            # migrations and keeps this silent by not subscribing here)
            self.events.emit(Migrated(state.key, src=None,
                                      dst=self.shard_tag or 0, state=state))
        return pid

    def _extract_corpus(self, pid: int) -> tuple[np.ndarray, np.ndarray]:
        """Split the live corpus log: returns (and removes) pid's rows.

        Blocks without the patient are kept by reference, so a migration
        only rewrites the log blocks the patient actually appears in (not
        the whole log per move, which would make rebalancing O(corpus))."""
        out_seq: list[np.ndarray] = []
        out_dur: list[np.ndarray] = []
        kept = []
        for bseq, bdur, bpat in self._corpus:
            sel = bpat == pid
            if sel.any():
                out_seq.append(bseq[sel])
                out_dur.append(bdur[sel])
                kept.append((bseq[~sel], bdur[~sel], bpat[~sel]))
            else:
                kept.append((bseq, bdur, bpat))
        self._corpus = kept
        if not out_seq:
            return np.zeros(0, np.int64), np.zeros(0, np.int32)
        return np.concatenate(out_seq), np.concatenate(out_dur)

    # --- checkpoint ---------------------------------------------------------
    def state_dict(self) -> dict:
        """Everything a restarted service needs to continue byte-identically:
        store residency (planes, tiers, clocks), the sketch, queued deltas
        in arrival order, and the flat mined corpus (concatenated — block
        boundaries are an internal detail; flat order is what snapshots
        expose and compaction already collapses them)."""
        if self._corpus:
            seq = np.concatenate([c[0] for c in self._corpus])
            dur = np.concatenate([c[1] for c in self._corpus])
            pat = np.concatenate([c[2] for c in self._corpus]).astype(np.int32)
        else:
            seq = np.zeros(0, np.int64)
            dur = pat = np.zeros(0, np.int32)
        return {
            "store": self.store.state_dict(),
            "sketch": self.sketch.state_dict(),
            "queue": [{"key": encode_key(d.key), "dates": d.dates,
                       "phenx": d.phenx} for d in self.queue],
            "corpus": {"seq": seq, "dur": dur, "patient": pat},
            "n_ticks": self.n_ticks,
        }

    def load_state_dict(self, state: dict) -> None:
        """Inverse of :meth:`state_dict`; takes the reference service's
        ``state_dict()`` too (its arrays turned to numpy), and continues
        exactly as the reference does."""
        self.store.load_state_dict(state["store"])
        self.sketch.load_state_dict(state["sketch"])
        self.queue = deque(
            Delta(decode_key(d["key"]),
                  np.asarray(d["dates"], np.int32),
                  np.asarray(d["phenx"], np.int32))
            for d in state["queue"])
        corpus = state["corpus"]
        seq = np.asarray(corpus["seq"], np.int64)
        self._corpus = ([(seq, np.asarray(corpus["dur"], np.int32),
                          np.asarray(corpus["patient"], np.int32))]
                        if len(seq) else [])
        # stats carry wall-clock timings, which are not state; only the
        # lifetime tick count survives a restore (checkpoint step numbering)
        self._ticks_restored = int(state.get("n_ticks", 0))
        self._invalidate_snapshot()

    # --- snapshot / queries -------------------------------------------------
    def snapshot(self) -> Snapshot:
        if self._snap is not None:
            return self._snap
        if self._corpus:
            seq = np.concatenate([c[0] for c in self._corpus])
            dur = np.concatenate([c[1] for c in self._corpus])
            pat = np.concatenate([c[2] for c in self._corpus]).astype(np.int32)
            self._corpus = [(seq, dur, pat)]   # compact: next tick appends
        else:
            seq = np.zeros(0, np.int64)
            dur = pat = np.zeros(0, np.int32)
        self._snap = Snapshot(seq, dur, pat,
                              counts_lib.to_host(self.sketch.counts),
                              self.sketch.n_buckets_log2)
        return self._snap

    def screened_keep(self, threshold: int,
                      snap: Snapshot | None = None) -> np.ndarray:
        """Hash-screen keep mask over the live corpus (one-sided error)."""
        snap = snap if snap is not None else self.snapshot()
        return self.sketch.keep_mask(
            snap.seq, np.ones(len(snap.seq), bool), threshold).cpu().numpy()

    def merged_counts(self, batch_counts) -> np.ndarray:
        """Live table merged with batch-screen counts (cold + hot cohorts)."""
        return counts_lib.to_host(sparsity.merge_bucket_counts(
            self.sketch.counts,
            as_tensor(batch_counts, torch.int32).to(self.sketch.device)))
