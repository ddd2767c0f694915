"""Typed session events: one subscription API for every mutation.

Services emit every mutation (a queued delta, a tick, an eviction, a
migration, a rebalance, a checkpoint) as one typed stream: frozen
``SessionEvent`` dataclasses through an :class:`EventDispatcher`, and
consumers register one ``subscribe(fn, kinds=...)`` callback for the
event kinds they care about.  The per-tick hooks
(``subscribe_tick(fn(service))`` and ``subscribe_delta(fn(keys,
slot_idx, seq, dur))``) are thin shims over the dispatcher.

Two properties the tick hot path relies on:

  * **pay-per-subscriber** — ``dispatcher.wants(Kind)`` gates payload
    assembly, so a service with no subscriber for ``TickCompleted``
    never materializes the per-tick delta feed;
  * **isolation** — a subscriber raising inside ``tick_finish`` would
    otherwise corrupt the tick (corpus appended, stats lost).  By
    default ``emit`` catches per-subscriber exceptions, logs them, and
    counts them on the ``events.subscriber_errors`` metric; consumers
    whose failure *must* propagate (an audit journal — a
    silently-dropped record is worse than a failed tick) subscribe with
    ``isolate=False``.
"""
from __future__ import annotations

import dataclasses
import logging
from collections import deque

import numpy as np

from repro_torch import obs as obs_lib

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SessionEvent:
    """Base of the event union; ``shard`` is the emitting shard's tag
    (None on a single-shard service and on cohort-level events)."""


@dataclasses.dataclass(frozen=True)
class DeltaSubmitted(SessionEvent):
    """A patient delta entered the ingest queue (pre-mining)."""

    key: object
    dates: np.ndarray    # [d] int32
    phenx: np.ndarray    # [d] int32
    shard: int | None = None


@dataclasses.dataclass(frozen=True)
class TickCompleted(SessionEvent):
    """One completed tick: the publication boundary for read replicas,
    plus the tick's newly-mined corpus rows keyed by patient key
    (``slot_idx`` indexes ``keys``) for incremental consumers.  On a
    sharded service this is the *cohort-level* tick (all shard waves
    collected, pending admits flushed) with per-shard payloads
    concatenated in shard-index order; ``service`` is the emitting
    service (sharded or single-shard)."""

    tick: int
    service: object
    keys: list
    slot_idx: np.ndarray   # [n] int — wave slot of each mined row
    seq: np.ndarray        # [n] int64 mined sequence ids
    dur: np.ndarray        # [n] int32 durations
    shard: int | None = None


@dataclasses.dataclass(frozen=True)
class Evicted(SessionEvent):
    """Patients spilled device -> host (``keys``) and host -> disk
    (``demoted``) by the byte-budget walk inside one tick."""

    keys: tuple
    demoted: tuple
    shard: int | None = None


@dataclasses.dataclass(frozen=True)
class Migrated(SessionEvent):
    """A patient changed homes.  ``src`` is the source shard, or None
    for an external admit (cross-service handoff) — in both cases
    ``state`` carries the admitted :class:`PatientState`, so consumers
    that only see the tick delta feed (the serving feature store) can
    pick up the patient's already-mined rows."""

    key: object
    src: int | None
    dst: int
    state: object


@dataclasses.dataclass(frozen=True)
class Rebalanced(SessionEvent):
    """One rebalance pass finished; ``moves`` is its (key, src, dst)
    list (each move already emitted as a :class:`Migrated`)."""

    moves: tuple


@dataclasses.dataclass(frozen=True)
class CheckpointTaken(SessionEvent):
    """A session checkpoint was written (step = lifetime tick count)."""

    step: int
    path: str


#: the full union, in a stable order (docs + journal framing)
EVENT_KINDS = (DeltaSubmitted, TickCompleted, Evicted, Migrated,
               Rebalanced, CheckpointTaken)


def _normalize_kinds(kinds):
    if kinds is None:
        return None
    if isinstance(kinds, type):
        return (kinds,)
    kinds = tuple(kinds)
    for k in kinds:
        if not (isinstance(k, type) and issubclass(k, SessionEvent)):
            raise TypeError(f"not a SessionEvent kind: {k!r}")
    return kinds


class EventDispatcher:
    """Per-service fan-out of :class:`SessionEvent` to subscribers."""

    def __init__(self, telemetry=None):
        self.obs = telemetry if telemetry is not None else obs_lib.NOOP
        self._subs: list[tuple] = []   # (fn, kinds|None, isolate)
        self._m_errors = self.obs.metrics.counter("events.subscriber_errors")

    def subscribe(self, fn, kinds=None, isolate: bool = True):
        """Register ``fn(event)`` for ``kinds`` (a SessionEvent subclass
        or iterable of them; None = every event).  ``isolate=True``
        (default) contains exceptions raised by ``fn``: they are logged
        and counted on ``events.subscriber_errors`` instead of
        corrupting the emitting tick."""
        self._subs.append((fn, _normalize_kinds(kinds), bool(isolate)))
        return fn

    def wants(self, kind) -> bool:
        """True when some subscriber would receive ``kind`` — emitters
        gate payload assembly on this, so unobserved events are free."""
        return any(kinds is None or issubclass(kind, kinds)
                   for _, kinds, _ in self._subs)

    def emit(self, event: SessionEvent) -> None:
        for fn, kinds, isolate in self._subs:
            if kinds is not None and not isinstance(event, kinds):
                continue
            if not isolate:
                fn(event)
                continue
            try:
                fn(event)
            except Exception:
                logger.exception(
                    "event subscriber %r failed on %s (dropped)",
                    fn, type(event).__name__)
                self._m_errors.inc()


class EventTap:
    """A pull-side buffer over an event source (a dispatcher or any
    service exposing ``subscribe``): ``MiningSession.events()`` returns
    one, and iterating it drains everything emitted since the last
    drain (bounded by ``maxlen`` — oldest events drop first)."""

    def __init__(self, source, kinds=None, maxlen: int | None = 4096):
        self._buf: deque = deque(maxlen=maxlen)
        source.subscribe(self._buf.append, kinds=kinds)

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self):
        while self._buf:
            yield self._buf.popleft()
