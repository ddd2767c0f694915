"""Telemetry session: one registry + one tracer + the specialization tracker.

A :class:`Telemetry` object is the unit the mining stack threads around:
``MiningSession`` builds one when ``MiningConfig.telemetry`` is set and
hands the *same* object to every layer it constructs (the service, its
store and sketch), so a whole session's counters land in one registry and
its spans on one timeline.  Disabled telemetry is the :data:`NOOP`
singleton — same attribute surface, no recording, no per-call allocation
— so instrumented code never branches.

:class:`RetraceTracker` measures the invariant the capacity policy
promises: the streaming hot path runs O(log) distinct shapes, not one per
tick (geometric capacity growth in the store and sketch and power-of-two
slab widths quantize every shape).  PyTorch runs eagerly and compiles
nothing per shape, so the port counts **shape specializations**: each hot
function records the distinct shapes it has run in a plain set beside it
(``fn.shapes``) — ``tspm_delta``'s ``(B, Ew, D)`` slab, the sketch fold's
``(B, C, T)`` and the store append's plane + batch shape.  The tracker
samples the sum of the set sizes and yields deltas, so a service can
increment its ``jit.retraces`` counter (the reference's name, kept so the
two packages' budget tests are twins) with exactly the new shapes each
tick ran.  The sets are process-wide, like the reference's jit caches.
"""
from __future__ import annotations

from repro_torch.obs.metrics import MetricsRegistry, NOOP_REGISTRY
from repro_torch.obs.trace import NOOP_TRACER, SpanTracer


def default_hot_functions() -> tuple:
    """The streaming ingest step's shape-recording functions (lazy import:
    obs must not import the stream package at module load)."""
    from repro_torch.stream import counts as counts_lib
    from repro_torch.stream import delta as delta_lib
    from repro_torch.stream import store as store_lib

    return (store_lib._append_step, counts_lib.sketch_update,
            delta_lib.delta_mine)


def specialization_count(fns) -> int:
    """Total distinct shapes recorded by the functions' ``shapes`` sets."""
    return sum(len(fn.shapes) for fn in fns)


# the reference's name: its count of compiled variants is the port's count
# of shape specializations (one per distinct shape either way)
jit_cache_size = specialization_count


class RetraceTracker:
    """Delta sampler over the hot functions' shape specializations.

    ``sample()`` returns new shapes since the previous sample (clamped at
    zero: the sets can be cleared externally) — call it once per tick and
    feed the delta to a counter.  The baseline is taken at construction,
    so shapes run *before* this service existed are never charged to it.
    """

    def __init__(self, fns=None):
        self.fns = tuple(fns) if fns is not None else default_hot_functions()
        self._last = specialization_count(self.fns)

    def total(self) -> int:
        return specialization_count(self.fns)

    def sample(self) -> int:
        now = specialization_count(self.fns)
        delta = max(0, now - self._last)
        self._last = now
        return delta


class Telemetry:
    """One telemetry session: ``.metrics`` registry + ``.tracer`` spans.

    ``profiler_annotations`` forwards to the tracer: spans additionally
    enter ``torch.profiler.record_function`` so they interleave with the
    kernels' timeline inside an active ``torch.profiler.profile``."""

    enabled = True

    def __init__(self, profiler_annotations: bool = False):
        self.metrics = MetricsRegistry()
        self.tracer = SpanTracer(profiler_annotations=profiler_annotations)

    def snapshot(self) -> dict:
        return self.metrics.snapshot()

    def reset(self) -> None:
        self.metrics.reset()
        self.tracer.reset()


class _NoopTelemetry:
    """Disabled telemetry: the same surface, nothing recorded."""

    __slots__ = ()
    enabled = False
    metrics = NOOP_REGISTRY
    tracer = NOOP_TRACER

    def snapshot(self) -> dict:
        return {}

    def reset(self) -> None:
        pass


NOOP = _NoopTelemetry()
