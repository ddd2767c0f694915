"""Runtime telemetry for the mining stack (metrics, spans, specializations).

  * ``metrics`` — a registry of counters / gauges / exponential-bucket
    histograms with labels; near-zero-cost no-op when disabled;
  * ``trace``   — begin/finish span trees with per-shard tracks,
    exported as JSON or Chrome-trace format (chrome://tracing,
    Perfetto), optionally mirrored into ``torch.profiler`` traces;
  * ``telemetry`` — the per-session bundle of both, plus the
    :class:`RetraceTracker` that turns the hot functions' recorded shape
    specializations into a per-tick ``jit.retraces`` counter (the
    O(log) specialization invariant, measured).

Invariant: telemetry reads host-side scalars and timestamps only — it
never changes what is mined, byte for byte, on or off
(tests/test_torch_obs.py holds it against the reference).
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry, NOOP_METRIC,
                                     NOOP_REGISTRY, NoopRegistry)
from repro_torch.obs.telemetry import (NOOP, RetraceTracker,  # noqa: F401
                                       Telemetry, default_hot_functions,
                                       jit_cache_size, specialization_count)
from repro_torch.obs.trace import (NOOP_SPAN, NOOP_TRACER,  # noqa: F401
                                   NoopTracer, Span, SpanTracer)
