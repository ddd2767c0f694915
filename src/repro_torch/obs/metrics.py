"""Metrics registry: counters, gauges, exponential-bucket histograms.

The mining stack's quantitative claims (speedup, memory, O(log)
recompiles) need in-process measurement, not one-shot bench scripts; this
registry is the substrate.  Three metric kinds, all label-aware:

  * **Counter** — monotone accumulator (``inc``): ticks, events, pairs,
    evictions, migrations, kernel shape specializations (``jit.retraces``);
  * **Gauge** — last-value sample (``set``): queue depth, plane occupancy,
    resident bytes vs budget, sketch bucket load factor;
  * **Histogram** — exponential buckets (``observe``): tick latencies,
    where a mean hides the retrace spikes the geometric-growth policy is
    supposed to bound.

Hot-path contract: callers resolve metric objects **once** (construction
time) and call ``inc``/``set``/``observe`` per tick — no dict lookup, no
string formatting, no allocation on the instrumented path.  The same key
(name + labels) always resolves to the same object, so instrumentation in
two layers (service and its store) can share a counter.

Disabled telemetry swaps in :data:`NOOP_REGISTRY`, whose accessors return
one shared do-nothing metric (``__slots__ = ()``, methods are no-ops): an
uninstrumented and an instrumentation-disabled run execute the same
per-tick work minus three attribute calls.  Exactness is never at stake —
metrics only ever *read* host-side integers and floats.
"""
from __future__ import annotations

from bisect import bisect_left


def _key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted(labels.items())))


def _fmt_key(key: tuple) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone accumulator; ``inc(n)`` is the whole hot-path API."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """Last-value sample; ``set(v)`` overwrites."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Exponential-bucket histogram.

    Bucket ``i`` covers ``(scale * base**(i-1), scale * base**i]`` with an
    underflow bucket below ``scale`` and an overflow bucket past the last
    boundary.  Defaults (``base=2, scale=1e-6, n_buckets=40``) span 1 us
    to ~12.7 days — one configuration covers tick latencies and whole-run
    walls.  ``observe`` is one ``bisect`` into a precomputed boundary
    list: O(log buckets), allocation-free.
    """

    __slots__ = ("bounds", "buckets", "count", "sum", "min", "max")

    def __init__(self, base: float = 2.0, scale: float = 1e-6,
                 n_buckets: int = 40):
        if base <= 1.0 or scale <= 0 or n_buckets < 1:
            raise ValueError("need base > 1, scale > 0, n_buckets >= 1")
        self.bounds = [scale * base ** i for i in range(n_buckets)]
        self.buckets = [0] * (n_buckets + 1)   # +1 overflow
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, v) -> None:
        self.buckets[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v

    def summary(self) -> dict:
        out = {"count": self.count, "sum": self.sum,
               "min": self.min, "max": self.max, "buckets": {}}
        for i, n in enumerate(self.buckets):
            if n:
                le = (f"{self.bounds[i]:.3e}" if i < len(self.bounds)
                      else "+inf")
                out["buckets"][f"le={le}"] = n
        return out


class MetricsRegistry:
    """Name+labels -> metric object; one registry per telemetry session.

    The accessor for an existing key returns the *same* object (resolve
    once, mutate per tick); asking for the same key as a different kind is
    an error — a silent kind change would corrupt the snapshot.
    """

    enabled = True

    def __init__(self):
        self._metrics: dict = {}

    def _get(self, kind, name: str, labels: dict, **kw):
        key = _key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = kind(**kw)
        elif not isinstance(m, kind):
            raise TypeError(f"metric {_fmt_key(key)} already registered "
                            f"as {type(m).__name__}, not {kind.__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, base: float = 2.0, scale: float = 1e-6,
                  n_buckets: int = 40, **labels) -> Histogram:
        return self._get(Histogram, name, labels, base=base, scale=scale,
                         n_buckets=n_buckets)

    def value(self, name: str, **labels):
        """Current value of a counter/gauge (KeyError if never created)."""
        return self._metrics[_key(name, labels)].value

    def snapshot(self) -> dict:
        """JSON-ready flat dict: ``name{label=v,...}`` -> value/summary."""
        out = {}
        for key in sorted(self._metrics, key=_fmt_key):
            m = self._metrics[key]
            out[_fmt_key(key)] = (m.summary() if isinstance(m, Histogram)
                                  else m.value)
        return out

    def reset(self) -> None:
        """Zero every metric in place (objects stay valid: cached
        references held by instrumented code keep working)."""
        for key, m in self._metrics.items():
            if isinstance(m, Histogram):
                m.buckets = [0] * len(m.buckets)
                m.count = 0
                m.sum = 0.0
                m.min = m.max = None
            else:
                m.value = 0


class _NoopMetric:
    """Shared do-nothing Counter/Gauge/Histogram stand-in."""

    __slots__ = ()
    value = 0
    count = 0
    sum = 0.0
    min = None
    max = None

    def inc(self, n=1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass

    def summary(self) -> dict:
        return {"count": 0, "sum": 0.0, "min": None, "max": None,
                "buckets": {}}


NOOP_METRIC = _NoopMetric()


class NoopRegistry:
    """Disabled registry: every accessor returns the one shared no-op
    metric; nothing is recorded, nothing is allocated per call."""

    __slots__ = ()
    enabled = False

    def counter(self, name: str, **labels) -> _NoopMetric:
        return NOOP_METRIC

    def gauge(self, name: str, **labels) -> _NoopMetric:
        return NOOP_METRIC

    def histogram(self, name: str, **labels) -> _NoopMetric:
        return NOOP_METRIC

    def value(self, name: str, **labels):
        return 0

    def snapshot(self) -> dict:
        return {}

    def reset(self) -> None:
        pass


NOOP_REGISTRY = NoopRegistry()
