"""LRU result cache keyed on (canonical plan, snapshot version).

Correctness comes entirely from the key: a keep mask is a pure function of
the canonical plan and the immutable snapshot it ran against, so an entry
can never serve stale data — a new publication simply stops matching.
:meth:`ResultCache.invalidate_below` is therefore garbage collection, not
a correctness mechanism: the server calls it at publication to drop
entries no future lookup can hit.

Counters are plain ints (the server mirrors them into the obs registry),
so hit-ratio accounting works with telemetry disabled.  Thread safety is a
single lock around the OrderedDict — lookups are dwarfed by evaluation.
"""
from __future__ import annotations

import threading
from collections import OrderedDict


class ResultCache:
    """Bounded LRU of ``(plan_key, version) -> keep mask``."""

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = capacity
        self._od: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._od)

    def get(self, key):
        with self._lock:
            try:
                v = self._od.pop(key)
            except KeyError:
                self.misses += 1
                return None
            self._od[key] = v      # re-append: most recently used
            self.hits += 1
            return v

    def put(self, key, value) -> None:
        with self._lock:
            self._od.pop(key, None)
            self._od[key] = value
            while len(self._od) > self.capacity:
                self._od.popitem(last=False)
                self.evictions += 1

    def invalidate_below(self, version: int) -> int:
        """Drop entries for snapshots older than ``version`` (called at
        publication; superseded views can never be queried again).
        Returns the number of entries dropped."""
        with self._lock:
            stale = [k for k in self._od if k[1] < version]
            for k in stale:
                del self._od[k]
            return len(stale)

    def hit_ratio(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
