"""Span tracer: begin/finish span trees, JSON + Chrome-trace export.

Host walls lie under async dispatch: a sharded tick *begins* every
shard's wave before *collecting* any, so per-shard begin-to-finish
windows overlap and their sum exceeds real elapsed time
(``TickStats.wall_s``'s documented flaw).  Spans make the overlap
visible instead of silently double-counted: each instrumented region is
a ``(name, track, t0, t1)`` interval — ticks and migrations on a
sharded service emit *dispatch* (host wave assembly), *device*
(dispatch-end to completion-read; these overlap across shards under
device placement) and *collect* (host materialization) spans on a
per-shard track, so a Chrome-trace viewer shows the per-device rows
running concurrently.

Begin/finish are explicit (``begin`` returns the span; ``finish`` stamps
it) because async regions cross function boundaries — the dispatch side
opens the device span, the collect side closes it, possibly after other
shards' spans opened.  Synchronous regions use the ``span(...)`` context
manager.  Nesting is tracked per track: a span's parent is whatever span
was open on its track when it began, and out-of-order finishes are legal
(the open-stack removes by identity, not position).

Exports:

  * ``to_chrome_trace()`` — the Chrome trace-event JSON object
    (``chrome://tracing`` / Perfetto load it directly): one complete
    ("ph": "X") event per finished span, ``tid`` = track;
  * ``to_json()`` — the span forest as nested dicts (children inline),
    for programmatic assertions.

``profiler_annotations=True`` additionally wraps every span in
``torch.profiler.record_function`` (a no-op outside an active
``torch.profiler.profile`` capture), so spans line up with the kernels'
own timeline when profiling on the card.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager


class Span:
    """One timed interval; ``t1 is None`` while still open."""

    __slots__ = ("name", "cat", "track", "t0", "t1", "parent", "args",
                 "_annotation")

    def __init__(self, name, cat, track, t0, parent=None, args=None):
        self.name = name
        self.cat = cat
        self.track = track
        self.t0 = t0
        self.t1 = None
        self.parent = parent
        self.args = args or {}
        self._annotation = None

    @property
    def duration_s(self) -> float | None:
        return None if self.t1 is None else self.t1 - self.t0

    def __repr__(self):
        dur = self.duration_s
        return (f"Span({self.name!r}, track={self.track!r}, "
                f"dur={'open' if dur is None else f'{dur * 1e6:.0f}us'})")


def _profiler_annotation(name: str):
    """A ``torch.profiler.record_function`` region for ``name``."""
    import torch

    return torch.profiler.record_function(name)


class SpanTracer:
    """Collects spans relative to a construction-time epoch."""

    enabled = True

    def __init__(self, profiler_annotations: bool = False):
        self.epoch = time.perf_counter()
        self.profiler_annotations = profiler_annotations
        self.spans: list[Span] = []     # finished, finish order
        self._open: dict = {}           # track -> [open spans]

    def begin(self, name: str, cat: str = "host", track: str = "main",
              **args) -> Span:
        stack = self._open.setdefault(track, [])
        parent = stack[-1] if stack else None
        sp = Span(name, cat, track, time.perf_counter() - self.epoch,
                  parent=parent, args=args)
        if self.profiler_annotations:
            ann = _profiler_annotation(name)
            ann.__enter__()
            sp._annotation = ann
        stack.append(sp)
        return sp

    def finish(self, span: Span, **args) -> Span:
        span.t1 = time.perf_counter() - self.epoch
        if args:
            span.args.update(args)
        if span._annotation is not None:
            span._annotation.__exit__(None, None, None)
            span._annotation = None
        stack = self._open.get(span.track)
        if stack is not None and span in stack:
            stack.remove(span)
        self.spans.append(span)
        return span

    @contextmanager
    def span(self, name: str, cat: str = "host", track: str = "main",
             **args):
        sp = self.begin(name, cat, track, **args)
        try:
            yield sp
        finally:
            self.finish(sp)

    def reset(self) -> None:
        self.spans = []
        self._open = {}
        self.epoch = time.perf_counter()

    # --- export -------------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Chrome trace-event format (load in chrome://tracing/Perfetto).

        Tracks map to ``tid`` (sorted name order), so each shard renders
        as its own row; timestamps are microseconds since the epoch."""
        tracks = sorted({sp.track for sp in self.spans})
        tids = {t: i for i, t in enumerate(tracks)}
        events = [{"name": t, "ph": "M", "pid": 0, "tid": tid,
                   "args": {"name": t}}
                  for t, tid in tids.items()]
        # thread_name metadata needs its own name field
        for ev in events:
            ev["name"] = "thread_name"
        for sp in sorted(self.spans, key=lambda s: s.t0):
            ev = {"name": sp.name, "cat": sp.cat, "ph": "X", "pid": 0,
                  "tid": tids[sp.track], "ts": sp.t0 * 1e6,
                  "dur": (sp.duration_s or 0.0) * 1e6}
            if sp.args:
                ev["args"] = dict(sp.args)
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def to_json(self) -> list[dict]:
        """The finished-span forest as nested dicts (children inline)."""
        nodes = {id(sp): {"name": sp.name, "cat": sp.cat,
                          "track": sp.track, "t0": sp.t0, "t1": sp.t1,
                          "args": dict(sp.args), "children": []}
                 for sp in self.spans}
        roots = []
        for sp in sorted(self.spans, key=lambda s: s.t0):
            node = nodes[id(sp)]
            parent = nodes.get(id(sp.parent)) if sp.parent else None
            (parent["children"] if parent is not None else roots).append(node)
        return roots

    def find(self, name: str, track: str | None = None) -> list[Span]:
        """Finished spans by name (and track), begin order."""
        return sorted((sp for sp in self.spans if sp.name == name
                       and (track is None or sp.track == track)),
                      key=lambda s: s.t0)


class _NoopSpan:
    """Shared do-nothing span; its own context manager."""

    __slots__ = ()
    name = cat = track = ""
    t0 = t1 = 0.0
    duration_s = 0.0
    args: dict = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class NoopTracer:
    """Disabled tracer: records nothing, allocates nothing per call."""

    __slots__ = ()
    enabled = False
    spans: list = []

    def begin(self, name, cat="host", track="main", **args):
        return NOOP_SPAN

    def finish(self, span, **args):
        return span

    def span(self, name, cat="host", track="main", **args):
        return NOOP_SPAN

    def reset(self):
        pass

    def to_chrome_trace(self):
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def dump_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def to_json(self):
        return []

    def find(self, name, track=None):
        return []


NOOP_TRACER = NoopTracer()
