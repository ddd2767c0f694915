"""QueryServer: batched, cached query evaluation over read replicas.

The serving front end for mined corpora.  Clients hand in
:class:`~repro_torch.serving.tspm.plan.QueryPlan` chains; the server evaluates
them against the replica's current immutable view in fixed-size *waves* —
the admission idiom of the LM wave scheduler in ``serving/engine.py``,
retargeted from token steps to mask programs:

  * every plan's canonical vectorizable prefix is compiled to a tiny
    opcode/argument program (SCREEN / STARTS / ENDS / MINDUR descriptors);
  * the wave's distinct descriptors not yet in the view's predicate-row
    cache are evaluated by ONE batched predicate op (padded to the fixed
    batch size) on the view's device — the card unless the session runs
    on the CPU — and each plan's mask is the AND of its rows there, copied
    to the host once: at most one dispatch per wave instead of 2-4 per
    query, and zero once the view's working set of predicates is warm,
    which is where the batched p99 win comes from;
  * barrier suffixes (``transitive_ends_with`` / ``top_k``) are evaluated
    by injecting the batched prefix mask into a real ``SequenceFrame``
    chain on the view, so their semantics *cannot* drift from the frame's.

Results are keep masks cached in an LRU keyed on (canonical plan,
snapshot version) and wrapped in :class:`QueryResult` — a lazy frame over
the view the query actually ran against, so terminals (``collect``,
``decode``, ``to_features``) are point-in-time consistent even if the
live session has since ticked past the view.

Synchronous paths (``query`` / ``query_batch``) evaluate inline; the
background loop (``start`` / ``submit`` / ``stop``) drains a queue into
waves so concurrent clients share dispatches.  Every tensor the loop
thread makes names the view's device; the loop and the ingest thread share
the device's default stream, so a keep mask's copy to the host waits for
the tick work queued before it (on the host, queries still never block
``submit``/``tick``).  All serving state
updates flow into ``serve.*`` metrics and ``serve.wait`` / ``serve.eval``
spans on the session's telemetry (no-ops when disabled).
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from repro_torch.serving.tspm.cache import ResultCache
from repro_torch.serving.tspm.features import FeatureStore
from repro_torch.serving.tspm.plan import QueryPlan
from repro_torch.serving.tspm.replica import ReadReplica, uncompacted_rows
from repro_torch.stream.events import Migrated, TickCompleted

# wave-program opcodes (0 rows are padding: keep passes through unchanged)
_OP_NOOP, _OP_SCREEN, _OP_STARTS, _OP_ENDS, _OP_MINDUR = range(5)
_OP_CODE = {"screen": _OP_SCREEN, "starts_with": _OP_STARTS,
            "ends_with": _OP_ENDS, "min_duration": _OP_MINDUR}


#: rows of the columns one where chain covers at a time: it bounds the
#: chain's [B, tile] temporaries (at 2^28 rows and B = 32 one untiled
#: chain would hold several 8.6 GB tensors at once)
PRED_TILE = 1 << 24


def _pred_kernel(start, end, dur, screen, codes, args) -> torch.Tensor:
    """Evaluate [B] predicate descriptors over [Npad] corpus columns in one
    broadcast ``torch.where`` chain on the columns' device: row b is the
    boolean mask of descriptor ``(codes[b], args[b])``.  NOOP (padding)
    rows come back all-True.  ``codes``/``args`` are int32 tensors on the
    columns' device; the chain runs over tiles of ``PRED_TILE`` rows into
    one [B, Npad] output.

    Shapes are padded (Npad and B to fixed sizes); the wave evaluator only
    runs this for descriptors missing from the view's predicate-row cache,
    so steady-state waves dispatch nothing at all.
    """
    c, a = codes[:, None], args[:, None]
    n = start.shape[0]
    out = torch.empty((codes.shape[0], n), dtype=torch.bool,
                      device=start.device)
    for lo in range(0, n, PRED_TILE):
        sl = slice(lo, lo + PRED_TILE)
        out[:, sl] = torch.where(
            c == _OP_SCREEN, screen[sl] >= a, torch.where(
                c == _OP_STARTS, start[sl] == a, torch.where(
                    c == _OP_ENDS, end[sl] == a, torch.where(
                        c == _OP_MINDUR, dur[sl] >= a, True))))
    return out


_STOP = object()


class QueryResult:
    """One evaluated plan: the keep mask plus the view it ran against.

    ``frame`` lazily rebuilds a :class:`SequenceFrame` with the served
    mask injected, so every frame terminal works on the result —
    evaluated against the query's snapshot, not today's corpus.
    """

    __slots__ = ("view", "keep", "_frame")
    #: ``keep`` is a host numpy bool array of the view's ``n_rows``: the
    #: frame's terminals and every byte comparison read it there

    def __init__(self, view, keep: np.ndarray):
        self.view = view
        self.keep = keep
        self._frame = None

    @property
    def frame(self):
        if self._frame is None:
            keep = self.keep
            self._frame = self.view.frame._chain(
                ("served", lambda fr, k, keep=keep: k & keep))
        return self._frame

    @property
    def n_kept(self) -> int:
        return int(self.keep.sum())

    def collect(self):
        return self.frame.collect()

    def unique(self):
        return self.frame.unique()

    def decode(self, limit=None):
        return self.frame.decode(limit)

    def to_features(self, k=None, feature_ids=None):
        return self.frame.to_features(k, feature_ids=feature_ids)

    def __repr__(self):
        return (f"QueryResult({self.n_kept:,}/{self.view.n_rows:,} rows, "
                f"tick={self.view.tick})")


class Ticket:
    """A submitted query's future; ``result()`` blocks for the wave."""

    __slots__ = ("plan", "t_submit", "_event", "_result", "_error")

    def __init__(self, plan: QueryPlan):
        self.plan = plan
        self.t_submit = time.perf_counter()
        self._event = threading.Event()
        self._result = None
        self._error = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> QueryResult:
        if not self._event.wait(timeout):
            raise TimeoutError("query still queued; is the server running?")
        if self._error is not None:
            raise self._error
        return self._result


class QueryServer:
    """Serving façade over one :class:`MiningSession` (see module doc).

    Built by ``session.serve(...)``.  Construction wires the replica to
    the live service's tick hook (``auto_publish``) and, when
    ``feature_ids`` is given, bootstraps + subscribes the streaming
    feature store; do it from the ingest thread (no concurrent ticks).
    """

    def __init__(self, session, *, batch_size: int = 32,
                 cache_entries: int = 1024, feature_ids=None,
                 auto_publish: bool = True):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.session = session
        self.batch_size = int(batch_size)
        self.default_threshold = session.config.threshold

        tel = session.telemetry
        self._tracer = tel.tracer
        m = tel.metrics
        self._m_queries = m.counter("serve.queries")
        self._m_waves = m.counter("serve.waves")
        self._m_occupancy = m.histogram("serve.batch_occupancy")
        self._m_hits = m.counter("serve.cache.hits")
        self._m_misses = m.counter("serve.cache.misses")
        self._m_evictions = m.counter("serve.cache.evictions")
        self._m_hit_ratio = m.gauge("serve.cache.hit_ratio")
        self._m_staleness = m.gauge("serve.replica_staleness_ticks")
        self._m_wait = m.histogram("serve.wait_s")
        self._m_eval = m.histogram("serve.eval_s")

        self.cache = ResultCache(cache_entries)
        self._prev_hits = self._prev_misses = self._prev_evictions = 0
        self.feature_store = (FeatureStore(feature_ids)
                              if feature_ids is not None else None)
        self.replica = ReadReplica(session, feature_store=self.feature_store)
        self._auto_publish = bool(auto_publish)
        if self.feature_store is not None:
            seq, pkeys = uncompacted_rows(session)
            self.feature_store.stage_rows(pkeys, seq)
        svc = session.service
        if svc is not None:
            # one typed subscription covers both concerns: TickCompleted
            # carries the delta feed + publication boundary; Migrated
            # (src=None: external admit) carries already-mined rows that
            # never flow through any tick feed
            kinds = ([TickCompleted, Migrated]
                     if self.feature_store is not None
                     else [TickCompleted] if auto_publish else [])
            if kinds:
                svc.subscribe(self._on_event, kinds=tuple(kinds))
        self.replica.publish()

        self._eval_lock = threading.Lock()
        self._queue: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._running = False
        self._n_queries = 0
        self._n_waves = 0

    # --- publication --------------------------------------------------------
    def _on_event(self, ev) -> None:
        """Typed event subscriber (see :mod:`repro_torch.stream.events`)."""
        if isinstance(ev, TickCompleted):
            if self.feature_store is not None:
                self.feature_store.on_delta(ev.keys, ev.slot_idx,
                                            ev.seq, ev.dur)
            if self._auto_publish:
                self.publish()
        elif isinstance(ev, Migrated) and ev.src is None \
                and ev.state is not None and self.feature_store is not None:
            self.feature_store.on_admitted(ev.state)

    def publish(self):
        """Publish a fresh view and garbage-collect superseded cache
        entries.  Called automatically at tick boundaries."""
        view = self.replica.publish()
        self.cache.invalidate_below(view.version)
        self._m_staleness.set(0)
        return view

    def view(self):
        return self.replica.view()

    # --- synchronous evaluation ---------------------------------------------
    def query(self, p: QueryPlan) -> QueryResult:
        return self.query_batch([p])[0]

    def query_batch(self, plans) -> list[QueryResult]:
        plans = [self._resolve(p) for p in plans]
        return self._eval_wave(self.replica.view(), plans)

    def _resolve(self, p) -> QueryPlan:
        if not isinstance(p, QueryPlan):
            raise TypeError(f"expected a QueryPlan, got {type(p).__name__}")
        return p.resolve(self.default_threshold)

    # --- wave evaluation ----------------------------------------------------
    def _eval_wave(self, view, plans) -> list[QueryResult]:
        t0 = time.perf_counter()
        sp = self._tracer.begin("serve.eval", cat="host", track="serve",
                                n=len(plans))
        with self._eval_lock:
            keys = [p.canonical() for p in plans]
            masks: dict[tuple, np.ndarray] = {}
            need: dict[tuple, QueryPlan] = {}
            for p, key in zip(plans, keys):
                if key in need:
                    continue       # intra-wave duplicate: evaluate once
                got = self.cache.get((key, view.version))
                if got is not None:
                    masks[key] = got
                else:
                    need[key] = p
            miss = list(need.items())
            for i0 in range(0, len(miss), self.batch_size):
                chunk = miss[i0:i0 + self.batch_size]
                self._m_occupancy.observe(len(chunk) / self.batch_size)
                self._n_waves += 1
                self._m_waves.inc()
                for key, keep in self._eval_chunk(view, chunk):
                    masks[key] = keep
                    self.cache.put((key, view.version), keep)
            out = [QueryResult(view, masks[k]) for k in keys]
        self._tracer.finish(sp)
        self._m_eval.observe(time.perf_counter() - t0)
        self._n_queries += len(plans)
        self._m_queries.inc(len(plans))
        self._m_staleness.set(self.replica.staleness_ticks())
        self._sync_cache_metrics()
        return out

    def _eval_chunk(self, view, chunk):
        """Evaluate up to ``batch_size`` distinct (key, plan) pairs.

        The wave's distinct predicate descriptors missing from the view's
        predicate-row cache go through ONE batched predicate op on the
        view's device (padded to the batch size); each plan's mask is then
        the AND of its cached rows there, copied to the host once — work
        scales with *new* predicates, not with the dense ``B x L x N`` the
        padded wave would cost.  Barrier suffixes run through real frame
        chaining."""
        cols = view.columns()
        n = cols.n_rows
        dev = view.device
        cache = view.pred_cache
        progs = [(key, *p.split_canonical()) for key, p in chunk]
        missing = list({d for _, vec, _ in progs for d in vec} - cache.keys())
        for i0 in range(0, len(missing), self.batch_size):
            batch = missing[i0:i0 + self.batch_size]
            codes = np.zeros(self.batch_size, np.int32)
            args = np.zeros(self.batch_size, np.int32)
            for i, (kind, arg) in enumerate(batch):
                codes[i] = _OP_CODE[kind]
                args[i] = arg
            rows = _pred_kernel(cols.start, cols.end, cols.dur, cols.screen,
                                torch.from_numpy(codes).to(dev),
                                torch.from_numpy(args).to(dev))
            # keep only the real rows: a cached row must not hold the
            # padding rows of its dispatch alive
            rows = rows[:len(batch)].clone()
            for i, d in enumerate(batch):
                cache[d] = rows[i]
            del rows
        out = []
        valid_n = cols.valid[:n]
        for key, vec, suffix in progs:
            if vec:
                keep_d = valid_n.clone()
                for d in vec:
                    keep_d &= cache[d][:n]
                keep = keep_d.cpu().numpy()
            else:
                keep = None
            if suffix:
                keep = self._apply_suffix(view, keep, suffix)
            elif keep is None:
                keep = np.ones(n, bool)
            out.append((key, keep))
        return out

    def _apply_suffix(self, view, prefix_keep, suffix) -> np.ndarray:
        """Barrier ops run through the real frame chain — the batched
        prefix mask is injected as one AND op, then the frame's own
        transitive_ends_with / top_k do the rest (byte-identical by
        construction)."""
        fr = view.frame
        if prefix_keep is not None:
            pk = prefix_keep
            fr = fr._chain(("served_prefix", lambda f, k, pk=pk: k & pk))
        for kind, arg in suffix:
            fr = getattr(fr, kind)(arg)
        return fr.keep_mask()

    def _sync_cache_metrics(self) -> None:
        c = self.cache
        self._m_hits.inc(c.hits - self._prev_hits)
        self._m_misses.inc(c.misses - self._prev_misses)
        self._m_evictions.inc(c.evictions - self._prev_evictions)
        self._prev_hits, self._prev_misses = c.hits, c.misses
        self._prev_evictions = c.evictions
        self._m_hit_ratio.set(c.hit_ratio())

    # --- background serving loop --------------------------------------------
    def submit(self, p: QueryPlan) -> Ticket:
        """Queue a plan for the next wave; starts the loop on first use."""
        t = Ticket(self._resolve(p))
        if self._thread is None:
            self.start()
        self._queue.put(t)
        return t

    def start(self) -> "QueryServer":
        if self._thread is None:
            self._running = True
            self._thread = threading.Thread(
                target=self._serve_loop, name="tspm-query-server",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._running = False
        self._queue.put(_STOP)
        self._thread.join()
        self._thread = None

    def __enter__(self) -> "QueryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _serve_loop(self) -> None:
        while True:
            sp = self._tracer.begin("serve.wait", cat="host", track="serve")
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                self._tracer.finish(sp)
                if not self._running:
                    return
                continue
            stop = first is _STOP
            wave = [] if stop else [first]
            while not stop and len(wave) < self.batch_size:
                try:
                    t = self._queue.get_nowait()
                except queue.Empty:
                    break
                if t is _STOP:
                    stop = True
                    break
                wave.append(t)
            self._tracer.finish(sp, n=len(wave))
            if wave:
                now = time.perf_counter()
                for t in wave:
                    self._m_wait.observe(now - t.t_submit)
                try:
                    res = self._eval_wave(self.replica.view(),
                                          [t.plan for t in wave])
                    for t, r in zip(wave, res):
                        t._result = r
                        t._event.set()
                except BaseException as ex:   # surface on every ticket
                    for t in wave:
                        t._error = ex
                        t._event.set()
            if stop:
                return

    # --- feature serving / introspection ------------------------------------
    def features(self):
        """The streaming feature matrix of the current view (byte-identical
        to ``view.frame.to_features(feature_ids=...)`` on the snapshot)."""
        if self.feature_store is None:
            raise RuntimeError("server built without feature_ids; pass "
                               "session.serve(feature_ids=[...]) to stream "
                               "features")
        return self.feature_store.matrix(self.replica.view())

    def stats(self) -> dict:
        """Plain-number serving stats (works with telemetry disabled)."""
        c = self.cache
        return {"queries": self._n_queries,
                "waves": self._n_waves,
                "cache_hits": c.hits,
                "cache_misses": c.misses,
                "cache_evictions": c.evictions,
                "cache_hit_ratio": c.hit_ratio(),
                "cache_entries": len(c),
                "views_published": self.replica.published,
                "staleness_ticks": self.replica.staleness_ticks()}
