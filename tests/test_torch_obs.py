"""Telemetry in the port (repro_torch.obs) against the reference (repro.obs).

Twin of tests/test_obs.py: registry and span semantics, the Chrome-trace
round trip, no-op singletons that allocate nothing, mined bytes identical
with telemetry on and off (and identical to the reference's), the session
metrics of a streaming fit, and the shape-specialization budget over a
200-tick growing stream (the port's ``jit.retraces``).
"""
import json
import tracemalloc

import numpy as np
import pytest
import torch

from repro import obs as j_obs
from repro.api import MiningConfig as JConfig
from repro.api import MiningSession as JSession
from repro_torch import obs
from repro_torch.api import MiningConfig, MiningSession
from repro_torch.stream.service import StreamService
from tests.conftest import random_dbmart
from tests.torch_parity import assert_same, port_db

H = 10


def _drive(pkg):
    """The same metric operations on a fresh registry of ``pkg``."""
    reg = pkg.MetricsRegistry()
    c = reg.counter("ticks")
    c.inc()
    c.inc(4)
    g = reg.gauge("depth")
    g.set(7)
    g.set(3)
    h = reg.histogram("lat")
    for v in (2e-6, 3e-6, 1e-3, 5.0):
        h.observe(v)
    reg.counter("evts", shard=0).inc(3)
    reg.counter("evts", shard=1)
    return reg


def test_counter_gauge_histogram_semantics():
    reg = _drive(obs)
    assert reg.value("ticks") == 5 and reg.value("depth") == 3
    s = reg.histogram("lat").summary()
    assert s["count"] == 4 and s["min"] == 2e-6 and s["max"] == 5.0
    assert sum(s["buckets"].values()) == 4 and len(s["buckets"]) >= 3
    assert reg.snapshot() == _drive(j_obs).snapshot()


def test_registry_labels_and_same_object():
    reg = obs.MetricsRegistry()
    a0 = reg.counter("evts", shard=0)
    assert reg.counter("evts", shard=0) is a0
    assert reg.counter("evts", shard=1) is not a0
    a0.inc(3)
    assert reg.value("evts", shard=0) == 3 and reg.value("evts", shard=1) == 0
    with pytest.raises(TypeError):
        reg.gauge("evts", shard=0)      # kind change is an error
    snap = reg.snapshot()
    assert snap["evts{shard=0}"] == 3 and snap["evts{shard=1}"] == 0


def test_registry_reset_keeps_cached_references():
    reg = obs.MetricsRegistry()
    c = reg.counter("n")
    h = reg.histogram("t")
    c.inc(9)
    h.observe(1.0)
    reg.reset()
    assert c.value == 0 and h.count == 0 and h.summary()["buckets"] == {}
    c.inc()
    assert reg.value("n") == 1


def test_histogram_rejects_bad_config():
    with pytest.raises(ValueError):
        obs.Histogram(base=1.0)
    with pytest.raises(ValueError):
        obs.Histogram(scale=0.0)


def _spans(pkg):
    tr = pkg.SpanTracer()
    with tr.span("outer", track="main"):
        with tr.span("inner", track="main", n=3):
            pass
        with tr.span("inner2", track="main"):
            pass
    d0 = tr.begin("device", track="shard0")
    d1 = tr.begin("device", track="shard1")
    tr.finish(d1)                       # shard1 collected first
    c0 = tr.begin("collect", track="shard0")
    tr.finish(c0)
    tr.finish(d0)
    return tr


def _shape(forest):
    """A span forest without its times."""
    return [(n["name"], n["track"], n["args"], _shape(n["children"]))
            for n in forest]


def test_span_nesting_and_out_of_order_finish():
    tr = _spans(obs)
    forest = tr.to_json()
    assert _shape(forest) == _shape(_spans(j_obs).to_json())
    outer = next(n for n in forest if n["name"] == "outer")
    assert [c["name"] for c in outer["children"]] == ["inner", "inner2"]
    dev0 = next(n for n in forest if n["track"] == "shard0")
    assert [c["name"] for c in dev0["children"]] == ["collect"]
    assert all(n["t1"] >= n["t0"] for n in forest)
    assert tr.find("device", track="shard1")[0].t1 is not None


def test_chrome_trace_roundtrip(tmp_path):
    tr = obs.SpanTracer()
    with tr.span("tick", track="shard0", cat="host", pairs=12):
        pass
    with tr.span("tick", track="shard1", cat="device"):
        pass
    path = tmp_path / "trace.json"
    tr.dump_chrome_trace(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    spans = [e for e in evs if e["ph"] == "X"]
    assert {m["args"]["name"] for m in meta} == {"shard0", "shard1"}
    assert all(m["name"] == "thread_name" for m in meta)
    assert len(spans) == 2 and {s["tid"] for s in spans} == {m["tid"] for m in meta}
    assert next(s for s in spans if s["cat"] == "host")["args"] == {"pairs": 12}
    assert all(s["dur"] >= 0 and s["ts"] >= 0 for s in spans)


def test_profiler_annotations_reach_torch_profiler():
    tr = obs.SpanTracer(profiler_annotations=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sp = tr.begin("tick.device", track="stream")
        with tr.span("tick.collect", track="stream"):
            torch.ones(4).sum()
        tr.finish(sp)                   # closes after the nested span
    names = {e.key for e in prof.key_averages()}
    assert {"tick.device", "tick.collect"} <= names
    assert len(tr.spans) == 2


def test_noop_singletons_are_shared():
    assert obs.NOOP.metrics is obs.NOOP_REGISTRY
    assert obs.NOOP.tracer is obs.NOOP_TRACER
    assert not obs.NOOP.enabled
    r = obs.NOOP_REGISTRY
    assert r.counter("a") is r.gauge("b") is r.histogram("c", shard=1)
    assert r.counter("a") is obs.NOOP_METRIC
    assert obs.NOOP_TRACER.begin("x") is obs.NOOP_TRACER.begin("y")
    assert obs.NOOP.snapshot() == {}
    assert obs.NOOP_TRACER.to_chrome_trace()["traceEvents"] == []


def test_noop_hot_path_allocates_nothing():
    m = obs.NOOP_METRIC
    tracer = obs.NOOP_TRACER
    m.inc()
    m.set(1.0)
    m.observe(0.5)
    tracer.finish(tracer.begin("t"))
    tracemalloc.start()
    base = tracemalloc.take_snapshot()
    for _ in range(1000):
        m.inc()
        m.inc(2)
        m.set(3.5)
        m.observe(1e-3)
        s = tracer.begin("tick", track="shard0", pairs=1)
        tracer.finish(s)
    after = tracemalloc.take_snapshot()
    tracemalloc.stop()
    grown = sum(d.size_diff for d in after.compare_to(base, "lineno")
                if d.size_diff > 0)
    assert grown < 4096, f"no-op hot path grew {grown} bytes"


@pytest.mark.parametrize("engine", ["batch", "chunked", "files", "stream"])
def test_byte_identical_on_off(engine):
    rng = np.random.default_rng(len(engine))
    db = random_dbmart(rng, n_patients=10, max_events=12)
    frames = {}
    for tel in (False, True):
        cfg = dict(engine=engine, screen="hash", n_buckets_log2=H,
                   threshold=2, tick_patients=3, telemetry=tel)
        frames[tel] = MiningSession(MiningConfig(**cfg), device="cpu").fit(port_db(db))
    want = JSession(JConfig(**cfg)).fit(db)
    for a, b, w in zip(frames[False].arrays(), frames[True].arrays(), want.arrays()):
        assert_same(a, b, engine)
        assert_same(b, w, engine)
    assert_same(frames[False]._corpus.counts(), frames[True]._corpus.counts(), engine)
    assert frames[False].screen().n_kept == frames[True].screen().n_kept \
        == want.screen().n_kept


def test_session_accessors_require_telemetry():
    s = MiningSession(MiningConfig(), device="cpu")
    with pytest.raises(RuntimeError):
        s.metrics()
    with pytest.raises(RuntimeError):
        s.trace()
    s_on = MiningSession(MiningConfig(telemetry=True), device="cpu")
    assert s_on.metrics() == {}
    assert s_on.trace() is s_on.telemetry.tracer


def test_session_metrics_record_mining():
    db = random_dbmart(np.random.default_rng(5), n_patients=8, max_events=10)
    cfg = dict(engine="stream", telemetry=True, tick_patients=3, screen="hash",
               n_buckets_log2=H)
    s = MiningSession(MiningConfig(**cfg), device="cpu")
    s.fit(port_db(db))
    snap = s.metrics()
    js = JSession(JConfig(**cfg))
    js.fit(db)
    want = js.metrics()
    # every counter but the specialization count (process-wide sets and
    # caches) equals the reference's; the gauges are also sampled at the
    # end of the port's fit, whose service does not outlive it
    counters = [obs.metrics._fmt_key(k) for k, m in s.telemetry.metrics._metrics.items()
                if isinstance(m, obs.Counter)]
    keys = [k for k in counters if k != "jit.retraces"]
    assert set(snap) == set(want) and len(keys) > 5
    assert {k: snap[k] for k in keys} == {k: want[k] for k in keys}
    assert snap["sketch.set_columns"] > 0 and snap["store.plane_bytes"] > 0
    assert snap["stream.events"] == int(db.nevents.sum())
    assert snap["stream.tick.dispatch_s"]["count"] == snap["stream.ticks"]
    assert snap["store.admits"] == int((np.asarray(db.nevents) > 0).sum())
    fit_spans = s.trace().find("session.fit")
    assert len(fit_spans) == 1 and fit_spans[0].args["engine"] == "stream"
    n_ticks = snap["stream.ticks"]
    for name in ("tick.dispatch", "tick.device", "tick.collect"):
        assert len(s.trace().find(name)) == n_ticks


def test_tick_stats_split_populated_without_telemetry():
    svc = StreamService(tick_patients=4, n_buckets_log2=H, device="cpu")
    db = random_dbmart(np.random.default_rng(2), n_patients=6, max_events=8)
    for p in range(db.n_patients):
        n = int(db.nevents[p])
        if n:
            svc.submit(p, db.date[p, :n], db.phenx[p, :n])
    stats = svc.run()
    assert stats
    for st in stats:
        assert st.dispatch_s > 0 and st.collect_s > 0 and st.device_s >= 0
        assert st.dispatch_s + st.device_s + st.collect_s <= st.wall_s + 1e-6


def test_retrace_budget_over_growing_stream():
    """200 ticks of ever-growing histories: the geometric capacity policy
    keeps the hot functions' distinct shapes O(log total work), counted
    by the ``jit.retraces`` counter (a per-tick shape would show ~200)."""
    for fn in obs.default_hot_functions():
        fn.shapes.clear()               # count from nothing run before
    tel = obs.Telemetry()
    svc = StreamService(tick_patients=4, n_buckets_log2=H, telemetry=tel,
                        device="cpu")
    tracker = obs.RetraceTracker()
    rng = np.random.default_rng(9)
    n_ticks = 200
    total_events = 0
    for _ in range(n_ticks):
        for _ in range(int(rng.integers(1, 4))):
            k = int(rng.integers(6))
            n = int(rng.integers(1, 4))
            dates = np.arange(total_events, total_events + n, dtype=np.int32)
            svc.submit(k, dates, rng.integers(0, 5, n).astype(np.int32))
            total_events += n
        svc.run()
    snap = tel.metrics.snapshot()
    assert snap["stream.ticks"] >= n_ticks
    budget = 6 * int(np.ceil(np.log2(total_events + 2))) + 12
    assert 0 < snap["jit.retraces"] == tracker.sample() <= budget
    assert tracker.total() == obs.specialization_count(obs.default_hot_functions())


# --- serving metrics: recorded when on, the shared no-ops when off ----------
def _served_sessions(telemetry: bool):
    """The same cohort fitted by the port (on the CPU) and the reference."""
    rng = np.random.default_rng(59)
    db = random_dbmart(rng, n_patients=6, max_events=10)
    kw = dict(threshold=2, screen="hash", n_buckets_log2=H, telemetry=telemetry)
    port = MiningSession(MiningConfig(**kw), device="cpu")
    port.fit(port_db(db))
    ref = JSession(JConfig(**kw))
    ref.fit(db)
    return port, ref, int(np.unique(db.phenx[db.phenx >= 0])[0])


def test_serve_metrics_disabled_are_noop_singletons():
    """With telemetry off every serve.* instrument is the shared no-op,
    the session records nothing, and ``stats()`` still counts, as the
    reference's does."""
    from repro.serving.tspm import plan as j_plan
    from repro_torch.serving.tspm import plan

    session, ref, code = _served_sessions(telemetry=False)
    server = session.serve()
    for m in (server._m_queries, server._m_waves, server._m_occupancy,
              server._m_hits, server._m_misses, server._m_evictions,
              server._m_hit_ratio, server._m_staleness, server._m_wait,
              server._m_eval):
        assert m is obs.NOOP_METRIC
    assert server._tracer is obs.NOOP_TRACER
    server.query(plan().screen(2).starts_with(code))
    server.query(plan().screen(2).starts_with(code))
    st = server.stats()
    assert st["queries"] == 2 and st["cache_hits"] == 1
    assert session.telemetry.metrics.snapshot() == {}
    jserver = ref.serve()
    for _ in range(2):
        jserver.query(j_plan().screen(2).starts_with(code))
    assert st == jserver.stats()


def test_serve_metrics_and_spans_recorded():
    """With telemetry on the serve.* metrics and the serve.wait /
    serve.eval spans are recorded, and the metrics equal the reference's
    for the same queries."""
    from repro.serving.tspm import plan as j_plan
    from repro_torch.serving.tspm import plan

    session, ref, code = _served_sessions(telemetry=True)
    snaps = []
    for s, mk in ((session, plan), (ref, j_plan)):
        with s.serve() as server:
            p = mk().screen(2).starts_with(code)
            server.submit(p).result(timeout=60)
            server.query(p)
        snaps.append(s.telemetry.metrics.snapshot())
    snap = snaps[0]
    assert snap["serve.queries"] == 2
    assert snap["serve.waves"] == 1            # the second query was a hit
    assert snap["serve.cache.hits"] == 1
    assert snap["serve.cache.misses"] == 1
    assert snap["serve.cache.hit_ratio"] == 0.5
    assert snap["serve.batch_occupancy"]["count"] == 1
    assert snap["serve.eval_s"]["count"] == 2
    assert snap["serve.wait_s"]["count"] == 1  # only the submitted query
    serve_keys = sorted(k for k in snap if k.startswith("serve."))
    assert serve_keys == sorted(k for k in snaps[1] if k.startswith("serve."))
    for k in serve_keys:
        a, b = snap[k], snaps[1][k]
        if isinstance(a, dict):                # histograms: counts, not times
            assert a["count"] == b["count"], k
        else:
            assert a == b, k
    names = {s["name"] for s in session.trace().to_chrome_trace()["traceEvents"]
             if "name" in s}
    assert {"serve.eval", "serve.wait"} <= names
