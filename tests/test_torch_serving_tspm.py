"""The port's query serving (``serving/tspm``) against the reference's, on the CPU.

Twin of tests/test_serving.py, one test for one: the plan IR
(canonicalization, barriers, ``resolve``, hashing), the batched server
against the frame-chain oracle over every engine, both screen modes, the
fused duration codec and threshold edges, the result cache (one entry for
equivalent plans, LRU, ``invalidate_below``, invalidation at publication),
result terminals and input validation, snapshot isolation (same-tick
identity single and sharded, publication at tick boundaries, staleness,
and the chaos test: queries racing ingest never see a partial tick), the
background loop, the streaming feature store and ``uncompacted_rows``.
Where a test has a deterministic result, the reference's server runs the
same plans on the same cohort and its keep masks, stats and feature
matrices must equal the port's byte for byte.

Beyond those: ``EvalColumns`` equal the reference's, padding included;
the predicate op equals the reference's ``_pred_kernel`` on random
columns and descriptors (NOOP padding included, and over several tiles);
and for one streaming schedule every plan's keep mask and every
``features()`` matrix equal the reference server's at every tick.
"""
import threading

import numpy as np
import pytest
import torch

from repro.api import MiningConfig as JConfig
from repro.api import MiningSession as JSession
from repro.data import dbmart, synthea
from repro.serving.tspm import QueryPlan as JPlan
from repro.serving.tspm import server as j_server
from repro.serving.tspm import uncompacted_rows as j_uncompacted_rows
from repro_torch.api import ENGINES, MiningConfig, MiningSession
from repro_torch.serving.tspm import (BARRIER_OPS, VECTOR_OPS, FeatureStore,
                                      QueryPlan, ResultCache, plan, server,
                                      uncompacted_rows)
from repro_torch.stream.service import StreamService
from repro_torch.stream.shard import ShardedStreamService
from tests.conftest import random_dbmart
from tests.test_api import H, fit_engine
from tests.test_serving import random_plans
from tests.test_stream_migration import chaos_replay
from tests.torch_parity import assert_same, port_db


def _kw(engine, tmp_path=None, tag="", **cfg_kw):
    kw = dict(engine=engine, n_buckets_log2=H, budget_bytes=48 << 10,
              tick_patients=3, threshold=3)
    kw.update(cfg_kw)
    if engine == "sharded":
        kw.setdefault("n_shards", 4)
    if engine == "files" and tmp_path is not None:
        kw.setdefault("spill_dir", str(tmp_path / f"spill_{engine}{tag}"))
    return kw


def fitted_pair(engine, db, tmp_path=None, **cfg_kw):
    """The same cohort fitted by the reference's session and the port's
    on the CPU."""
    ref = JSession(JConfig(**_kw(engine, tmp_path, "_ref", **cfg_kw)))
    ref.fit(db)
    port = MiningSession(MiningConfig(**_kw(engine, tmp_path, **cfg_kw)), device="cpu")
    port.fit(port_db(db))
    return ref, port


def to_port(p: JPlan) -> QueryPlan:
    return QueryPlan(p.ops)


def assert_serves_exactly(srv, plans, ref_srv=None):
    """Every plan through the port's batched server == the frame-chain
    oracle on the same view, and == the reference server's mask."""
    base = srv.view().frame
    thr = srv.default_threshold
    for jp in plans:
        p = to_port(jp)
        keep = srv.query(p).keep
        want = p.resolve(thr).apply(base).keep_mask()
        assert keep.dtype == want.dtype == np.bool_ and keep.shape == want.shape, str(p)
        assert keep.tobytes() == want.tobytes(), str(p)
        if ref_srv is not None:
            assert_same(keep, ref_srv.query(jp).keep, str(p))


def codes_of(db):
    return np.unique(db.phenx[db.phenx >= 0])


def stream_pair(**cfg):
    kw = dict(threshold=2, tick_patients=2, n_buckets_log2=H)
    kw.update(cfg)
    return JSession(JConfig(**kw)), MiningSession(MiningConfig(**kw), device="cpu")


def submit_all(sessions, db, patients):
    for s in sessions:
        for p in patients:
            n = int(db.nevents[p])
            s.submit(p, db.date[p, :n], db.phenx[p, :n])


# --- plan IR ----------------------------------------------------------------
def test_canonical_is_order_insensitive_and_dedups():
    a = plan().screen(2).starts_with(7).min_duration(30)
    b = plan().min_duration(30).starts_with(7).screen(2).starts_with(7)
    assert a.canonical() == b.canonical() == JPlan(b.ops).canonical()
    assert a.ops != b.ops
    assert plan().starts_with(7).starts_with(8).canonical() \
        != plan().starts_with(7).canonical()
    assert VECTOR_OPS == ("screen", "starts_with", "ends_with", "min_duration")
    assert BARRIER_OPS == ("transitive_ends_with", "top_k")


def test_barriers_pin_evaluation_order():
    a = plan().screen(2).top_k(4).min_duration(30)
    b = plan().min_duration(30).top_k(4).screen(2)
    assert a.canonical() != b.canonical()
    vec, suffix = a.split_canonical()
    assert vec == (("screen", 2),)
    assert suffix == (("top_k", 4), ("min_duration", 30))
    assert (vec, suffix) == JPlan(a.ops).split_canonical()
    vec, suffix = plan().screen(2).starts_with(1).split_canonical()
    assert suffix == () and len(vec) == 2


def test_resolve_fills_deferred_screen_or_raises():
    p = plan().screen().starts_with(3)
    assert p.resolve(5).ops[0] == ("screen", 5)
    assert p.resolve(5).resolve(9).ops[0] == ("screen", 5)
    assert p.resolve(5).ops == JPlan(p.ops).resolve(5).ops
    with pytest.raises(ValueError):
        p.resolve(None)
    with pytest.raises(ValueError):
        p.canonical()
    q = plan().screen(2)
    assert q.resolve(5) is q


def test_plan_hashable_and_printable():
    assert hash(plan().screen(2)) == hash(QueryPlan((("screen", 2),)))
    assert "screen(?)" in str(plan().screen())
    assert str(plan()) == "(all)"
    p = plan().screen().top_k(3).ends_with(4)
    assert str(p) == str(JPlan(p.ops))


# --- batched conformance: server == frame == the reference, every engine ----
@pytest.mark.parametrize("engine", ENGINES)
def test_serve_conformance_all_engines(tmp_path, engine):
    pats, dates, phx, _ = synthea.generate_cohort(n_patients=24, avg_events=12, seed=33)
    db = dbmart.from_rows(pats, dates, phx)
    rng = np.random.default_rng(100)
    ref, port = fitted_pair(engine, db, tmp_path, screen="hash")
    assert_serves_exactly(port.serve(batch_size=8), random_plans(rng, codes_of(db), n=24),
                          ref.serve(batch_size=8))


@pytest.mark.parametrize("screen", ["sorted", "fused"])
def test_serve_conformance_screen_modes(screen):
    rng = np.random.default_rng(300 + len(screen))
    db = random_dbmart(rng, n_patients=10, max_events=14)
    ref, port = fitted_pair("batch", db, screen=screen, threshold=2)
    assert_serves_exactly(port.serve(batch_size=4), random_plans(rng, codes_of(db), n=24),
                          ref.serve(batch_size=4))


def test_serve_conformance_fused_duration_codec():
    rng = np.random.default_rng(91)
    db = random_dbmart(rng, n_patients=9, max_events=12)
    for engine in ("batch", "stream"):
        ref, port = fitted_pair(engine, db, screen="hash", fuse_duration=True, threshold=2)
        assert_serves_exactly(port.serve(batch_size=8),
                              random_plans(rng, codes_of(db), n=16),
                              ref.serve(batch_size=8))


def test_serve_threshold_edges():
    """screen at 0, the exact max support, one past it, and huge: the
    predicate op's >= agrees with the frame's screen and the reference."""
    rng = np.random.default_rng(207)
    db = random_dbmart(rng, n_patients=10, max_events=14, n_codes=5)
    sup = fit_engine("batch", db, threshold=1, screen="hash").collect().support
    assert len(sup), "degenerate cohort"
    thr = int(sup.max())
    ref, port = fitted_pair("batch", db, screen="hash", threshold=1)
    srv = port.serve()
    code = int(codes_of(db)[0])
    edges = [JPlan().screen(t) for t in (0, 1, thr, thr + 1, 10**9)]
    edges += [JPlan().screen(t).starts_with(code) for t in (thr, thr + 1)]
    assert_serves_exactly(srv, edges, ref.serve())
    assert srv.query(plan().screen(10**9)).n_kept == 0


def test_equivalent_plans_share_one_cache_entry():
    rng = np.random.default_rng(5)
    db = random_dbmart(rng, n_patients=8, max_events=12)
    _, port = fitted_pair("batch", db, screen="hash")
    srv = port.serve()
    c = int(codes_of(db)[0])
    a = srv.query(plan().screen(2).starts_with(c).min_duration(10))
    h0 = srv.stats()["cache_hits"]
    b = srv.query(plan().min_duration(10).screen(2).starts_with(c))
    assert srv.stats()["cache_hits"] == h0 + 1
    assert a.keep.tobytes() == b.keep.tobytes()
    assert len(srv.cache) == 1


def test_query_result_terminals_match_frame():
    rng = np.random.default_rng(11)
    db = random_dbmart(rng, n_patients=8, max_events=12)
    ref, port = fitted_pair("batch", db, screen="hash")
    srv, jsrv = port.serve(), ref.serve()
    c = int(codes_of(db)[0])
    p = plan().screen(2).starts_with(c)
    r, jr = srv.query(p), jsrv.query(JPlan(p.ops))
    want = p.resolve(3).apply(srv.view().frame)
    for a, b, j in zip(r.collect(), want.collect(), jr.collect()):
        assert_same(a, b)
        assert_same(a, np.asarray(j))
    assert r.n_kept == want.n_kept == jr.n_kept
    ids, sup = r.unique()
    wids, wsup = want.unique()
    assert_same(ids, wids)
    assert_same(sup, wsup)
    assert repr(r) == repr(jr)
    f, jf = r.to_features(k=3), jr.to_features(k=3)
    assert_same(f.x, np.asarray(jf.x))


def test_server_input_validation():
    rng = np.random.default_rng(2)
    db = random_dbmart(rng, n_patients=6, max_events=8)
    _, port = fitted_pair("batch", db)
    with pytest.raises(ValueError):
        port.serve(batch_size=0)
    srv = port.serve()
    with pytest.raises(TypeError):
        srv.query("screen")
    with pytest.raises(RuntimeError):
        srv.features()


# --- snapshot isolation -----------------------------------------------------
def test_snapshot_same_tick_identity_single_shard():
    svc = StreamService(tick_patients=2, n_buckets_log2=H, device="cpu")
    svc.submit(0, [1, 2], [5, 6])
    svc.submit(1, [3], [7])
    svc.tick()
    v = svc.snapshot_version
    s1 = svc.snapshot()
    assert svc.snapshot() is s1
    svc.submit(0, [4], [8])
    assert svc.snapshot() is s1 and svc.snapshot_version == v
    svc.tick()
    assert svc.snapshot_version > v
    s2 = svc.snapshot()
    assert s2 is not s1 and svc.snapshot() is s2
    v2 = svc.snapshot_version
    state = svc.extract_patient(0)
    assert svc.snapshot_version > v2
    assert svc.snapshot() is not s2
    svc.admit_patient(state)
    assert svc.snapshot() is svc.snapshot()


def test_snapshot_same_tick_identity_sharded():
    svc = ShardedStreamService(n_shards=2, tick_patients=2, n_buckets_log2=H,
                               device="cpu")
    svc.submit(0, [1, 2], [5, 6])
    svc.submit(1, [3, 4], [7, 8])
    svc.run()
    s1 = svc.snapshot()
    assert svc.snapshot() is s1
    v = svc.snapshot_version
    svc.migrate(0, 1 - svc.router.route(0))
    assert svc.snapshot_version > v
    assert svc.snapshot() is not s1


def test_replica_publishes_at_tick_boundaries():
    rng = np.random.default_rng(17)
    db = random_dbmart(rng, n_patients=6, max_events=10)
    ref, port = stream_pair()
    srv, jsrv = port.serve(), ref.serve()
    v0, jv0 = srv.view(), jsrv.view()
    assert srv.view() is v0
    submit_all((port, ref), db, range(db.n_patients))
    port.service.tick()
    ref.service.tick()
    v1, jv1 = srv.view(), jsrv.view()
    assert v1 is not v0
    assert v1.tick == port.service.n_ticks
    assert v1.version == port.service.snapshot_version
    assert srv.replica.staleness_ticks() == 0
    assert v0.n_rows <= v1.n_rows
    for v, jv in ((v0, jv0), (v1, jv1)):
        assert (v.tick, v.version, v.n_rows) == (jv.tick, jv.version, jv.n_rows)


def test_manual_publish_and_staleness():
    rng = np.random.default_rng(19)
    db = random_dbmart(rng, n_patients=6, max_events=10)
    ref, port = stream_pair()
    srv, jsrv = port.serve(auto_publish=False), ref.serve(auto_publish=False)
    submit_all((port, ref), db, range(db.n_patients))
    ticks_before = srv.view().tick
    port.service.run()
    ref.service.run()
    assert srv.view().tick == ticks_before
    assert srv.replica.staleness_ticks() == port.service.n_ticks - ticks_before \
        == jsrv.replica.staleness_ticks()
    srv.publish()
    assert srv.replica.staleness_ticks() == 0
    assert srv.view().tick == port.service.n_ticks


def test_chaos_queries_never_see_partial_ticks():
    """Client threads query the background server while the ingest thread
    replays the migration-chaos schedule: every result equals the frame
    chain on the view it reports, that view is one a tick boundary
    published, each client's ticks never go back, and the final corpus
    answers as the reference's run of the same schedule does."""
    rng = np.random.default_rng(4242)
    db = random_dbmart(rng, n_patients=8, max_events=12)
    codes = codes_of(db)
    kw = dict(engine="sharded", n_shards=2, threshold=2, tick_patients=2, n_buckets_log2=H)
    session = MiningSession(MiningConfig(**kw), device="cpu")
    srv = session.serve(batch_size=4)

    published = {}

    def record(svc):
        c = session.frame()._corpus
        published[svc.snapshot_version] = (c.seq.tobytes(), c.dur.tobytes(),
                                           c.patient.tobytes())
    session.service.subscribe_tick(record)
    record(session.service)

    plans = [to_port(p) for p in random_plans(np.random.default_rng(1), codes, n=48)]
    results: list[list] = [[] for _ in range(4)]

    def client(i):
        r = np.random.default_rng(i)
        for _ in range(12):
            p = plans[int(r.integers(len(plans)))]
            results[i].append((p, srv.submit(p).result(timeout=120)))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    srv.start()
    for t in threads:
        t.start()
    chaos_replay(db, session.service, np.random.default_rng(7))
    for t in threads:
        t.join()
    srv.stop()

    checked = 0
    for chunk in results:
        ticks = [r.view.tick for _, r in chunk]
        assert ticks == sorted(ticks), "a client saw time go backwards"
        for p, r in chunk:
            assert r.keep.tobytes() == p.resolve(2).apply(r.view.frame).keep_mask().tobytes()
            assert r.view.version in published
            c = r.view.frame._corpus
            assert (c.seq.tobytes(), c.dur.tobytes(), c.patient.tobytes()) == \
                published[r.view.version]
            checked += 1
    assert checked == 48
    ref = JSession(JConfig(**kw))
    jsrv = ref.serve(batch_size=4)
    ref._ensure_service()
    chaos_replay(db, ref.service, np.random.default_rng(7))
    srv.publish()
    jsrv.publish()
    assert_serves_exactly(srv, [JPlan(p.ops) for p in plans[:12]], jsrv)


# --- background loop --------------------------------------------------------
def test_submit_matches_sync_query_and_context_manager():
    rng = np.random.default_rng(23)
    db = random_dbmart(rng, n_patients=8, max_events=12)
    ref, port = fitted_pair("batch", db, screen="hash")
    plans = [to_port(p) for p in random_plans(rng, codes_of(db), n=16)]
    with port.serve(batch_size=4) as srv:
        tickets = [srv.submit(p) for p in plans]
        got = [t.result(timeout=60) for t in tickets]
    base = srv.view().frame
    jsrv = ref.serve(batch_size=4)
    for p, r in zip(plans, got):
        assert r.keep.tobytes() == p.resolve(3).apply(base).keep_mask().tobytes()
        assert_same(r.keep, jsrv.query(JPlan(p.ops)).keep)
    st = srv.stats()
    assert st["queries"] >= len(plans)
    assert 0 < st["waves"] <= st["queries"]


def test_background_errors_surface_on_tickets():
    rng = np.random.default_rng(29)
    db = random_dbmart(rng, n_patients=6, max_events=8)
    _, port = fitted_pair("batch", db)
    srv = port.serve()
    boom = RuntimeError("kernel exploded")

    def bad_wave(view, plans):
        raise boom
    srv._eval_wave = bad_wave
    t = srv.submit(plan().screen(2))
    with pytest.raises(RuntimeError, match="kernel exploded"):
        t.result(timeout=60)
    srv.stop()


# --- result cache -----------------------------------------------------------
def test_result_cache_lru_semantics():
    c = ResultCache(capacity=2)
    with pytest.raises(ValueError):
        ResultCache(capacity=0)
    a, b, d = (np.ones(1), np.zeros(1), np.ones(2))
    c.put(("a", 0), a)
    c.put(("b", 0), b)
    assert c.get(("a", 0)) is a
    c.put(("d", 0), d)
    assert c.get(("b", 0)) is None
    assert c.get(("d", 0)) is d
    assert (c.hits, c.misses, c.evictions) == (2, 1, 1)
    assert c.hit_ratio() == pytest.approx(2 / 3)
    assert len(c) == 2


def test_result_cache_invalidate_below_is_gc():
    c = ResultCache(capacity=8)
    for v in range(4):
        c.put((("screen", 2), v), np.ones(1))
    assert c.invalidate_below(2) == 2
    assert len(c) == 2
    assert c.get((("screen", 2), 1)) is None
    assert c.get((("screen", 2), 3)) is not None


def test_publication_invalidates_server_cache():
    rng = np.random.default_rng(31)
    db = random_dbmart(rng, n_patients=6, max_events=10)
    ref, port = stream_pair()
    servers = (port.serve(), ref.serve())
    submit_all((port, ref), db, range(3))
    port.service.run()
    ref.service.run()
    p = plan().screen(2)
    for srv in servers:
        srv.query(p if srv is servers[0] else JPlan(p.ops))
        m0 = srv.stats()["cache_misses"]
        srv.query(p if srv is servers[0] else JPlan(p.ops))
        assert srv.stats()["cache_misses"] == m0
    submit_all((port, ref), db, range(3, db.n_patients))
    port.service.run()
    ref.service.run()
    for srv in servers:
        r = srv.query(p if srv is servers[0] else JPlan(p.ops))
        assert srv.stats()["cache_misses"] == m0 + 1
        assert len(srv.cache) == 1
    assert servers[0].stats() == servers[1].stats()
    assert_same(servers[0].query(p).keep, servers[1].query(JPlan(p.ops)).keep)
    assert r.n_kept == servers[0].query(p).n_kept


# --- streaming feature store ------------------------------------------------
def _feature_ids_for(db):
    fr = fit_engine("batch", db, threshold=1, screen="hash")
    ids = np.unique(np.asarray(fr._corpus.seq))
    picked = ids[:: max(1, len(ids) // 12)]
    return np.unique(np.concatenate([picked, [int(ids.max()) + 7]])).astype(np.int64)


def assert_features_identical(srv, ids, ref_srv=None):
    got = srv.features()
    want = srv.view().frame.to_features(feature_ids=ids)
    for a, b in zip(got, want):
        assert_same(a, b)
    assert got.x.device.type == "cpu"
    if ref_srv is not None:
        ref = ref_srv.features()
        assert_same(got.x, np.asarray(ref.x), "x")
        assert_same(got.feature_ids, np.asarray(ref.feature_ids), "ids")
        assert int(got.n_features) == int(ref.n_features)


@pytest.mark.parametrize("screen", ["hash", "fused"])
def test_feature_store_tracks_every_tick(screen):
    rng = np.random.default_rng(61)
    db = random_dbmart(rng, n_patients=8, max_events=12)
    ids = _feature_ids_for(db)
    ref, port = stream_pair(screen=screen)
    srv, jsrv = port.serve(feature_ids=ids), ref.serve(feature_ids=ids)
    assert_features_identical(srv, ids, jsrv)
    for p in range(db.n_patients):
        submit_all((port, ref), db, [p])
        port.service.tick()
        ref.service.tick()
        assert_features_identical(srv, ids, jsrv)
    port.run()
    ref.run()
    assert_features_identical(srv, ids, jsrv)


def test_feature_store_bootstrap_midstream():
    rng = np.random.default_rng(67)
    db = random_dbmart(rng, n_patients=8, max_events=12)
    ids = _feature_ids_for(db)
    ref, port = stream_pair()
    half = db.n_patients // 2
    submit_all((port, ref), db, range(half))
    port.service.run()
    ref.service.run()
    srv, jsrv = port.serve(feature_ids=ids), ref.serve(feature_ids=ids)
    assert_features_identical(srv, ids, jsrv)
    for p in range(half, db.n_patients):
        submit_all((port, ref), db, [p])
        port.service.tick()
        ref.service.tick()
        assert_features_identical(srv, ids, jsrv)


@pytest.mark.parametrize("engine", ["stream", "sharded"])
def test_feature_store_covers_migration_admitted_patients(engine):
    rng = np.random.default_rng(79)
    db = random_dbmart(rng, n_patients=8, max_events=12)
    donors = [p for p in range(db.n_patients) if db.nevents[p] > 1][-2:]
    djs, dport = stream_pair()
    submit_all((djs, dport), db, donors)
    states = {}
    for name, d in (("ref", djs), ("port", dport)):
        d.service.run()
        states[name] = [d.service.extract_patient(p) for p in donors
                        if p in d.service.store.pids]
    assert states["port"], "no donor patient survived to extraction"
    ids = np.unique(np.concatenate(
        [_feature_ids_for(db)]
        + [np.asarray(s.corpus_seq, np.int64)[:3] for s in states["port"]]))
    kw = dict(engine=engine)
    if engine == "sharded":
        kw["n_shards"] = 2
    ref, port = stream_pair(**kw)
    srv, jsrv = port.serve(feature_ids=ids), ref.serve(feature_ids=ids)
    submit_all((port, ref), db, [p for p in range(db.n_patients) if p not in donors])
    port.service.run()
    ref.service.run()
    assert_features_identical(srv, ids, jsrv)
    for s, js in zip(states["port"], states["ref"]):
        port.service.admit_patient(s)
        ref.service.admit_patient(js)
    srv.publish()
    jsrv.publish()
    assert_features_identical(srv, ids, jsrv)
    x = srv.features().x.numpy()
    assert all(x[int(s.key)].any() for s in states["port"]
               if len(s.corpus_seq) and int(s.key) < len(x))
    p = donors[0]
    for s in (port, ref):
        s.submit(p, db.date[p, :1], db.phenx[p, :1])
        s.service.run()
    assert_features_identical(srv, ids, jsrv)


def test_feature_store_batch_session():
    rng = np.random.default_rng(71)
    db = random_dbmart(rng, n_patients=8, max_events=12)
    ids = _feature_ids_for(db)
    ref, port = fitted_pair("batch", db, screen="hash", threshold=2)
    assert_features_identical(port.serve(feature_ids=ids), ids,
                              ref.serve(feature_ids=ids))


def test_feature_store_validation():
    with pytest.raises(ValueError):
        FeatureStore([3, 1, 2])
    with pytest.raises(ValueError):
        FeatureStore([1, 1])
    s = FeatureStore([])
    s.stage_rows(np.asarray([0]), np.asarray([5]))
    with pytest.raises(TypeError):
        FeatureStore([1, 2]).stage_rows(np.asarray(["a"]), np.asarray([1]))


def test_feature_store_rejects_keyed_cohorts():
    session = MiningSession(MiningConfig(threshold=2, tick_patients=2, n_buckets_log2=H),
                            device="cpu")
    session.submit("patient-a", [1, 2], [5, 6])
    session.service.run()
    with pytest.raises(TypeError):
        session.serve(feature_ids=np.asarray([5, 6], np.int64))
    srv = session.serve()
    assert srv.query(plan().screen(1)).n_kept >= 0


def test_feature_matrices_are_point_in_time():
    rng = np.random.default_rng(73)
    db = random_dbmart(rng, n_patients=8, max_events=12)
    ids = _feature_ids_for(db)
    ref, port = stream_pair()
    srv, jsrv = port.serve(feature_ids=ids), ref.serve(feature_ids=ids)
    half = db.n_patients // 2
    submit_all((port, ref), db, range(half))
    port.service.run()
    ref.service.run()
    early = srv.view()
    frozen = None if early.feature_x is None else early.feature_x.copy()
    assert_same(early.feature_x, jsrv.view().feature_x)
    submit_all((port, ref), db, range(half, db.n_patients))
    port.service.run()
    ref.service.run()
    if frozen is None:
        assert early.feature_x is None
    else:
        assert early.feature_x.tobytes() == frozen.tobytes()
    assert_features_identical(srv, ids, jsrv)


def test_uncompacted_rows_batch_and_stream_agree():
    rng = np.random.default_rng(79)
    db = random_dbmart(rng, n_patients=6, max_events=10)
    rows = {}
    for engine in ("batch", "stream"):
        ref, port = fitted_pair(engine, db, threshold=2, screen="hash")
        rows[engine] = uncompacted_rows(port)
        for a, b in zip(rows[engine], j_uncompacted_rows(ref)):
            assert_same(a, np.asarray(b), engine)
    (bs, bp), (ss, sp) = rows["batch"], rows["stream"]
    assert sorted(zip(bp.tolist(), bs.tolist())) == sorted(zip(sp.tolist(), ss.tolist()))


# --- beyond the reference's tests -------------------------------------------
@pytest.mark.parametrize("screen,fuse", [("sorted", False), ("hash", False),
                                         ("fused", False), ("hash", True)])
def test_eval_columns_equal_reference(screen, fuse):
    """The padded columns (start, end, dur, screen statistic, valid) equal
    the reference's, padding included; they lie on the session's device."""
    rng = np.random.default_rng(500 + len(screen) + fuse)
    db = random_dbmart(rng, n_patients=12, max_events=20)
    ref, port = fitted_pair("batch", db, screen=screen, threshold=2, fuse_duration=fuse)
    cols, jcols = port.serve().view().columns(), ref.serve().view().columns()
    assert cols.n_rows == jcols.n_rows == len(port.last_frame)
    for name in ("start", "end", "dur", "screen", "valid"):
        got = getattr(cols, name)
        assert got.device.type == "cpu" and got.shape[0] >= 1024
        assert_same(got, np.asarray(getattr(jcols, name)), name)


def test_predicate_op_equals_reference(monkeypatch):
    """The predicate op against the reference's ``_pred_kernel`` on random
    columns and descriptors, NOOP padding rows included, untiled and over
    several tiles of the columns."""
    rng = np.random.default_rng(8)
    n = 3_000
    cols = [rng.integers(0, 12, n).astype(np.int32) for _ in range(4)]
    codes = rng.integers(0, 5, 16).astype(np.int32)
    codes[-3:] = 0
    args = rng.integers(0, 12, 16).astype(np.int32)
    want = np.asarray(j_server._pred_kernel(*cols, codes, args))
    assert want[-3:].all()
    for tile in (server.PRED_TILE, 1_000, 7):
        monkeypatch.setattr(server, "PRED_TILE", tile)
        got = server._pred_kernel(*(torch.from_numpy(c) for c in cols),
                                  torch.from_numpy(codes), torch.from_numpy(args))
        assert_same(got, want, f"tile {tile}")


def test_one_schedule_masks_and_features_equal_reference():
    """One streaming schedule through both packages' servers: at every tick
    every plan's keep mask and ``features()`` equal the reference's, and
    the waves and cache counters agree."""
    rng = np.random.default_rng(90)
    db = random_dbmart(rng, n_patients=10, max_events=14)
    ids = _feature_ids_for(db)
    plans = random_plans(rng, codes_of(db), n=20)
    ref, port = stream_pair(screen="hash", tick_patients=3)
    srv = port.serve(batch_size=8, feature_ids=ids)
    jsrv = ref.serve(batch_size=8, feature_ids=ids)
    submit_all((port, ref), db, range(db.n_patients))
    while port.service.queue:
        port.service.tick()
        ref.service.tick()
        assert srv.view().tick == jsrv.view().tick
        got = srv.query_batch([to_port(p) for p in plans])
        want = jsrv.query_batch(plans)
        for p, g, w in zip(plans, got, want):
            assert_same(g.keep, w.keep, str(p))
        assert_features_identical(srv, ids, jsrv)
    assert srv.stats() == jsrv.stats()
