"""The port's sharded streaming engine against the reference, on the CPU.

Twin of tests/test_stream_sharded.py, tests/test_stream_migration.py and
tests/test_stream_placement.py.  One op schedule (submits of random
chronological chunks, ticks, runs, migrations, rebalances) is generated
from a seed and replayed through the reference's ``ShardedStreamService``
and the port's; the snapshot (``seq``, ``dur``, ``patient``, ``counts``),
``pids``, ``router.pinned``, ``migrations``, ``shard_loads()``, the store
tiers and the sequence of ``Migrated``, ``Rebalanced``, ``Evicted`` and
``TickCompleted`` events must be identical, for 1, 2 and 4 shards, both
routers, with and without a mesh, under eviction through the host and
disk tiers, and under ``'devices'`` placement.  The handoff mechanisms are
then held one at a time, as the reference's tests hold them.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.launch.mesh import make_data_mesh as j_make_data_mesh
from repro.stream.shard import ShardedStreamService as JSharded
from repro.stream.shard import ShardRouter as JRouter
from repro.stream.shard import stable_shard_hash as j_stable_shard_hash
from repro_torch.core import chunking
from repro_torch.data import pipeline
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.stream.counts import OnlineSupportSketch
from repro_torch.stream.shard import ShardedStreamService, ShardRouter, \
    stable_shard_hash
from repro_torch.stream.store import PatientStore
from tests.conftest import random_dbmart
from tests.test_torch_stream import H, batch_reference, replay
from tests.torch_parity import assert_same


# --- one schedule, two packages ---------------------------------------------
def make_ops(db, rng, n_shards, p_tick=0.15, p_run=0.15, p_migrate=0.0,
             p_rebalance=0.0):
    """A deterministic schedule: submits that drain the cohort, with ticks,
    runs, migrations (also of patients with queued deltas) and rebalances
    interleaved; ends fully drained, then migrates ingested patients."""
    ops = []
    cursors = np.zeros(db.n_patients, np.int64)
    alive = [p for p in range(db.n_patients) if db.nevents[p] > 0]
    submitted: list = []
    while alive:
        p = alive[int(rng.integers(len(alive)))]
        lo = int(cursors[p])
        hi = min(lo + int(rng.integers(1, 4)), int(db.nevents[p]))
        ops.append(("submit", p, lo, hi))
        if p not in submitted:
            submitted.append(p)
        cursors[p] = hi
        if hi == int(db.nevents[p]):
            alive.remove(p)
        r = rng.random()
        if r < p_tick:
            ops.append(("tick",))
        elif r < p_tick + p_run:
            ops.append(("run",))
        if rng.random() < p_migrate:
            key = submitted[int(rng.integers(len(submitted)))]
            ops.append(("migrate", key, int(rng.integers(n_shards))))
        if rng.random() < p_rebalance:
            ops.append(("rebalance", 1.0 + float(rng.random())))
    ops.append(("run",))
    for key in submitted:           # post-drain churn
        if rng.random() < p_migrate:
            ops.append(("migrate", key, int(rng.integers(n_shards))))
    return ops


def apply_ops(svc, db, ops):
    for op in ops:
        if op[0] == "submit":
            _, p, lo, hi = op
            svc.submit(p, db.date[p, lo:hi], db.phenx[p, lo:hi])
        elif op[0] == "tick":
            svc.tick()
        elif op[0] == "run":
            svc.run()
        elif op[0] == "migrate":
            svc.migrate(op[1], op[2])
        elif op[0] == "rebalance":
            svc.rebalance(imbalance_threshold=op[1])


def event_log(svc) -> list:
    """Every event the service emits, as comparable plain values."""
    log = []

    def on(ev):
        kind = type(ev).__name__
        if kind == "TickCompleted":
            log.append((kind, ev.tick, ev.shard, tuple(ev.keys),
                        np.asarray(ev.slot_idx).tobytes(),
                        np.asarray(ev.seq).tobytes(),
                        np.asarray(ev.dur).tobytes()))
        elif kind == "Migrated":
            log.append((kind, ev.key, ev.src, ev.dst))
        elif kind == "Rebalanced":
            log.append((kind, tuple(ev.moves)))
        elif kind == "Evicted":
            log.append((kind, ev.keys, ev.demoted, ev.shard))
        else:
            log.append((kind, ev.shard))

    svc.subscribe(on, isolate=False)
    return log


def routers(kind, db, n_shards):
    if kind == "hash":
        return None, None
    keys, nev = list(range(db.n_patients)), np.asarray(db.nevents)
    return (JRouter.balanced(keys, nev, n_shards),
            ShardRouter.balanced(keys, nev, n_shards))


def pair(n_shards, router="hash", db=None, with_mesh=False, **kw):
    """A reference sharded service and the port's on the CPU."""
    jr, tr = routers(router, db, n_shards)
    ref = JSharded(n_shards=n_shards, router=jr,
                   mesh=j_make_data_mesh() if with_mesh else None, **kw)
    port = ShardedStreamService(
        n_shards=n_shards, router=tr, device="cpu",
        mesh=make_data_mesh(device="cpu") if with_mesh else None, **kw)
    return ref, port


def assert_same_sharded(port, ref, stats: bool = True):
    """Every observable of two sharded services; ``stats`` (per-tick
    TickStats) only where both ran every tick in this process."""
    a, b = port.snapshot(), ref.snapshot()
    for name in ("seq", "dur", "patient", "counts"):
        assert_same(getattr(a, name), getattr(b, name), name)
    assert port.pids == ref.pids
    assert port.router.pinned == ref.router.pinned
    assert port.migrations == ref.migrations
    assert port.shard_loads() == ref.shard_loads()
    assert port.n_ticks == ref.n_ticks
    if stats:
        assert [s.n_pairs for s in port.stats] == [s.n_pairs for s in ref.stats]
    for ps, rs in zip(port.shards, ref.shards):
        assert ps.store.pids == rs.store.pids
        assert {k: ps.store.tier_of(k) for k in rs.store.pids} == \
            {k: rs.store.tier_of(k) for k in rs.store.pids}


def sharded_triples(svc):
    snap = svc.snapshot()
    p2k = svc.pid_to_key()
    keys = np.asarray([p2k[int(p)] for p in snap.patient], np.int64)
    return snap, keys


def assert_matches_batch(svc, db):
    seq, dur, pat, msk, cnt = batch_reference(db)
    snap, keys = sharded_triples(svc)
    assert sorted(zip(keys, snap.seq, snap.dur)) == \
        sorted(zip(pat[msk], seq[msk], dur[msk]))
    assert (snap.counts == cnt).all()


def run_both(db, ref, port, ops):
    logs = event_log(ref), event_log(port)
    apply_ops(ref, db, ops)
    apply_ops(port, db, ops)
    assert_same_sharded(port, ref)
    assert logs[1] == logs[0]
    return logs[1]


# --- whole replays ----------------------------------------------------------
@pytest.mark.parametrize("n_shards,router,with_mesh", [
    (n, r, False) for n in (1, 2, 4) for r in ("hash", "balance")] + [
    (2, "hash", True), (4, "balance", True)])
def test_sharded_equals_reference(n_shards, router, with_mesh):
    rng = np.random.default_rng(300 + 10 * n_shards + (router == "hash")
                                + 2 * with_mesh)
    db = random_dbmart(rng, n_patients=int(rng.integers(4, 12)))
    ref, port = pair(n_shards, router, db, with_mesh,
                     tick_patients=int(rng.integers(1, 5)), n_buckets_log2=H)
    run_both(db, ref, port, make_ops(db, rng, n_shards))
    assert_matches_batch(port, db)
    thr = int(rng.integers(1, 4))
    x = int(rng.integers(0, 30))
    for name, args in (("query_starts_with", (x,)),
                       ("query_ends_with", (x, thr)),
                       ("query_min_duration", (30,)),
                       ("screened_keep", (thr,))):
        assert_same(getattr(port, name)(*args), getattr(ref, name)(*args), name)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("budget", [None, 40_000])
def test_chaos_migration_equals_reference(n_shards, budget):
    rng = np.random.default_rng(7_000 + 10 * n_shards + (budget or 0))
    db = random_dbmart(rng, n_patients=int(rng.integers(5, 11)))
    ref, port = pair(n_shards, tick_patients=int(rng.integers(1, 4)),
                     n_buckets_log2=H, budget_bytes=budget)
    ops = make_ops(db, rng, n_shards, p_migrate=0.2 * (n_shards > 1),
                   p_rebalance=0.1 * (n_shards > 1))
    log = run_both(db, ref, port, ops)
    if n_shards > 1:
        assert port.migrations and any(e[0] == "Migrated" for e in log)
    assert_matches_batch(port, db)


@pytest.mark.parametrize("disk", [False, True])
def test_sharded_tiers_equal_reference(tmp_path, disk):
    """Per-shard budgets evict through the host tier and, with
    ``disk_bytes``, the disk tier (a blockstore a shard, ``disk_dir/shard{s}``);
    migrations move resident and spilled patients."""
    rng = np.random.default_rng(43)
    db = random_dbmart(rng, n_patients=12, max_events=16)
    kw = dict(tick_patients=3, n_buckets_log2=H, budget_bytes=20_000)
    if disk:
        kw["disk_bytes"] = 2_000
    ref = JSharded(n_shards=3, **kw,
                   disk_dir=str(tmp_path / "ref") if disk else None)
    port = ShardedStreamService(n_shards=3, device="cpu", **kw,
                                disk_dir=str(tmp_path / "port") if disk else None)
    ops = make_ops(db, rng, 3, p_migrate=0.15, p_rebalance=0.05)
    run_both(db, ref, port, ops)
    tiers = {port.shards[s].store.tier_of(k)
             for s in range(3) for k in port.shards[s].store.pids}
    assert "host" in tiers or "disk" in tiers
    if disk:
        assert "disk" in tiers
        assert (tmp_path / "port" / "shard0").is_dir()
    assert_matches_batch(port, db)


def test_auto_rebalance_equals_reference():
    """``rebalance_every`` migrates from inside ``tick`` on a skewed
    pinned placement, identically in both packages."""
    rng = np.random.default_rng(31)
    db = random_dbmart(rng, n_patients=10, max_events=20)
    pins = {p: 0 for p in range(db.n_patients)}
    kw = dict(n_shards=3, tick_patients=2, n_buckets_log2=H,
              rebalance_every=2, imbalance_threshold=1.1)
    ref = JSharded(router=JRouter(3, pinned=dict(pins)), **kw)
    port = ShardedStreamService(router=ShardRouter(3, pinned=dict(pins)),
                                device="cpu", **kw)
    log = run_both(db, ref, port, make_ops(db, rng, 3))
    assert port.migrations, "skewed placement never rebalanced"
    assert any(e[0] == "Rebalanced" for e in log)
    assert_matches_batch(port, db)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_devices_placement_equals_host_and_reference(n_shards):
    """'devices' (every shard on the CPU here, two-pass ticks, async
    admits) equals 'host' in both packages, byte for byte."""
    rng = np.random.default_rng(500 + n_shards)
    db = random_dbmart(rng, n_patients=10, max_events=14)
    ops = make_ops(db, rng, n_shards, p_migrate=0.2, p_rebalance=0.1)
    kw = dict(tick_patients=3, n_buckets_log2=H, budget_bytes=40_000)
    ref = JSharded(n_shards=n_shards, **kw)
    host = ShardedStreamService(n_shards=n_shards, device="cpu", **kw)
    dev = ShardedStreamService(n_shards=n_shards, device="cpu",
                               placement="devices", **kw)
    assert dev.async_migration and not host.async_migration
    for svc in (ref, host, dev):
        apply_ops(svc, db, ops)
    assert_same_sharded(host, ref)
    assert_same_sharded(dev, ref)


@pytest.mark.parametrize("placement", ["host", "devices"])
def test_async_migration_midstream(placement):
    """Migrations between ticks, admitted at tick boundaries (or on any
    whole-cohort read): equal to the reference under the same schedule."""
    rng = np.random.default_rng(81)
    db = random_dbmart(rng, n_patients=10, max_events=14)
    kw = dict(n_shards=4, placement=placement, async_migration=True,
              tick_patients=3, n_buckets_log2=H)
    ref, port = JSharded(**kw), ShardedStreamService(device="cpu", **kw)
    cursors = np.zeros(db.n_patients, np.int64)
    for step in range(60):
        p = int(rng.integers(db.n_patients))
        lo = int(cursors[p])
        hi = min(lo + int(rng.integers(1, 3)), int(db.nevents[p]))
        tick, mig = rng.random() < 0.3, rng.random() < 0.25
        dst = int(rng.integers(4))
        for svc in (ref, port):
            if hi > lo:
                svc.submit(p, db.date[p, lo:hi], db.phenx[p, lo:hi])
            if tick:
                svc.tick()
            if mig and p in svc.pids:
                svc.migrate(p, dst)
        cursors[p] = max(hi, lo)
    for svc in (ref, port):
        for p in range(db.n_patients):
            lo, hi = int(cursors[p]), int(db.nevents[p])
            if hi > lo:
                svc.submit(p, db.date[p, lo:hi], db.phenx[p, lo:hi])
        svc.run()
    assert not port._pending_keys
    assert_same_sharded(port, ref)
    assert_matches_batch(port, db)


def test_pending_admit_visible_to_reads():
    """A snapshot between migrate() and the next tick already sees the
    patient on its new home; re-migrating a parked patient lands it first;
    run() with empty queues still lands parked admits."""
    svc = ShardedStreamService(n_shards=3, async_migration=True, device="cpu",
                               tick_patients=4, n_buckets_log2=H)
    svc.submit(0, np.arange(6, dtype=np.int32), np.zeros(6, np.int32))
    svc.submit(1, np.arange(4, dtype=np.int32), np.ones(4, np.int32))
    svc.run()
    before = svc.snapshot()
    src = svc.router.route(0)
    dst = (src + 1) % 3
    svc.migrate(0, dst)
    assert 0 in svc._pending_keys
    after = svc.snapshot()                          # flushes
    assert 0 not in svc._pending_keys and 0 in svc.shards[dst].store.pids
    assert sorted(zip(after.seq, after.dur)) == sorted(zip(before.seq, before.dur))
    assert_same(after.counts, before.counts, "counts")
    svc.migrate(0, src)
    svc.migrate(0, dst)                             # flush-then-move
    assert svc.router.route(0) == dst
    svc.migrate(0, src)
    svc.submit(0, np.arange(6, 9, dtype=np.int32), np.zeros(3, np.int32))
    svc.run()
    assert not svc._pending_keys
    assert len(svc.shards[src].store.history(0)[0]) == 9
    svc.migrate(0, dst)
    assert svc.run() == [] and not svc._pending_keys
    assert 0 in svc.shards[dst].store.pids


@pytest.mark.parametrize("async_migration", [False, True])
def test_reference_state_continues_in_the_port(async_migration):
    """A reference ``state_dict()`` (arrays turned to numpy, in-flight
    admits included) loads into the port, which then continues exactly as
    the reference does."""
    rng = np.random.default_rng(19 + async_migration)
    db = random_dbmart(rng, n_patients=9, max_events=14)
    ops = make_ops(db, rng, 3, p_migrate=0.25, p_rebalance=0.1)
    cut = len(ops) // 2
    kw = dict(n_shards=3, tick_patients=2, n_buckets_log2=H,
              budget_bytes=20_000, async_migration=async_migration)
    ref = JSharded(**kw)
    apply_ops(ref, db, ops[:cut])
    key = next(iter(ref.pids))
    ref.migrate(key, (ref.router.route(key) + 1) % 3)
    if async_migration:
        assert ref._pending_keys            # a payload is in flight
    state = _to_numpy(ref.state_dict())
    port = ShardedStreamService(device="cpu", **kw)
    port.load_state_dict(state)
    assert port._pending_keys == ref._pending_keys
    apply_ops(ref, db, ops[cut:])
    apply_ops(port, db, ops[cut:])
    assert_same_sharded(port, ref, stats=False)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    if hasattr(tree, "__array__") and not isinstance(tree, np.ndarray):
        return np.asarray(tree)
    return tree


def test_sharded_merges_with_batch_screen_counts():
    """Half the cohort batch-counted, half stream-sharded: the merged table
    equals the all-batch table and the reference's merge."""
    rng = np.random.default_rng(9)
    db = random_dbmart(rng, n_patients=8, max_events=14)
    half = db.n_patients // 2
    cold_cnt = batch_reference(db.slice_patients(0, half))[4]
    ref, port = pair(2, tick_patients=2, n_buckets_log2=H)
    hot = db.slice_patients(half, db.n_patients)
    replay(hot, [ref, port], rng)
    got = port.merged_counts(cold_cnt)
    assert_same(got, ref.merged_counts(cold_cnt), "merged")
    assert (got == batch_reference(db)[4]).all()


# --- routers -----------------------------------------------------------------
def test_balanced_router_pins_by_lpt_buckets():
    nevents = np.asarray([2, 30, 4, 30, 6, 8], np.int64)
    keys = list("abcdef")
    router = ShardRouter.balanced(keys, nevents, 2)
    assert router.pinned == JRouter.balanced(keys, nevents, 2).pinned
    for s, b in enumerate(pipeline.balance_buckets(nevents, 2)):
        for p in b:
            assert router.route(keys[p]) == s
    assert 0 <= router.route("zz") < 2


def test_hash_router_is_stable_and_equals_reference():
    keys = [0, 1, 17, 2**40, -3, np.int64(9), np.int32(5), "patient-3",
            ("site", 9), b"k"] + list(range(64))
    for key in keys:
        assert stable_shard_hash(key) == j_stable_shard_hash(key), key
    r, jr = ShardRouter(4), JRouter(4)
    assert [r.route(k) for k in keys] == [jr.route(k) for k in keys]
    assert len({r.route(i) for i in range(64)}) == 4
    with pytest.raises(ValueError):
        r.assign(0, 4)


# --- handoff mechanisms, one at a time --------------------------------------
def test_migrate_moves_queued_deltas_in_order():
    svc = ShardedStreamService(n_shards=2, tick_patients=4, n_buckets_log2=H,
                               device="cpu")
    src = svc.router.route(0)
    svc.submit(0, [1, 2], [5, 6])
    svc.submit(0, [3], [7])
    svc.migrate(0, 1 - src)
    assert not svc.shards[src].queue
    assert [d.phenx.tolist() for d in svc.shards[1 - src].queue] == [[5, 6], [7]]
    assert svc.router.route(0) == 1 - src
    svc.run()
    ph, dt = svc.shards[1 - src].store.history(0)
    assert ph.tolist() == [5, 6, 7] and dt.tolist() == [1, 2, 3]


def test_migrate_unknown_key_raises_and_same_shard_is_noop():
    svc = ShardedStreamService(n_shards=2, n_buckets_log2=H, device="cpu")
    with pytest.raises(KeyError):
        svc.migrate("ghost", 1)
    svc.submit(3, [1], [2])
    svc.run()
    home = svc.router.route(3)
    svc.migrate(3, home)
    assert svc.migrations == [] and 3 in svc.shards[home].store.pids


def test_migrate_out_of_range_dst_rejected_before_mutation():
    svc = ShardedStreamService(n_shards=3, n_buckets_log2=H, device="cpu")
    svc.submit(0, [1], [2])
    svc.run()
    svc.submit(0, [3], [4])
    home = svc.router.route(0)
    for bad in (-1, 3, 17):
        with pytest.raises(ValueError):
            svc.migrate(0, bad)
    assert svc.router.route(0) == home and 0 in svc.shards[home].store.pids
    assert len(svc.shards[home].queue) == 1 and svc.migrations == []
    svc.run()
    ph, dt = svc.shards[home].store.history(0)
    assert ph.tolist() == [2, 4] and dt.tolist() == [1, 3]


def test_migrate_spilled_patient_moves_host_copy():
    rng = np.random.default_rng(13)
    db = random_dbmart(rng, n_patients=12, max_events=20)
    svc = ShardedStreamService(n_shards=2, tick_patients=3, n_buckets_log2=H,
                               budget_bytes=20_000, device="cpu")
    replay(db, [svc], rng)
    spilled = [(s, k) for s, sv in enumerate(svc.shards)
               for k in sv.store.held_keys()]
    assert spilled, "budget never spilled anyone"
    s, key = spilled[0]
    svc.migrate(key, 1 - s)
    assert svc.shards[1 - s].store.tier_of(key) in ("host", "disk")
    assert key not in svc.shards[s].store.pids
    assert_matches_batch(svc, db)


def test_sketch_row_handoff_is_subtract_add_exact():
    rng = np.random.default_rng(3)
    src = OnlineSupportSketch(H, device="cpu")
    dst = OnlineSupportSketch(H, device="cpu")
    seq = rng.integers(0, 1 << 40, (2, 9)).astype(np.int64)
    src.update([0, 1], seq, np.ones((2, 9), bool))
    before = src.counts.clone()
    ids = src.extract_row(0)
    assert sorted(ids) == sorted(set(seq[0].tolist()))
    dst.admit_row(5, ids)
    assert (src.counts + dst.counts == before).all()
    assert src.n_distinct[0] == 0
    assert dst.update([5], seq[0][None, :3], np.ones((1, 3), bool)) == 0


def test_store_extract_shrinks_high_water_planes():
    st_ = PatientStore(init_patients=2, init_events=8, device="cpu")
    ph = np.arange(100, dtype=np.int32)
    rows, _ = st_.admit(["big"])
    st_.append(rows, ph[None], ph[None], np.asarray([100], np.int32))
    for k in range(5):
        r, _ = st_.admit([f"s{k}"])
        st_.append(r, ph[None, :3], ph[None, :3], np.asarray([3], np.int32))
    cap_before = st_.max_events
    assert cap_before >= 100
    _, hph, hdt = st_.extract("big")
    assert hph.tolist() == ph.tolist() and hdt.tolist() == ph.tolist()
    assert st_.max_events < cap_before
    for _ in range(6):
        st_.shrink_to_fit()
    assert st_.max_events <= 16
    for k in range(5):
        assert st_.history(f"s{k}")[0].tolist() == ph[:3].tolist()


def test_store_pids_never_reused_after_extract():
    st_ = PatientStore(device="cpu")
    st_.admit(["a", "b"])
    pid_a, *_ = st_.extract("a")
    st_.admit(["c"])
    assert st_.pids["c"] != pid_a
    assert st_.pid_capacity == 3 and st_.n_patients == 2
    pid_b, ph, dt = st_.extract("b")
    assert st_.admit_state("b", ph, dt) not in (pid_a, pid_b)


def test_rebalance_moves_load_off_hot_shard():
    rng = np.random.default_rng(8)
    db = random_dbmart(rng, n_patients=12, max_events=20)
    pins = {p: 0 for p in range(db.n_patients)}
    ref = JSharded(n_shards=4, router=JRouter(4, pinned=dict(pins)),
                   tick_patients=4, n_buckets_log2=H)
    svc = ShardedStreamService(n_shards=4, router=ShardRouter(4, pinned=dict(pins)),
                               tick_patients=4, n_buckets_log2=H, device="cpu")
    replay(db, [ref, svc], rng)
    before = svc.shard_loads()
    assert max(before) == sum(before)
    moves = svc.rebalance(imbalance_threshold=1.1)
    assert moves == ref.rebalance(imbalance_threshold=1.1)
    after = svc.shard_loads()
    assert moves and max(after) < max(before) and sum(after) == sum(before)
    assert_same_sharded(svc, ref)
    assert_matches_batch(svc, db)


def _submit_patient(svc, key, n_events):
    svc.submit(key, np.arange(n_events, dtype=np.int32),
               np.zeros(n_events, np.int32))


def test_rebalance_min_gain_hysteresis():
    """A borderline move (gain under ``min_gain`` x the mean) stays put; with
    the guard off it runs; a balanced cohort never migrates."""
    def build(pins, sizes):
        svc = ShardedStreamService(n_shards=2, router=ShardRouter(2, pinned=pins),
                                   tick_patients=4, n_buckets_log2=H, device="cpu")
        for key, n in sizes:
            _submit_patient(svc, key, n)
        svc.run()
        return svc

    skew = ({0: 0, 1: 0, 2: 1}, ((0, 4), (1, 20), (2, 19)))
    svc = build(*skew)
    loads = svc.shard_loads()
    mean = sum(loads) / 2
    move = 4 * 4 * chunking.BYTES_PER_PAIR
    gain = loads[0] - max(loads[0] - move, loads[1] + move)
    assert 0 < gain < 0.05 * mean
    assert svc.rebalance(imbalance_threshold=1.0) == [] and svc.migrations == []
    assert build(*skew).rebalance(imbalance_threshold=1.0, min_gain=0.0) == [(0, 0, 1)]
    even = build({0: 0, 1: 1}, ((0, 12), (1, 12)))
    assert even.rebalance(imbalance_threshold=1.0, min_gain=0.0) == []


def test_busy_weighted_rebalance_stays_exact():
    """Busy weights skew the LPT toward idle shards without changing what is
    mined; mismatched weights raise, all-zero weights fall back."""
    rng = np.random.default_rng(6)
    db = random_dbmart(rng, n_patients=12, max_events=12)
    svc = ShardedStreamService(
        n_shards=3, tick_patients=3, n_buckets_log2=H, device="cpu",
        router=ShardRouter(3, pinned={p: 0 for p in range(db.n_patients)}))
    replay(db, [svc], rng)
    assert svc.rebalance(imbalance_threshold=1.1, busy_weights=[0.9, 0.1, 0.1])
    with pytest.raises(ValueError):
        svc.rebalance(busy_weights=[1.0, 1.0])
    svc.rebalance(imbalance_threshold=1.1, busy_weights=[0.0, 0.0, 0.0])
    assert_matches_batch(svc, db)


def test_single_shard_services_take_the_shard_labels(tmp_path):
    """A shard's service carries its tag: track, metric labels, events and
    its own disk directory."""
    from repro_torch.obs import Telemetry

    tel = Telemetry()
    svc = ShardedStreamService(n_shards=2, tick_patients=2, n_buckets_log2=H,
                               device="cpu", telemetry=tel, budget_bytes=1,
                               disk_bytes=1, disk_dir=str(tmp_path))
    assert [s.track for s in svc.shards] == ["shard0", "shard1"]
    assert svc.shards[0]._retrace is svc.shards[1]._retrace is not None
    for k in range(6):
        _submit_patient(svc, k, 5)
    svc.run()
    snap = tel.metrics.snapshot()
    assert "stream.ticks{shard=0}" in snap and "stream.ticks{shard=1}" in snap
    assert {p.name for p in tmp_path.iterdir()} <= {"shard0", "shard1"}


@settings(max_examples=15)
@given(data=st.data())
def test_chaos_migration_hypothesis(data):
    """Hypothesis drives the schedule (dbmart shape, chunk sizes, the
    tick/migrate/rebalance interleaving, shards, budget); both packages
    replay it and must agree."""
    n_shards = data.draw(st.sampled_from([1, 2, 4]), label="n_shards")
    db = random_dbmart(np.random.default_rng(
        data.draw(st.integers(0, 2**16), label="db_seed")),
        n_patients=data.draw(st.integers(2, 8), label="n_patients"),
        max_events=10)
    ref, port = pair(n_shards, n_buckets_log2=H,
                     budget_bytes=data.draw(st.sampled_from([None, 40_000])),
                     tick_patients=data.draw(st.integers(1, 4)))
    seed = data.draw(st.integers(0, 2**16), label="ops_seed")
    ops = make_ops(db, np.random.default_rng(seed), n_shards,
                   p_migrate=0.3, p_rebalance=0.1)
    run_both(db, ref, port, ops)
    assert_matches_batch(port, db)
