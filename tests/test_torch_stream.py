"""The port's streaming engine against the reference service, on the CPU.

Twin of tests/test_stream.py.  The same deltas (random chronological
chunks, patients interleaved, ticks at random points) go through the
reference ``repro.stream.service.StreamService`` and the port's; the
snapshot (corpus rows in log order and the sketch table), the query masks
and the store's tier placement must be byte-identical, in both codecs,
with and without ``fuse_duration``, and under eviction through the host
and disk tiers.  A reference ``state_dict()`` loaded into a port service
continues exactly as the reference does.
"""
import numpy as np
import pytest
import torch

from repro.core import mining as j_mining
from repro.core import sparsity as j_sparsity
from repro.stream.service import StreamService as JService
from repro_torch.stream.events import Evicted, TickCompleted
from repro_torch.stream.service import StreamService
from repro_torch.stream.store import PatientStore
from tests.conftest import random_dbmart
from tests.torch_parity import assert_same

H = 10


def replay(db, services, rng):
    """Submit each patient's history as random chronological chunks to
    every service, patients interleaved, draining the queues together."""
    cursors = np.zeros(db.n_patients, np.int64)
    alive = [p for p in range(db.n_patients) if db.nevents[p] > 0]
    while alive:
        p = alive[int(rng.integers(len(alive)))]
        lo = int(cursors[p])
        hi = min(lo + int(rng.integers(1, 4)), int(db.nevents[p]))
        for svc in services:
            svc.submit(p, db.date[p, lo:hi], db.phenx[p, lo:hi])
        cursors[p] = hi
        if hi == int(db.nevents[p]):
            alive.remove(p)
        if rng.random() < 0.3:
            for svc in services:
                svc.run()
    for svc in services:
        svc.run()


def _pair(**kw):
    """A reference service and the port's on the CPU, same settings."""
    return JService(**kw), StreamService(device="cpu", **kw)


def assert_same_state(port, ref):
    a, b = port.snapshot(), ref.snapshot()
    for name in ("seq", "dur", "patient", "counts"):
        assert_same(getattr(a, name), getattr(b, name), name)
    assert port.store.pids == ref.store.pids
    assert {k: port.store.tier_of(k) for k in ref.store.pids} == \
        {k: ref.store.tier_of(k) for k in ref.store.pids}
    assert [s.n_pairs for s in port.stats] == [s.n_pairs for s in ref.stats]


def batch_reference(db, codec="bit", fuse=False):
    mined = j_mining.mine_triangular(db.phenx, db.date, db.nevents, codec=codec,
                                     fuse_duration=fuse)
    seq, dur, pat, msk = (np.asarray(x) for x in j_mining.flatten(mined))
    cnt = np.asarray(j_sparsity.local_bucket_counts(
        np.asarray(mined.seq), np.asarray(mined.mask), H))
    return seq, dur, pat, msk, cnt


@pytest.mark.parametrize("case", range(6))
def test_streaming_equals_reference(case):
    rng = np.random.default_rng(1000 + case)
    db = random_dbmart(rng)
    codec, fuse = ("bit", "paper")[case % 2], case % 3 == 0
    ref, port = _pair(tick_patients=int(rng.integers(1, 5)), n_buckets_log2=H,
                      codec=codec, fuse_duration=fuse)
    replay(db, [ref, port], rng)
    assert_same_state(port, ref)
    # and the corpus is the batch corpus, the table the batch table
    seq, dur, pat, msk, cnt = batch_reference(db, codec, fuse)
    snap = port.snapshot()
    p2k = {pid: k for k, pid in port.store.pids.items()}
    keys = [p2k[int(p)] for p in snap.patient]
    assert sorted(zip(keys, snap.seq, snap.dur)) == \
        sorted(zip(pat[msk], seq[msk], dur[msk]))
    assert_same(snap.counts, cnt, "table")
    thr = int(rng.integers(1, 4))
    x = int(rng.integers(0, 30))
    for name, args in (("query_starts_with", (x,)),
                       ("query_ends_with", (x, thr)),
                       ("query_min_duration", (30,)),
                       ("screened_keep", (thr,))):
        assert_same(getattr(port, name)(*args), getattr(ref, name)(*args), name)


@pytest.mark.parametrize("disk", [False, True])
def test_streaming_under_eviction_with_tiers(tmp_path, disk):
    """A tiny byte budget forces spill/restore churn through the host tier
    and, with ``disk_bytes``, the compressed disk tier: the results, the
    tier placement and the tier contents equal the reference's."""
    rng = np.random.default_rng(42)
    db = random_dbmart(rng, n_patients=10, max_events=16)
    kw = dict(tick_patients=3, n_buckets_log2=H, budget_bytes=40_000)
    if disk:
        kw.update(disk_bytes=2_000)
    ref = JService(**kw, disk_dir=str(tmp_path / "ref") if disk else None)
    port = StreamService(device="cpu", **kw,
                         disk_dir=str(tmp_path / "port") if disk else None)
    replay(db, [ref, port], rng)
    assert port.store.spilled_count == ref.store.spilled_count > 0
    if disk:
        assert "disk" in {port.store.tier_of(k) for k in port.store.pids}
    assert_same_state(port, ref)
    for k in port.store.pids:
        a, b = port.store.history(k), ref.store.history(k)
        assert_same(a[0], b[0], "phenx")
        assert_same(a[1], b[1], "date")


def test_streaming_kernel_backend_on_cpu_equals_reference():
    """backend='kernel' on CPU tensors is the wrapper's plain version."""
    rng = np.random.default_rng(7)
    db = random_dbmart(rng, n_patients=6, max_events=12)
    ref = JService(tick_patients=2, n_buckets_log2=H, fuse_duration=True)
    port = StreamService(tick_patients=2, n_buckets_log2=H, fuse_duration=True,
                         backend="kernel", device="cpu")
    replay(db, [ref, port], rng)
    assert_same_state(port, ref)


def test_sketch_merges_with_batch_screen_counts():
    rng = np.random.default_rng(3)
    db = random_dbmart(rng, n_patients=8, max_events=14)
    half = db.n_patients // 2
    cold = db.slice_patients(0, half)
    mined = j_mining.mine_triangular(cold.phenx, cold.date, cold.nevents)
    cold_cnt = np.asarray(j_sparsity.local_bucket_counts(
        np.asarray(mined.seq), np.asarray(mined.mask), H))
    ref, port = _pair(tick_patients=2, n_buckets_log2=H)
    replay(db.slice_patients(half, db.n_patients), [ref, port], rng)
    merged = port.merged_counts(cold_cnt)
    assert_same(merged, ref.merged_counts(cold_cnt), "merged")
    assert_same(merged, batch_reference(db)[4], "all-batch table")


def test_sketch_error_is_one_sided():
    rng = np.random.default_rng(5)
    db = random_dbmart(rng, n_patients=12, max_events=10, n_codes=4)
    port = StreamService(tick_patients=4, n_buckets_log2=4, device="cpu")
    replay(db, [port], rng)
    snap = port.snapshot()
    keep = port.screened_keep(3)
    support = {}
    for k, s in set(zip(snap.patient, snap.seq)):
        support[s] = support.get(s, 0) + 1
    for i, s in enumerate(snap.seq):
        if support[s] >= 3:
            assert keep[i]


def test_service_coalesces_second_delta_into_patient_slot():
    svc = StreamService(tick_patients=4, device="cpu")
    svc.submit(0, [1, 2], [3, 4])
    svc.submit(0, [5], [6])
    svc.submit(1, [1], [2])
    st = svc.tick()
    assert st.n_patients == 2 and len(svc.queue) == 0
    ph, dt = svc.store.history(0)
    assert ph.tolist() == [3, 4, 6] and dt.tolist() == [1, 2, 5]


def test_flooding_patient_drains_in_one_tick_and_stays_exact():
    rng = np.random.default_rng(21)
    db = random_dbmart(rng, n_patients=3, max_events=24)
    ref, port = _pair(tick_patients=2, n_buckets_log2=H)
    for svc in (ref, port):
        for i in range(int(db.nevents[0])):
            svc.submit(0, db.date[0, i: i + 1], db.phenx[0, i: i + 1])
        for p in (1, 2):
            n = int(db.nevents[p])
            svc.submit(p, db.date[p, :n], db.phenx[p, :n])
    st = port.tick()
    ref.tick()
    assert st.n_patients == 2
    assert st.n_events == int(db.nevents[0]) + int(db.nevents[1])
    assert len(port.queue) == 1
    for svc in (ref, port):
        svc.run()
    assert_same_state(port, ref)


def test_slot_coalescing_caps_wave_width():
    rng = np.random.default_rng(6)
    db = random_dbmart(rng, n_patients=2, max_events=24)
    n0 = int(db.nevents[0])
    assert n0 > 8
    ref, port = _pair(tick_patients=4, n_buckets_log2=H, max_slot_events=8)
    for svc in (ref, port):
        for i in range(n0):
            svc.submit(0, db.date[0, i: i + 1], db.phenx[0, i: i + 1])
    st = port.tick()
    ref.tick()
    assert st.n_events == 8 and len(port.queue) == n0 - 8
    for svc in (ref, port):
        svc.run()
    assert_same_state(port, ref)


def test_store_regrowth_keeps_history():
    st = PatientStore(init_patients=2, init_events=8, device="cpu")
    rng = np.random.default_rng(0)
    want = {k: ([], []) for k in range(7)}
    for step in range(30):
        k = int(rng.integers(7))
        d = int(rng.integers(1, 6))
        ph = rng.integers(0, 50, d).astype(np.int32)
        dt = np.full(d, step, np.int32)
        rows, _ = st.admit([k])
        st.append(rows, ph[None], dt[None], np.asarray([d], np.int32))
        want[k][0].extend(ph.tolist())
        want[k][1].extend(dt.tolist())
    for k, (ph, dt) in want.items():
        if ph:
            gp, gd = st.history(k)
            assert gp.tolist() == ph and gd.tolist() == dt
    assert st.phenx.shape[1] >= max(len(v[0]) for v in want.values())


def _to_numpy(tree):
    """The reference's state tree with every array turned to numpy."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree) if hasattr(tree, "shape") else tree


@pytest.mark.parametrize("budget", [None, 40_000])
def test_reference_state_continues_in_the_port(tmp_path, budget):
    """reference state_dict() -> port load_state_dict -> continue equals
    the reference continuing, queued deltas and tiers included."""
    rng = np.random.default_rng(77)
    db = random_dbmart(rng, n_patients=10, max_events=16)
    kw = dict(tick_patients=3, n_buckets_log2=H, budget_bytes=budget,
              fuse_duration=budget is None)
    if budget:
        kw.update(disk_bytes=6_000)
    ref = JService(**kw, disk_dir=str(tmp_path / "ref") if budget else None)
    half = {p: int(db.nevents[p]) // 2 for p in range(db.n_patients)}
    for p, h in half.items():
        if h:
            ref.submit(p, db.date[p, :h], db.phenx[p, :h])
    ref.tick()
    ref.tick()                     # some queued deltas stay behind
    port = StreamService(device="cpu", **kw,
                         disk_dir=str(tmp_path / "port") if budget else None)
    port.load_state_dict(_to_numpy(ref.state_dict()))
    assert len(port.queue) == len(ref.queue) > 0
    for p, h in half.items():
        n = int(db.nevents[p])
        if n > h:
            for svc in (ref, port):
                svc.submit(p, db.date[p, h:n], db.phenx[p, h:n])
    ref.run()
    port.run()
    a, b = port.snapshot(), ref.snapshot()
    for name in ("seq", "dur", "patient", "counts"):
        assert_same(getattr(a, name), getattr(b, name), name)
    assert {k: port.store.tier_of(k) for k in ref.store.pids} == \
        {k: ref.store.tier_of(k) for k in ref.store.pids}
    assert port.n_ticks == ref.n_ticks
    for part in ("sketch", "store"):
        got, want = port.state_dict()[part], _to_numpy(ref.state_dict()[part])
        for k in ("counts", "seqset", "n_distinct", "phenx", "date", "nevents"):
            if k in want:
                assert_same(got[k], want[k], f"{part}.{k}")


def test_events_and_handoff_match_reference():
    """TickCompleted payloads and Evicted events equal the reference's, and
    an extract/admit handoff between two services keeps the union exact."""
    rng = np.random.default_rng(12)
    db = random_dbmart(rng, n_patients=8, max_events=12)
    ref, port = _pair(tick_patients=3, n_buckets_log2=H, budget_bytes=20_000)
    seen = {"ref": [], "port": []}
    ref.subscribe(seen["ref"].append)
    port.subscribe(seen["port"].append)
    replay(db, [ref, port], rng)
    assert [type(e).__name__ for e in seen["port"]] == \
        [type(e).__name__ for e in seen["ref"]]
    for a, b in zip(seen["port"], seen["ref"]):
        if isinstance(a, TickCompleted):
            assert a.tick == b.tick and a.keys == b.keys
            for name in ("slot_idx", "seq", "dur"):
                assert_same(getattr(a, name), getattr(b, name), name)
        elif isinstance(a, Evicted):
            assert (a.keys, a.demoted) == (b.keys, b.demoted)
    key = next(iter(port.store.pids))
    other_ref, other_port = _pair(tick_patients=3, n_buckets_log2=H)
    for src, dst in ((ref, other_ref), (port, other_port)):
        dst.admit_patient(src.extract_patient(key))
    assert_same_state(port, ref)
    assert_same_state(other_port, other_ref)
    assert_same(port.sketch.counts + other_port.sketch.counts,
                batch_reference(db)[4], "split tables")


def test_count_table_is_device_side_histogram():
    """The fold's novel-id counts go through kernels/seq_hist (its plain
    version on the CPU): the table is int32 on the service's device."""
    svc = StreamService(tick_patients=2, n_buckets_log2=H, device="cpu")
    svc.submit(0, [1, 2, 3], [4, 5, 4])
    svc.run()
    assert svc.sketch.counts.dtype == torch.int32
    assert svc.sketch.counts.device.type == "cpu"
    assert int(svc.sketch.counts.sum()) == 3     # ids (4,5), (4,4), (5,4)
