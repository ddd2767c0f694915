"""The port's tick journal against the reference's, on the CPU.

Twin of tests/test_journal.py, one test for one: journaling a chaos
schedule is invisible to the run and replays byte-identically (1 and 2
shards, telemetry on and off), the stream engine replays, ``upto_tick``
stops at its tick, a checkpoint-restored session keeps journaling into
the same log, every single-byte flip and a torn segment give typed proofs,
re-chained forgeries are caught by replay, and the typed event API the
journal rides on holds.  Each is held against the reference on the same
schedule: the reference journals the same ops and verifies the same
forgeries, and the two must agree.

Beyond those: the framing primitives (``uvarint``, entries, the chain
hash, merkle roots with and without a leaf cache, state and wave digests)
equal the reference's on random arrays; for one schedule with evictions,
migrations, a rebalance, an external admit and a checkpoint, stream and
sharded, the port's journal equals the reference's entry for entry, byte
for byte (both written at the same path, one after the other, so the open
entry's ``journal_dir`` agrees too); and a journal of either package
verifies and replays in the other to the writer's state.
"""
import shutil

import numpy as np
import pytest

from repro import obs as j_obs
from repro.api import MiningConfig as JConfig
from repro.api import MiningSession as JSession
from repro.journal import entries as j_entries
from repro.journal import merkle as j_merkle
from repro.journal import read_journal as j_read_journal
from repro.journal import verify as j_verify
from repro.stream.events import TickCompleted as JTick
from repro.stream.service import StreamService as JService
from repro_torch import obs as obs_lib
from repro_torch.api import MiningConfig, MiningSession
from repro_torch.journal import (ChainBreak, CommitmentMismatch, Divergence,
                                 FraudProof, TornSegment, Truncated, entries,
                                 merkle, read_journal, verify, write_journal)
from repro_torch.journal.entries import decode_entry, encode_entry, entry_kind
from repro_torch.journal.journal import build_segment
from repro_torch.storage.blockstore import CompressedBlockStore
from repro_torch.stream.events import DeltaSubmitted, Migrated, TickCompleted
from repro_torch.stream.service import StreamService
from tests.conftest import random_dbmart
from tests.test_torch_checkpoint import apply_session_ops, assert_sessions_identical
from tests.test_torch_shard import assert_matches_batch, make_ops
from tests.test_torch_stream import H
from tests.torch_parity import assert_same


def chaos_ops(db, rng, n_shards):
    """The reference's ``_checkpoint_ops`` schedule: ticks and runs, and on
    more than one shard migrations and rebalances, interleaved."""
    multi = n_shards > 1
    ops = make_ops(db, rng, n_shards, p_tick=0.2, p_run=0.15,
                   p_migrate=0.2 * multi, p_rebalance=0.1 * multi)
    return ops


def _config(jdir, n_shards=2, telemetry=False, commit_every=3, **kw):
    """One config for both packages (the port's backend 'torch' is the
    reference's 'jnp', so the two open entries agree)."""
    cfg = dict(engine="sharded", n_shards=n_shards, tick_patients=2,
               n_buckets_log2=H, screen="hash", budget_bytes=20_000,
               disk_bytes=5_000, telemetry=telemetry,
               journal_dir=None if jdir is None else str(jdir),
               journal_commit_every=commit_every)
    cfg.update(kw)
    return cfg


def port_session(cfg):
    return MiningSession(MiningConfig(**cfg, backend="torch"), device="cpu")


def run_both(cfg, db, ops):
    """The reference, then the port, journal the same ops at the same path;
    returns (reference session, its entries, port session, its entries)."""
    jdir = cfg["journal_dir"]
    ref = JSession(JConfig(**cfg))
    apply_session_ops(ref, db, ops)
    ref.journal().flush()
    ref_entries = j_read_journal(jdir)
    ref.journal().close()
    shutil.rmtree(jdir)
    port = port_session(cfg)
    apply_session_ops(port, db, ops)
    port.journal().flush()
    return ref, ref_entries, port, read_journal(jdir)


def assert_same_entries(got, want):
    assert len(got) == len(want)
    for i, ((e, h), (we, wh)) in enumerate(zip(got, want)):
        assert e == we, f"entry {i} ({entry_kind(e)}) differs"
        assert h == wh, f"chain hash {i} differs"


def proof_of(res):
    p = res.proof
    return None if p is None else (type(p).__name__, p.tick, p.index)


def _chaos_session(tmp_path, rng, n_shards=2, telemetry=False):
    db = random_dbmart(rng, n_patients=9, max_events=16)
    cfg = _config(tmp_path / "journal", n_shards=n_shards, telemetry=telemetry)
    ops = chaos_ops(db, rng, n_shards)
    session = port_session(cfg)
    apply_session_ops(session, db, ops)
    return session, db, ops, cfg


# --- completeness: chaos replay is byte-identical ---------------------------
@pytest.mark.parametrize("n_shards,telemetry", [(1, False), (2, False), (2, True)])
def test_journal_chaos_replay_byte_identical(n_shards, telemetry, tmp_path):
    """Journaling a chaos schedule is invisible (the journaled run equals
    an unjournaled one), verifies, replays to the live state and to the
    batch oracle, and equals the reference's journal of the same ops."""
    rng = np.random.default_rng(8_800 + 10 * n_shards + telemetry)
    db = random_dbmart(rng, n_patients=9, max_events=16)
    cfg = _config(tmp_path / "journal", n_shards=n_shards, telemetry=telemetry)
    ops = chaos_ops(db, rng, n_shards)
    ref, ref_entries, session, got = run_both(cfg, db, ops)
    assert_same_entries(got, ref_entries)
    assert_sessions_identical(session, ref)

    bare = port_session({**cfg, "journal_dir": None, "telemetry": False})
    apply_session_ops(bare, db, ops)
    assert_sessions_identical(session, bare)

    res = session.verify()
    assert res.ok and res.proof is None and bool(res)
    assert res.n_ticks == session.service.n_ticks
    assert res.n_commits >= 1
    jres, _ = j_verify.verify_replay(cfg["journal_dir"])
    assert (res.n_entries, res.n_ticks, res.n_commits) == \
        (jres.n_entries, jres.n_ticks, jres.n_commits) and jres.ok
    if telemetry:
        m, jm = session.metrics(), ref.metrics()
        for name in ("journal.entries", "journal.commits", "journal.bytes"):
            assert m[name] == jm[name], name

    replayed = MiningSession.replay(cfg["journal_dir"], device="cpu")
    assert replayed.device.type == "cpu"
    assert_sessions_identical(replayed, session)
    assert_matches_batch(replayed.service, db)


def test_journal_stream_engine_replay(tmp_path):
    """The single-shard stream engine journals and replays exactly too,
    and its journal is the reference's."""
    rng = np.random.default_rng(97)
    db = random_dbmart(rng, n_patients=8, max_events=14)
    cfg = _config(tmp_path / "j", engine=None, n_shards=1, commit_every=2)
    ops = chaos_ops(db, rng, 1)
    ref, ref_entries, session, got = run_both(cfg, db, ops)
    assert isinstance(session.service, StreamService)
    assert_same_entries(got, ref_entries)
    assert session.verify().ok

    replayed = MiningSession.replay(cfg["journal_dir"], device="cpu")
    assert_sessions_identical(replayed, session)
    assert_sessions_identical(replayed, JSession.replay(cfg["journal_dir"]))


def test_replay_upto_tick_stops_at_the_named_tick(tmp_path):
    """``replay(upto_tick=k)`` stops the tick clock at k, the corpus grows
    with k, and each partial replay equals the reference's."""
    rng = np.random.default_rng(5)
    db = random_dbmart(rng, n_patients=6, max_events=10)
    cfg = _config(tmp_path / "j", engine=None, n_shards=1, budget_bytes=None,
                  disk_bytes=None, commit_every=2)
    session = port_session(cfg)
    for p in range(db.n_patients):       # one productive tick per patient
        n = int(db.nevents[p])
        if n:
            session.submit(p, db.date[p, :n], db.phenx[p, :n])
            session.service.tick()
    total = session.service.n_ticks
    assert total >= 3
    session.journal().flush()

    prev_rows = -1
    for k in (1, total // 2, total):
        part = MiningSession.replay(cfg["journal_dir"], upto_tick=k, device="cpu")
        assert part.service.n_ticks == k
        rows = len(part.service.snapshot().seq)
        assert rows >= prev_rows
        prev_rows = rows
        assert_sessions_identical(part, JSession.replay(cfg["journal_dir"], upto_tick=k))
    full = MiningSession.replay(cfg["journal_dir"], device="cpu")
    assert_same(full.service.snapshot().seq, session.service.snapshot().seq)


def test_journal_survives_checkpoint_restore(tmp_path):
    """A checkpoint-restored session keeps journaling into the same
    genesis-rooted log: the combined journal verifies, replays to the
    resumed state, and equals the reference's interrupted journal."""
    rng = np.random.default_rng(41)
    db = random_dbmart(rng, n_patients=8, max_events=12)
    cfg = _config(tmp_path / "j", budget_bytes=None, disk_bytes=None,
                  commit_every=2)
    ops = chaos_ops(db, rng, 2)
    cut = int(rng.integers(1, len(ops)))
    logs = {}
    for name, cls, kw in (("ref", JSession, {}), ("port", MiningSession,
                                                  {"device": "cpu"})):
        shutil.rmtree(cfg["journal_dir"], ignore_errors=True)
        config = JConfig(**cfg) if name == "ref" else MiningConfig(**cfg, backend="torch")
        interrupted = cls(config, **kw)
        apply_session_ops(interrupted, db, ops[:cut])
        path = interrupted.checkpoint(str(tmp_path / f"ckpt_{name}"))
        interrupted.journal().close()
        resumed = cls.restore(path, **kw)
        apply_session_ops(resumed, db, ops[cut:])
        res = resumed.verify()
        assert res.ok, str(res)
        logs[name] = (read_journal(cfg["journal_dir"]), resumed)
    got, session = logs["port"]
    assert_same_entries(got, logs["ref"][0])
    kinds = [entry_kind(e) for e, _ in got]
    assert kinds.count("open") == 1 and "checkpoint" in kinds
    replayed = MiningSession.replay(cfg["journal_dir"], device="cpu")
    assert_sessions_identical(replayed, session)
    assert_sessions_identical(replayed, logs["ref"][1])


# --- soundness: the tamper matrix -------------------------------------------
def _rewrite(root, pairs):
    """Replace a journal's segments with exactly ``pairs`` — *preserving*
    the stored hashes (unlike write_journal, which re-chains)."""
    store = CompressedBlockStore(root)
    try:
        for key in list(store.keys()):
            if isinstance(key, str) and key.startswith("jseg"):
                store.discard(key)
        store.put_bytes("jseg00000000", build_segment(pairs))
    finally:
        store.close()


def test_every_single_byte_flip_names_the_divergent_tick(tmp_path):
    """One flipped byte in each entry (stored hash untouched): each copy
    fails with a ChainBreak at exactly that entry and tick, as in the
    reference, and the untouched journal still verifies."""
    session, *_ = _chaos_session(tmp_path, np.random.default_rng(63))
    jdir = session.config.journal_dir
    session.journal().flush()
    clean = read_journal(jdir)
    kinds = [entry_kind(e) for e, _ in clean]
    assert len(clean) > 10 and kinds[0] == "open"

    for i, (e, h) in enumerate(clean):
        flipped = bytearray(e)
        flipped[len(e) // 2] ^= 0x01
        t = str(tmp_path / f"flip{i}")
        shutil.copytree(jdir, t)
        _rewrite(t, clean[:i] + [(bytes(flipped), h)] + clean[i + 1:])
        res = session.verify(t)
        assert not res.ok and isinstance(res.proof, ChainBreak), str(res)
        assert res.proof.index == i
        assert res.proof.tick == kinds[:i].count("tick") + 1
        assert proof_of(res) == proof_of(j_verify.verify_journal(t))

    assert session.verify().ok        # no false positive on the original


def test_torn_segment_is_a_fraud_proof(tmp_path):
    """A segment that fails framing gives a typed proof, the reference's."""
    session, *_ = _chaos_session(tmp_path, np.random.default_rng(29), n_shards=1)
    jdir = session.config.journal_dir
    session.journal().flush()
    t = str(tmp_path / "torn")
    shutil.copytree(jdir, t)
    store = CompressedBlockStore(t)
    key = sorted(k for k in store.keys()
                 if isinstance(k, str) and k.startswith("jseg"))[-1]
    store.put_bytes(key, b"\xff\xfe\xfd not a segment")
    store.close()
    res = session.verify(t)
    assert not res.ok and isinstance(res.proof, TornSegment), str(res)
    assert res.proof.tick >= 1 and key in res.proof.reason
    assert proof_of(res) == proof_of(j_verify.verify_journal(t))


def test_rechained_forgeries_are_caught_by_replay(tmp_path):
    """Re-chained (internally consistent) forgeries pass layer 1; replay
    and the against-live fork check catch each, and the replay's proof on
    each forgery is the reference's."""
    session, *_ = _chaos_session(tmp_path, np.random.default_rng(77))
    jdir = session.config.journal_dir
    session.journal().flush()
    raw = [e for e, _ in read_journal(jdir)]
    kinds = [entry_kind(e) for e in raw]
    n_case = 0

    def forge(forged):
        nonlocal n_case
        t = str(tmp_path / f"forge{n_case}")
        n_case += 1
        shutil.copytree(jdir, t)
        write_journal(t, forged)       # the adversary re-chains
        got, _ = verify.verify_replay(t, device="cpu")
        want, _ = j_verify.verify_replay(t)
        assert proof_of(got) == proof_of(want)
        return session.verify(t)

    res = forge(raw[:-3])                                   # (a) rollback
    assert not res.ok and isinstance(res.proof, (Truncated, Divergence)), str(res)

    deltas = [i for i, k in enumerate(kinds) if k == "delta"]
    i, j = next((i, j) for i in deltas for j in deltas if j > i
                and decode_entry(raw[i])[1]["key"] != decode_entry(raw[j])[1]["key"])
    reordered = list(raw)                                   # (b) reorder
    reordered[i], reordered[j] = reordered[j], reordered[i]
    res = forge(reordered)
    assert not res.ok and isinstance(res.proof, FraudProof), str(res)
    assert res.proof.tick <= kinds[:j].count("tick") + 1

    ci = kinds.index("commit")                              # (c) forged commit
    kind, fields, arrays, blobs = decode_entry(raw[ci])
    forged_commit = list(raw)
    forged_commit[ci] = encode_entry(kind, dict(fields, pids="00" * 32), arrays, blobs)
    res = forge(forged_commit)
    assert not res.ok and isinstance(res.proof, CommitmentMismatch), str(res)
    assert res.proof.tick == kinds[:ci].count("tick") + 1

    target = next(i for i in deltas                         # (d) edited delta
                  if len(decode_entry(raw[i])[2]["phenx"]) >= 2)
    kind, fields, arrays, blobs = decode_entry(raw[target])
    edited = list(raw)
    edited[target] = encode_entry(kind, fields, dict(arrays, phenx=arrays["phenx"] + 1000),
                                  blobs)
    res = forge(edited)
    assert not res.ok and isinstance(res.proof, FraudProof), str(res)

    assert session.verify().ok


def test_verify_requires_a_journal():
    for session in (MiningSession(MiningConfig(tick_patients=2, n_buckets_log2=H),
                                  device="cpu"),
                    JSession(JConfig(tick_patients=2, n_buckets_log2=H))):
        session.submit(0, [1, 2], [3, 4])
        session.run()
        assert session.journal() is None
        with pytest.raises(RuntimeError, match="nothing to verify"):
            session.verify()


# --- the typed session-event API --------------------------------------------
def test_typed_subscription_and_legacy_shims_agree():
    """Typed subscribers, the subscribe_tick/subscribe_delta shims and the
    pull-side tap observe the same tick, with the reference's payload."""
    session = MiningSession(MiningConfig(tick_patients=4, n_buckets_log2=H),
                            device="cpu")
    svc = session._ensure_service()
    tap = session.events(kinds=(DeltaSubmitted, TickCompleted))
    typed, shim_delta, shim_tick = [], [], []
    svc.subscribe(typed.append, kinds=TickCompleted)
    svc.subscribe_delta(lambda keys, slot, seq, dur: shim_delta.append(np.asarray(seq)))
    svc.subscribe_tick(shim_tick.append)
    session.submit(0, [1, 5, 9], [3, 4, 7])
    session.run()
    ref = JService(tick_patients=4, n_buckets_log2=H)
    ref_typed = []
    ref.subscribe(ref_typed.append, kinds=JTick)
    ref.submit(0, [1, 5, 9], [3, 4, 7])
    ref.run()

    assert len(typed) == 1 and typed[0].tick == 1
    assert shim_tick == [svc]
    assert np.array_equal(shim_delta[0], typed[0].seq)
    assert typed[0].keys == ref_typed[0].keys
    for name in ("slot_idx", "seq", "dur"):
        assert_same(getattr(typed[0], name), getattr(ref_typed[0], name), name)
    drained = list(tap)
    assert [type(ev) for ev in drained] == [DeltaSubmitted, TickCompleted]
    assert len(tap) == 0
    with pytest.raises(TypeError):
        svc.subscribe(lambda ev: None, kinds=(int,))


def test_subscriber_errors_are_isolated_and_counted():
    """A raising subscriber does not corrupt the tick (counted on
    events.subscriber_errors, as in the reference); isolate=False, the
    journal's mode, propagates."""
    def bad(ev):
        raise RuntimeError("subscriber boom")

    counts = []
    for svc_cls, tick, tel, kw in (
            (StreamService, TickCompleted, obs_lib.Telemetry(), {"device": "cpu"}),
            (JService, JTick, j_obs.Telemetry(), {})):
        svc = svc_cls(tick_patients=2, n_buckets_log2=H, telemetry=tel, **kw)
        seen = []
        svc.subscribe(bad, kinds=tick)                   # isolate=True
        svc.subscribe(seen.append, kinds=tick)
        svc.submit(0, [1, 2], [3, 4])
        svc.tick()                                       # must not raise
        assert len(seen) == 1 and len(svc.snapshot().seq) > 0
        counts.append(tel.metrics.value("events.subscriber_errors"))
    assert counts[0] == counts[1] == 1
    svc2 = StreamService(tick_patients=2, n_buckets_log2=H, device="cpu")
    svc2.subscribe(bad, kinds=TickCompleted, isolate=False)
    svc2.submit(0, [1, 2], [3, 4])
    with pytest.raises(RuntimeError, match="subscriber boom"):
        svc2.tick()


def test_external_admit_emits_migrated_with_state(tmp_path):
    """A cross-service handoff surfaces as Migrated(src=None) with the
    admitted state, and its journal entry (the full state) is the
    reference's."""
    states = []
    for svc_cls, kw in ((StreamService, {"device": "cpu"}), (JService, {})):
        donor = svc_cls(tick_patients=2, n_buckets_log2=H, **kw)
        donor.submit(7, [1, 2, 9], [3, 4, 6])
        donor.run()
        states.append(donor.extract_patient(7))
    svc = StreamService(tick_patients=2, n_buckets_log2=H, device="cpu")
    got = []
    svc.subscribe(got.append, kinds=Migrated)
    svc.admit_patient(states[0])
    assert len(got) == 1
    ev = got[0]
    assert ev.key == 7 and ev.src is None and ev.state is states[0]
    packed = [entries.pack_state(states[0]), j_entries.pack_state(states[1])]
    assert packed[0][0] == packed[1][0]
    for name in packed[1][1]:
        assert_same(packed[0][1][name], packed[1][1][name], name)
    assert entries.state_digest(states[0]) == j_entries.state_digest(states[1])
    back = entries.unpack_state(*packed[1])
    assert type(back).__module__ == "repro_torch.stream.service"
    assert entries.state_digest(back) == entries.state_digest(states[0])


# --- beyond the reference's tests -------------------------------------------
def test_framing_primitives_equal_reference():
    rng = np.random.default_rng(3)
    for n in [0, 1, 127, 128, 255, 16_383, 16_384, 2**31, 2**63 + 5]:
        assert entries.uvarint(n) == j_entries.uvarint(n)
        assert entries.Reader(entries.uvarint(n)).uvarint() == n
    with pytest.raises(ValueError):
        entries.uvarint(-1)
    for trial in range(6):
        arrays = {f"a{i}": rng.integers(-2**40, 2**40, int(rng.integers(0, 300)))
                  .astype([np.int64, np.int32, np.uint8][i % 3]) for i in range(3)}
        fields = {"k": ["i", int(rng.integers(100))], "n": trial, "s": None}
        blobs = {"z": rng.bytes(int(rng.integers(0, 50)))}
        e = encode_entry("delta", fields, arrays, blobs)
        assert e == j_entries.encode_entry("delta", fields, arrays, blobs)
        kind, f, a, b = decode_entry(e)
        assert (kind, f, b) == ("delta", fields, blobs)
        for name in arrays:
            assert_same(a[name], arrays[name], name)
        assert entries.chain_hash(entries.GENESIS, e) == \
            j_entries.chain_hash(j_entries.GENESIS, e)
        seq = rng.integers(0, 2**62, int(rng.integers(0, 40_000)))
        dur = rng.integers(0, 500, len(seq)).astype(np.int32)
        slot = rng.integers(0, 8, len(seq))
        keys = [int(k) for k in rng.integers(0, 50, 8)]
        assert entries.wave_digest(keys, slot, seq, dur) == \
            j_entries.wave_digest(keys, slot, seq, dur)
        assert entries._fold64(seq) == j_entries._fold64(seq)
        data = rng.bytes(int(rng.integers(0, 5 * merkle.CHUNK_BYTES)))
        assert merkle.merkle_root(data) == j_merkle.merkle_root(data)
        cache, j_cache = [], []
        for cut in sorted(rng.integers(0, len(data) + 1, 3)):
            assert merkle.merkle_root(data[:cut], cache) == \
                j_merkle.merkle_root(data[:cut], j_cache) == \
                merkle.merkle_root(data[:cut])
        assert cache == j_cache
    with pytest.raises(ValueError, match="unknown entry kind"):
        encode_entry("nope")
    with pytest.raises(ValueError, match="trailing bytes"):
        decode_entry(encode_entry("tick") + b"\x00")


@pytest.mark.parametrize("engine", ["stream", "sharded"])
def test_journal_entries_equal_reference(tmp_path, engine):
    """One schedule with evictions through the host and disk tiers,
    migrations, a rebalance, an external admit and a checkpoint: the
    port's journal is the reference's, byte for byte, and each verifies
    and replays the other's to the writer's state."""
    rng = np.random.default_rng(2_024 + len(engine))
    db = random_dbmart(rng, n_patients=10, max_events=18)
    n_shards = 3 if engine == "sharded" else 1
    cfg = _config(tmp_path / "j", n_shards=n_shards, commit_every=2,
                  engine=engine)
    ops = chaos_ops(db, rng, n_shards)
    if engine == "sharded":
        ops.append(("rebalance", 1.0))
    donors = []
    for cls, kw in ((JService, {}), (StreamService, {"device": "cpu"})):
        donor = cls(tick_patients=2, n_buckets_log2=H, **kw)
        donor.submit(99, [1, 2, 9], [3, 4, 6])
        donor.run()
        donors.append(donor.extract_patient(99))
    sessions = {}
    for name, state in (("ref", donors[0]), ("port", donors[1])):
        shutil.rmtree(cfg["journal_dir"], ignore_errors=True)
        s = JSession(JConfig(**cfg)) if name == "ref" else port_session(cfg)
        apply_session_ops(s, db, ops)
        if engine == "sharded":
            s.service.admit_patient(state, dst=1)
        else:
            s.service.admit_patient(state)
        s.submit(99, [12], [5])
        s.service.run()
        s.checkpoint(str(tmp_path / f"ckpt_{name}"))
        s.journal().close()
        sessions[name] = (s, read_journal(cfg["journal_dir"]))
    got, want = sessions["port"][1], sessions["ref"][1]
    assert_same_entries(got, want)
    kinds = {entry_kind(e) for e, _ in got}
    assert {"open", "delta", "tick", "evict", "migrate", "commit",
            "checkpoint"} <= kinds
    if engine == "sharded":
        assert "rebalance" in kinds
    assert_sessions_identical(sessions["port"][0], sessions["ref"][0])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journals_cross_packages(tmp_path, writer):
    """A journal written by either package verifies and replays in the
    other, to the writer's snapshot, pids and pins."""
    rng = np.random.default_rng(4_100 + len(writer))
    db = random_dbmart(rng, n_patients=8, max_events=14)
    cfg = _config(tmp_path / "j", n_shards=2)
    ops = chaos_ops(db, rng, 2)
    src = JSession(JConfig(**cfg)) if writer == "reference" else port_session(cfg)
    apply_session_ops(src, db, ops)
    src.journal().close()
    res, in_port = verify.verify_replay(cfg["journal_dir"], device="cpu")
    jres, in_ref = j_verify.verify_replay(cfg["journal_dir"])
    assert res.ok and jres.ok, (str(res), str(jres))
    for replayed in (in_port, in_ref):
        assert_sessions_identical(replayed, src)
    assert verify.state_divergence(in_port.service, in_ref.service,
                                   n_ticks=res.n_ticks) is None
    assert verify.compare_journals(read_journal(cfg["journal_dir"]),
                                   j_read_journal(cfg["journal_dir"])) is None


def test_journaled_sessions_are_freed_without_the_collector(tmp_path):
    """A sharded session with a subscriber (its journal) and the session a
    verify replays are freed by reference counting alone: no reference
    cycle keeps their tensors alive after ``del``."""
    import gc
    import weakref

    rng = np.random.default_rng(13)
    db = random_dbmart(rng, n_patients=6, max_events=10)
    cfg = _config(tmp_path / "j", n_shards=2, placement="devices", telemetry=True)
    gc.disable()
    try:
        session = port_session(cfg)
        apply_session_ops(session, db, chaos_ops(db, rng, 2))
        replayed = []
        real_build = verify._build_session

        def spy(*a, **kw):
            s = real_build(*a, **kw)
            replayed.append(weakref.ref(s.service))
            return s
        verify._build_session = spy
        try:
            assert session.verify().ok
        finally:
            verify._build_session = real_build
        live = weakref.ref(session.service)
        session.journal().close()
        del session
        assert live() is None and replayed and replayed[0]() is None
    finally:
        gc.enable()
