"""The port's checkpoints against the reference's, on the CPU.

Twin of tests/test_training.py's checkpoint tests, tests/test_storage.py's
checkpoint layer and tests/test_stream_migration.py's session
checkpoint/restore: the training checkpoint round-trips, is atomic, saves
asynchronously, finds the latest step and loads without a tree, in the
reference's layout (either package reads the other's); a live session
checkpointed at a random point of a chaos schedule and restored continues
byte-identically to an uninterrupted run, for the stream and sharded
engines, with telemetry on and off; and a session checkpoint written by
either package restores in the other and continues as the writer's own
restore does.
"""
import collections
import dataclasses
import os
import threading

import jax
import numpy as np
import pytest
import torch

from repro.api import MiningConfig as JConfig
from repro.api import MiningSession as JSession
from repro.training import checkpoint as j_ckpt
from repro_torch.api import MiningConfig, MiningSession
from repro_torch.stream.events import CheckpointTaken
from repro_torch.stream.service import StreamService
from repro_torch.stream.shard import ShardedStreamService
from repro_torch.training import checkpoint as ckpt
from tests.conftest import random_dbmart
from tests.test_torch_shard import assert_matches_batch, assert_same_sharded, \
    make_ops
from tests.test_torch_stream import H
from tests.torch_parity import assert_same

Pair = collections.namedtuple("Pair", "first second")


def _tree(rng):
    return {"w": torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)),
            "b": [np.arange(5, dtype=np.int64), (torch.tensor(7), None)],
            "state": Pair(np.ones(2, np.int32), {"z": np.float64(2.5), "a": []})}


def _leaves_equal(a, b):
    la, _ = ckpt._flatten(a)
    lb, _ = ckpt._flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert_same(x if torch.is_tensor(x) else np.asarray(x),
                    y if torch.is_tensor(y) else np.asarray(y))


def _to_jax_leaves(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if not torch.is_tensor(x) else x.numpy(), tree)


# --- the training checkpoint ------------------------------------------------
def test_flatten_order_and_treedef_match_jax():
    tree = _tree(np.random.default_rng(0))
    leaves, treedef = ckpt._flatten(tree)
    jtree = _to_jax_leaves(tree)
    jleaves, jdef = jax.tree_util.tree_flatten(jtree)
    assert treedef == str(jdef)
    for a, b in zip(leaves, jleaves):
        assert_same(a if torch.is_tensor(a) else np.asarray(a), np.asarray(b))


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = _tree(np.random.default_rng(1))
    path = ckpt.save(str(tmp_path), 3, tree, {"note": "t"})
    assert ckpt.latest(str(tmp_path)) == path
    restored, manifest = ckpt.restore(path, tree)
    assert manifest["step"] == 3 and manifest["extra"] == {"note": "t"}
    assert isinstance(restored["state"], Pair) and restored["b"][1][1] is None
    assert torch.is_tensor(restored["w"]) and restored["w"].dtype == torch.float32
    _leaves_equal(restored, tree)
    os.makedirs(str(tmp_path / "step_00000099.tmp"))   # a crash mid-write
    assert ckpt.latest(str(tmp_path)) == path
    with pytest.raises(ValueError):
        ckpt.restore(path, {"w": tree["w"]})


def test_checkpoint_async(tmp_path):
    tree = _tree(np.random.default_rng(2))
    ckpt.save_async(str(tmp_path), 1, tree)
    ckpt.wait()
    restored, _ = ckpt.restore(ckpt.latest(str(tmp_path)), tree)
    _leaves_equal(restored, tree)


def test_checkpoint_load_without_reference_tree(tmp_path):
    arrays = [np.arange(4), np.ones((2, 2), np.float32)]
    path = ckpt.save(str(tmp_path), 3, arrays, extra={"k": "v"})
    leaves, manifest = ckpt.load(path)
    assert manifest["extra"] == {"k": "v"} and manifest["step"] == 3
    for a, b in zip(leaves, arrays):
        assert_same(a, b)


def test_concurrent_savers_drop_no_writes(tmp_path):
    savers = [ckpt.Saver() for _ in range(2)]
    dirs = [str(tmp_path / f"s{i}") for i in range(2)]
    barrier = threading.Barrier(2)

    def work(i):
        barrier.wait()
        for step in range(5):
            savers[i].save_async(dirs[i], step, [np.full(8, step)])
        savers[i].wait()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for d in dirs:
        path = ckpt.latest(d)
        assert path.endswith("step_00000004")
        assert ckpt.load(path)[0][0].tolist() == [4] * 8


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_training_checkpoint_crosses_packages(tmp_path, writer):
    tree = _tree(np.random.default_rng(3))
    jtree = _to_jax_leaves(tree)
    if writer == "port":
        path = ckpt.save(str(tmp_path), 5, tree, {"by": writer})
        got, manifest = j_ckpt.restore(path, jtree)
        want = jtree
    else:
        path = j_ckpt.save(str(tmp_path), 5, jtree, {"by": writer})
        got, manifest = ckpt.restore(path, tree)
        want = tree
    assert manifest["step"] == 5 and manifest["extra"] == {"by": writer}
    assert manifest["treedef"] == str(jax.tree_util.tree_structure(jtree))
    for a, b in zip(jax.tree_util.tree_leaves(_to_jax_leaves(got)),
                    jax.tree_util.tree_leaves(_to_jax_leaves(want))):
        assert_same(np.asarray(a), np.asarray(b))


# --- session checkpoint / restore -------------------------------------------
def apply_session_ops(session, db, ops):
    for op in ops:
        if op[0] == "submit":
            _, p, lo, hi = op
            session.submit(p, db.date[p, lo:hi], db.phenx[p, lo:hi])
        elif op[0] == "tick":
            session.service.tick()
        elif op[0] == "run":
            session.service.run()
        elif op[0] == "migrate":
            session.service.migrate(op[1], op[2])
        elif op[0] == "rebalance":
            session.service.rebalance(imbalance_threshold=op[1])


def assert_sessions_identical(a, b):
    """Every observable of two streaming sessions, byte for byte (either
    may be the reference's)."""
    sa, sb = a.service, b.service
    if hasattr(sb, "shards"):
        assert_same_sharded(sa, sb, stats=False)
        for va, vb in zip(sa.shards, sb.shards):
            assert va.store.rows.keys() == vb.store.rows.keys()
    else:
        x, y = sa.snapshot(), sb.snapshot()
        for name in ("seq", "dur", "patient", "counts"):
            assert_same(getattr(x, name), getattr(y, name), name)
        assert sa.store.pids == sb.store.pids
        assert {k: sa.store.tier_of(k) for k in sb.store.pids} == \
            {k: sb.store.tier_of(k) for k in sb.store.pids}
    assert sa.n_ticks == sb.n_ticks


def _config(n_shards, telemetry=False, **kw):
    return dict(engine="sharded" if n_shards > 1 else None, n_shards=n_shards,
                tick_patients=2, n_buckets_log2=H, screen="hash",
                budget_bytes=20_000, disk_bytes=5_000, telemetry=telemetry, **kw)


def _schedule(seed, n_shards, n_patients=10):
    rng = np.random.default_rng(seed)
    db = random_dbmart(rng, n_patients=n_patients, max_events=18)
    ops = make_ops(db, rng, n_shards, p_tick=0.2, p_run=0.15,
                   p_migrate=0.2 * (n_shards > 1), p_rebalance=0.1 * (n_shards > 1))
    return db, ops, int(rng.integers(1, len(ops)))


@pytest.mark.parametrize("n_shards,telemetry", [(1, False), (2, False), (2, True),
                                                (3, False)])
def test_checkpoint_restore_continues_byte_identical(tmp_path, n_shards, telemetry):
    """Checkpoint at a random point mid-chaos, restore into a fresh session,
    continue: byte-identical to an uninterrupted run, and batch-exact."""
    db, ops, cut = _schedule(7_700 + 10 * n_shards + telemetry, n_shards)
    config = MiningConfig(**_config(n_shards, telemetry))
    interrupted = MiningSession(config, device="cpu")
    apply_session_ops(interrupted, db, ops[:cut])
    taken = interrupted.events(kinds=CheckpointTaken)
    path = interrupted.checkpoint(str(tmp_path), extra={"cut": cut})
    assert [e.path for e in taken] == [path]
    resumed = MiningSession.restore(path, device="cpu")
    assert resumed.restore_extra == {"cut": cut} and resumed.config == config
    assert isinstance(resumed.service,
                      ShardedStreamService if n_shards > 1 else StreamService)
    assert resumed.plan().engine == ("sharded" if n_shards > 1 else "stream")
    apply_session_ops(resumed, db, ops[cut:])
    uninterrupted = MiningSession(config, device="cpu")
    apply_session_ops(uninterrupted, db, ops)
    assert_sessions_identical(resumed, uninterrupted)
    if n_shards > 1:
        assert_matches_batch(resumed.service, db)
    for f in (lambda s: s.frame().collect(), lambda s: s.frame().screen(2).collect()):
        for x, y in zip(f(resumed), f(uninterrupted)):
            assert_same(x, y)


def test_checkpoint_is_a_snapshot_not_a_barrier(tmp_path):
    """Checkpointing after every op (queued deltas and parked admits
    captured, not flushed) gives the uninterrupted run's bytes, and the
    last checkpoint restores to the same final state."""
    rng = np.random.default_rng(17)
    db = random_dbmart(rng, n_patients=6, max_events=10)
    config = MiningConfig(engine="sharded", n_shards=2, tick_patients=2,
                          n_buckets_log2=H, screen="hash", placement="devices")
    ops = make_ops(db, rng, 2, p_tick=0.2, p_run=0.15, p_migrate=0.2,
                   p_rebalance=0.1)
    chatty = MiningSession(config, device="cpu")
    assert chatty._ensure_service().async_migration
    for i, op in enumerate(ops):
        apply_session_ops(chatty, db, [op])
        chatty.checkpoint(str(tmp_path), step=i)
    uninterrupted = MiningSession(config, device="cpu")
    apply_session_ops(uninterrupted, db, ops)
    assert_sessions_identical(chatty, uninterrupted)
    final = MiningSession.restore(str(tmp_path), device="cpu")
    assert_sessions_identical(final, uninterrupted)


@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_session_checkpoint_crosses_packages(tmp_path, n_shards, writer):
    """A session checkpoint written by either package restores in the
    other, and the restored session continues as the writer's own restore
    does (and as the uninterrupted reference run)."""
    db, ops, cut = _schedule(8_100 + n_shards, n_shards, n_patients=8)
    cfg = _config(n_shards)
    ref = JSession(JConfig(**cfg))
    port = MiningSession(MiningConfig(**cfg, backend="torch"), device="cpu")
    apply_session_ops(ref, db, ops[:cut])
    apply_session_ops(port, db, ops[:cut])
    assert_sessions_identical(port, ref)
    src = ref if writer == "reference" else port
    path = src.checkpoint(str(tmp_path / "w"), extra={"by": writer})
    in_port = MiningSession.restore(path, device="cpu")
    in_ref = JSession.restore(path)
    assert in_port.restore_extra == in_ref.restore_extra == {"by": writer}
    assert in_port.config == MiningConfig.from_dict(
        dataclasses.asdict(in_ref.config))
    for s in (ref, in_port, in_ref):
        apply_session_ops(s, db, ops[cut:])
    assert_sessions_identical(in_port, in_ref)
    assert_sessions_identical(in_port, ref)


def test_restore_refuses_what_is_not_a_session_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        MiningSession.restore(str(tmp_path / "none"), device="cpu")
    path = ckpt.save(str(tmp_path), 0, [np.zeros(1)],
                     extra={"session": {"format": "other"}})
    with pytest.raises(ValueError, match="not a session checkpoint"):
        MiningSession.restore(path, device="cpu")
    with pytest.raises(RuntimeError, match="nothing to checkpoint"):
        MiningSession(MiningConfig(), device="cpu").checkpoint(str(tmp_path))
