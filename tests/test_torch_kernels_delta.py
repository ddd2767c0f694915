"""The delta kernel's plain version in the port against the reference.

Twin of tests/test_kernels_delta.py.  The reference runs its Pallas kernel
``delta_pairgen(..., interpret=True)`` as its own tests do, and its
``delta_mine_jnp``; the port runs the wrapper's CPU branch, its plain
version (``stream.delta.delta_mine_torch``).  Integer slabs are compared
byte for byte, padding included.  The CUDA kernel itself is held against
the same plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 3).
"""
import numpy as np
import pytest
import torch

from repro.kernels.tspm_delta import ops as j_ops
from repro.kernels.tspm_delta import ref as j_ref
from repro.stream import delta as j_delta
from repro_torch.core import mining
from repro_torch.kernels.tspm_delta import ops, ref
from repro_torch.stream import delta as stream_delta
from tests.conftest import random_dbmart
from tests.torch_parity import assert_same


def split_delta(db, frac=0.5):
    """(n_old, n_new, new_phenx, new_date) splitting each history at frac."""
    n_old = (db.nevents * frac).astype(np.int32)
    n_new = (db.nevents - n_old).astype(np.int32)
    D = max(int(n_new.max(initial=1)), 1)
    new_ph = np.zeros((db.n_patients, D), np.int32)
    new_dt = np.zeros((db.n_patients, D), np.int32)
    for p in range(db.n_patients):
        o, n = int(n_old[p]), int(db.nevents[p])
        new_ph[p, : n - o] = db.phenx[p, o:n]
        new_dt[p, : n - o] = db.date[p, o:n]
    return n_old, n_new, new_ph, new_dt


def _assert_matches_reference(phenx, date, n_old, n_new, new_ph, new_dt,
                              codec="bit", fuse=False, kernel=True):
    """The port's wrapper == the reference's jnp slab (every slot) and the
    reference's interpret-mode kernel (on the valid slots, which is what
    the reference's own tests compare)."""
    args = (phenx, date, n_old, n_new, new_ph, new_dt)
    got = ops.delta_pairgen(*(torch.from_numpy(np.asarray(a)) for a in args),
                            codec=codec, fuse_duration=fuse)
    want = j_delta.delta_mine_jnp(*args, codec=codec, fuse_duration=fuse)
    for g, w, name in zip(got, want, ("seq", "dur", "mask")):
        assert_same(g, w, name)
    assert_same(stream_delta.delta_mine(*args, codec=codec, fuse_duration=fuse,
                                        backend="torch").seq, want.seq, "torch")
    if kernel:
        k = j_ops.delta_pairgen(*args, codec=codec, fuse_duration=fuse,
                                interpret=True)
        m = np.asarray(k.mask)
        assert (got.mask.numpy() == m).all()
        assert (got.seq.numpy()[m] == np.asarray(k.seq)[m]).all()
        assert (got.dur.numpy()[m] == np.asarray(k.dur)[m]).all()
    return got.mask.numpy()


@pytest.mark.parametrize("P,E", [(1, 8), (3, 16), (8, 48), (7, 130)])
def test_delta_matches_reference(P, E):
    db = random_dbmart(np.random.default_rng(P * 100 + E),
                       n_patients=P, max_events=E)
    _assert_matches_reference(db.phenx, db.date, *split_delta(db))


def test_delta_planes_match_planes_ref():
    db = random_dbmart(np.random.default_rng(2), n_patients=8, max_events=32)
    args = (db.phenx, db.date, *split_delta(db))
    got = ref.delta_planes_ref(*(torch.from_numpy(np.asarray(a)) for a in args))
    for g, w in zip(got, j_ref.delta_planes_ref(*args)):
        assert_same(g, w, "plane")


@pytest.mark.parametrize("codec,fuse", [("bit", False), ("bit", True),
                                        ("paper", False), ("paper", True)])
def test_delta_codecs_and_fusion(codec, fuse):
    db = random_dbmart(np.random.default_rng(5), n_patients=6, max_events=20)
    _assert_matches_reference(db.phenx, db.date, *split_delta(db), codec=codec,
                              fuse=fuse, kernel=(codec, fuse) == ("paper", True))


def test_negative_codes_clamp_as_reference():
    """The packing clamps codes at 0 on valid slots (``max(s, 0)``)."""
    rng = np.random.default_rng(6)
    phenx = rng.integers(-3, 3, (3, 8)).astype(np.int32)
    date = np.sort(rng.integers(0, 90, (3, 8)), axis=1).astype(np.int32)
    new_ph = rng.integers(-3, 3, (3, 4)).astype(np.int32)
    new_dt = np.sort(rng.integers(90, 200, (3, 4)), axis=1).astype(np.int32)
    for codec in ("bit", "paper"):
        _assert_matches_reference(phenx, date, np.asarray([4, 2, 0], np.int32),
                                  np.asarray([4, 3, 2], np.int32), new_ph,
                                  new_dt, codec=codec, kernel=False)


def test_old_pairs_plus_delta_slab_is_full_mine():
    """The streaming invariant at one split point: mine(n_old) + delta slab
    == mine(n) as multisets of (patient, seq, dur)."""
    for s in range(4):
        db = random_dbmart(np.random.default_rng(s), n_patients=5)
        n_old, n_new, new_ph, new_dt = split_delta(db, frac=0.4)
        slab = stream_delta.delta_mine_torch(db.phenx, db.date, n_old, n_new,
                                             new_ph, new_dt)
        old = mining.mine_triangular(db.phenx, db.date, n_old)
        os_, od, op, om = (x.numpy() for x in mining.flatten(old))
        sm = slab.mask.numpy()
        got = sorted(
            list(zip(op[om], os_[om], od[om]))
            + [(p, s_, d_) for p in range(db.n_patients)
               for s_, d_ in zip(slab.seq.numpy()[p][sm[p]],
                                 slab.dur.numpy()[p][sm[p]])])
        full = mining.mine_dense(db.phenx, db.date, db.nevents)
        fs, fd, fp, fm = (x.numpy() for x in mining.flatten(full))
        assert got == sorted(zip(fp[fm], fs[fm], fd[fm]))


def test_delta_empty_delta_window():
    """d == 0 for every patient, and literally zero-width delta planes:
    no pair is valid, and the D == 0 slab keeps its shape."""
    db = random_dbmart(np.random.default_rng(0), n_patients=4, max_events=16)
    zeros = np.zeros(db.n_patients, np.int32)
    for D in (4, 0):
        m = _assert_matches_reference(
            db.phenx, db.date, np.asarray(db.nevents, np.int32), zeros,
            np.zeros((db.n_patients, D), np.int32),
            np.zeros((db.n_patients, D), np.int32))
        assert not m.any() and m.shape == (db.n_patients, db.phenx.shape[1], D)


@pytest.mark.parametrize("shape", [(0, 8, 4), (3, 0, 4), (3, 8, 0)])
def test_delta_zero_width_slab(shape):
    P, E, D = shape
    args = (np.zeros((P, E), np.int32), np.zeros((P, E), np.int32),
            np.zeros(P, np.int32), np.zeros(P, np.int32),
            np.zeros((P, D), np.int32), np.zeros((P, D), np.int32))
    got = ops.delta_pairgen(*(torch.from_numpy(a) for a in args))
    want = j_ops.delta_pairgen(*args, interpret=True)
    for g, w, name in zip(got, want, ("seq", "dur", "mask")):
        assert_same(g, w, name)


def test_delta_mixed_empty_rows():
    db = random_dbmart(np.random.default_rng(1), n_patients=6, max_events=12)
    n_old, n_new, new_ph, new_dt = split_delta(db)
    n_new[::2] = 0
    m = _assert_matches_reference(db.phenx, db.date, n_old, n_new, new_ph, new_dt)
    assert not m[::2].any()


def test_delta_single_event_history():
    rng = np.random.default_rng(2)
    P, E, D = 3, 8, 5
    phenx = rng.integers(0, 30, (P, E)).astype(np.int32)
    date = np.sort(rng.integers(0, 100, (P, E)).astype(np.int32), axis=1)
    n_old = np.asarray([1, 1, 0], np.int32)
    n_new = np.asarray([D, 1, 2], np.int32)
    new_ph = rng.integers(0, 30, (P, D)).astype(np.int32)
    new_dt = np.sort(rng.integers(100, 200, (P, D)).astype(np.int32), axis=1)
    m = _assert_matches_reference(phenx, date, n_old, n_new, new_ph, new_dt)
    assert m[0].sum() == D + D * (D - 1) // 2
    assert m[2].sum() == 1


@pytest.mark.parametrize("E,D", [(127, 129), (128, 128), (129, 127)])
def test_delta_at_pad_and_tile_boundary(E, D):
    rng = np.random.default_rng(E + D)
    P = 2
    phenx = rng.integers(0, 50, (P, E)).astype(np.int32)
    date = np.sort(rng.integers(0, 500, (P, E)).astype(np.int32), axis=1)
    n_old = np.asarray([max(E - D // 2, 0), 96], np.int32)
    n_new = np.asarray([D // 2, D], np.int32)
    new_ph = rng.integers(0, 50, (P, D)).astype(np.int32)
    new_dt = np.sort(rng.integers(500, 900, (P, D)).astype(np.int32), axis=1)
    _assert_matches_reference(phenx, date, n_old, n_new, new_ph, new_dt,
                              kernel=(E, D) == (128, 128))


def test_delta_history_at_full_plane_capacity():
    rng = np.random.default_rng(4)
    P, E, D = 3, 16, 4
    phenx = rng.integers(0, 30, (P, E)).astype(np.int32)
    date = np.sort(rng.integers(0, 300, (P, E)).astype(np.int32), axis=1)
    n_new = np.asarray([D, D, D], np.int32)
    n_old = np.asarray([E - D] * P, np.int32)     # planes exactly full
    m = _assert_matches_reference(phenx, date, n_old, n_new, phenx[:, E - D:],
                                  date[:, E - D:])
    assert m.sum() == int(stream_delta.count_delta_pairs(n_old, n_new))


def test_count_delta_pairs_closed_form():
    db = random_dbmart(np.random.default_rng(9), n_patients=7)
    n_old, n_new, new_ph, new_dt = split_delta(db, frac=0.3)
    slab = stream_delta.delta_mine_torch(db.phenx, db.date, n_old, n_new,
                                         new_ph, new_dt)
    got = stream_delta.count_delta_pairs(n_old, n_new)
    assert int(got) == int(slab.mask.sum()) == \
        int(j_delta.count_delta_pairs(n_old, n_new))


def test_dispatch_follows_the_device():
    """'torch' is for CPU tensors only; a CUDA device takes the kernel or
    raises; a tensor on any other device is refused by the wrapper."""
    with pytest.raises(ValueError, match="CPU tensors"):
        mining.resolve_backend("torch", "cuda")
    assert mining.resolve_backend("auto", "cuda") == "kernel"
    meta = [torch.empty((2, 8), dtype=torch.int32, device="meta")] * 2 \
        + [torch.empty(2, dtype=torch.int32, device="meta")] * 2 \
        + [torch.empty((2, 4), dtype=torch.int32, device="meta")] * 2
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.delta_pairgen(*meta)
    before = ops.delta_pairgen.launches
    db = random_dbmart(np.random.default_rng(3), n_patients=3, max_events=10)
    stream_delta.delta_mine(db.phenx, db.date, *split_delta(db), backend="kernel")
    assert ops.delta_pairgen.launches == before   # the CPU launches nothing
