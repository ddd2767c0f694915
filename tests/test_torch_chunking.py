"""Chunked, fused and file-based mining: the port against the reference on
the CPU, byte for byte.  Mirrors tests/test_chunking.py; spill directories
written by either package read back in the other."""
import numpy as np
import pytest
import torch

from repro.core import chunking as j_chunking
from repro.core import mining as j_mining
from repro.core import sparsity as j_sparsity
from repro.data import synthea
from repro.data.dbmart import from_rows
from repro_torch.core import chunking, mining
from tests.conftest import random_dbmart
from tests.torch_parity import assert_same, port_db

CPU = dict(device="cpu")


def _flat_set(seq, dur, pat, mask):
    seq, dur, pat, mask = (np.asarray(x) for x in (seq, dur, pat, mask))
    return set(zip(seq[mask].tolist(), dur[mask].tolist(), pat[mask].tolist()))


def _assert_rows(got: dict, want: dict, what: str) -> None:
    """The port's compacted rows == the reference's real rows, in order."""
    m = np.asarray(want["mask"]) if "mask" in want else slice(None)
    for k in ("seq", "dur", "patient"):
        assert_same(got[k], np.asarray(want[k])[m], f"{what} {k}")


def test_plan_chunks_budget_and_cover():
    nevents = np.random.default_rng(0).integers(1, 200, 500).astype(np.int32)
    budget = 4 << 20
    chunks = chunking.plan_chunks(nevents, budget)
    assert chunks == [chunking.Chunk(c.start, c.stop, c.max_events)
                      for c in j_chunking.plan_chunks(nevents, budget)]
    assert chunks[0].start == 0 and chunks[-1].stop == 500
    for a, b in zip(chunks, chunks[1:]):
        assert a.stop == b.start
    for c in chunks:
        cost = c.n_patients * c.max_events ** 2 * chunking.BYTES_PER_PAIR * 0.5
        assert cost <= budget or c.n_patients == 1
        assert c.max_events >= int(nevents[c.start:c.stop].max())


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_chunked_equals_unchunked(backend):
    db = random_dbmart(np.random.default_rng(5), n_patients=40, max_events=24)
    whole = mining.mine_triangular(db.phenx, db.date, db.nevents)
    expect = _flat_set(*mining.flatten(whole))
    out = chunking.mine_chunked(port_db(db), budget_bytes=64 << 10,
                                backend=backend, **CPU)
    assert _flat_set(out["seq"], out["dur"], out["patient"], out["mask"]) == expect
    assert out["mask"].all()
    assert len(out["mask"]) == int(mining.count_sequences(db.nevents))
    if backend == "torch":      # the reference's layout: the same rows in order
        _assert_rows(out, j_chunking.mine_chunked(db, budget_bytes=64 << 10), "rows")


@pytest.fixture(scope="module")
def synthea_db():
    pats, dates, phx, _ = synthea.generate_cohort(n_patients=64, avg_events=16,
                                                  seed=2)
    return from_rows(pats, dates, phx)


def test_chunked_screen_matches_global(tmp_path, synthea_db):
    db, threshold = synthea_db, 4
    whole = j_mining.mine_triangular(db.phenx, db.date, db.nevents)
    n_ref = int(np.asarray(j_sparsity.screen_hash(
        whole.seq, whole.mask, threshold, n_buckets_log2=22)).sum())

    out = chunking.mine_chunked(port_db(db), budget_bytes=128 << 10,
                                threshold=threshold, **CPU)
    want = j_chunking.mine_chunked(db, budget_bytes=128 << 10, threshold=threshold)
    assert int(out["keep"].sum()) == n_ref
    _assert_rows(out, want, "chunked")
    assert_same(out["counts"], want["counts"], "counts")
    assert_same(out["keep"], np.asarray(want["keep"])[want["mask"]], "keep")

    paths = chunking.mine_to_files(port_db(db), str(tmp_path / "spill"),
                                   budget_bytes=128 << 10, **CPU)
    assert len(paths) > 1
    n_file = sum(len(part["seq"]) for part in
                 chunking.screen_files(str(tmp_path / "spill"), threshold))
    assert n_file == n_ref


def test_mine_fused_matches_reference(synthea_db):
    db = synthea_db
    for fuse in (False, True):
        kw = dict(threshold=3, budget_bytes=96 << 10, n_buckets_log2=10,
                  fuse_duration=fuse)
        got = chunking.mine_fused(port_db(db), **kw, **CPU)
        want = j_chunking.mine_fused(db, **kw)
        for k in ("seq", "dur", "patient", "counts"):
            assert_same(got[k], want[k], f"fuse={fuse} {k}")


def test_hash_screen_threshold_edge(tmp_path):
    """Support exactly == threshold survives in both file-based and in-memory
    modes; == threshold - 1 does not, with one patient per chunk."""
    n_support = 5
    pats = [p for p in range(n_support) for _ in range(2)]
    dates = [d for _ in range(n_support) for d in (0, 10)]
    phx = [x for _ in range(n_support) for x in ("A", "B")]
    db = port_db(from_rows(pats, dates, phx))
    budget = 900            # one patient per chunk: 8*8*26*0.5 = 832 bytes
    assert len(chunking.plan_chunks(np.asarray(db.nevents), budget)) == n_support

    for threshold, survives in ((n_support, True), (n_support + 1, False)):
        out = chunking.mine_chunked(db, budget_bytes=budget, threshold=threshold,
                                    **CPU)
        assert int(out["keep"].sum()) == (n_support if survives else 0)
        chunking.mine_to_files(db, str(tmp_path / f"spill{threshold}"),
                               budget_bytes=budget, **CPU)
        n_file = sum(len(part["seq"]) for part in chunking.screen_files(
            str(tmp_path / f"spill{threshold}"), threshold))
        assert n_file == (n_support if survives else 0)

    out = chunking.load_files(str(tmp_path / f"spill{n_support}"))
    assert len(out["seq"]) == n_support
    assert int(out["counts"].sum()) == n_support
    ref = chunking.mine_chunked(db, budget_bytes=budget, with_counts=True, **CPU)
    assert (out["counts"] == ref["counts"]).all()


@pytest.mark.parametrize("fuse", [False, True])
def test_spill_directories_cross_packages(tmp_path, synthea_db, fuse):
    """Reference mine_to_files -> port load_files/screen_files, and the
    reverse: the same arrays, file for file."""
    db = synthea_db
    kw = dict(budget_bytes=128 << 10, n_buckets_log2=12, fuse_duration=fuse)
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    j_paths = j_chunking.mine_to_files(db, j_dir, **kw)
    t_paths = chunking.mine_to_files(port_db(db), t_dir, **kw, **CPU)
    assert [p.rsplit("/", 1)[1] for p in j_paths] == \
        [p.rsplit("/", 1)[1] for p in t_paths]
    for a, b in zip(j_paths, t_paths):
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert_same(zb[k], za[k], f"{b} {k}")
    for reader, writer in ((chunking.load_files, j_dir),
                           (j_chunking.load_files, t_dir)):
        got, want = reader(writer), j_chunking.load_files(j_dir)
        for k in ("seq", "dur", "patient", "counts"):
            assert_same(got[k], want[k], f"{writer} {k}")
    for got, want in zip(chunking.screen_files(j_dir, 3, 12),
                         j_chunking.screen_files(t_dir, 3, 12)):
        for k in ("seq", "dur", "patient"):
            assert_same(got[k], want[k], k)


def test_rows_are_compacted_on_the_device_order():
    """real_rows keeps flatten's order and patient offsets."""
    db = random_dbmart(np.random.default_rng(9), n_patients=6, max_events=12)
    mined = mining.mine_dense(db.phenx, db.date, db.nevents)
    seq, dur, pat, msk = mining.flatten(mined, patient_offset=7)
    got = chunking.real_rows(mined, 7)
    for g, w in zip(got, (seq[msk], dur[msk], pat[msk])):
        assert_same(g, w, "real rows")
    assert got[2].dtype == torch.int32
