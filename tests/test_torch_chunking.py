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
from repro_torch.api import MiningConfig
from repro_torch.api import planner as t_planner
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


@pytest.mark.parametrize("budget", [64 << 20, 1 << 30, 4 << 30])
def test_card_plan_prices_within_budget(budget):
    """The card's chunk price at the Table 2 cohort's shape (35,000
    patients, E = 240): every chunk's reckoned peak (tables, dense slab,
    event planes, one piece's scratch) is within the budget, the chunks
    cover every patient in order, and the planner counts them on a CUDA
    device (the reference's plan still on the CPU)."""
    nevents = np.random.default_rng(35).integers(120, 241, 35000).astype(np.int32)
    plan = chunking.plan_card_chunks(nevents, budget, n_buckets_log2=20)
    chunks = plan.chunks
    assert chunks[0].start == 0 and chunks[-1].stop == len(nevents)
    for a, b in zip(chunks, chunks[1:]):
        assert a.stop == b.start
    assert 1 <= plan.piece_slots <= chunking.sparsity.BLOCK_ELEMENTS
    for c in chunks:
        assert plan.chunk_bytes(c) <= budget
        assert c.max_events >= int(nevents[c.start:c.stop].max())
        assert plan.piece_rows(c) >= 1
    # the dense slab alone is the reference's whole price, so the card's
    # plan never has fewer chunks than the reference's
    assert len(chunks) >= len(chunking.plan_chunks(nevents, budget))
    cfg = MiningConfig(budget_bytes=budget, engine="chunked")
    assert t_planner.make_plan(cfg, nevents).n_chunks == len(chunks)
    assert t_planner.make_plan(cfg, nevents, device="cpu").n_chunks == \
        len(j_chunking.plan_chunks(nevents, budget))


def test_card_price_counts_the_allocators_rounding():
    """A chunk's price holds, beside its bytes, up to 1 MiB for every
    tensor of more than 1 MiB that may live at its peak (the caching
    allocator hands such a block out whole when 1 MiB or less would be
    left) and 512 B for every smaller one."""
    assert chunking.alloc_over(1 << 20) == 512
    assert chunking.alloc_over((1 << 20) + 1) == 1 << 20
    plan = chunking.ChunkPlan([], piece_slots=1 << 20, table_bytes=4 << 20)
    big = chunking.Chunk(0, 400, 304)        # slab tensors of 37-296 MB
    tiny = chunking.Chunk(0, 1, 8)           # every tensor under 1 MiB
    for ch, rounding in ((big, (3 + chunking.CARD_TABLES + chunking.CARD_PIECE_TENSORS)
                          * (1 << 20) + 3 * 512),
                         (tiny, (3 + 3 + chunking.CARD_PIECE_TENSORS) * 512
                          + chunking.CARD_TABLES * (1 << 20))):
        n, e = ch.n_patients, ch.max_events
        piece = min(plan.piece_rows(ch), n) * e * e     # a piece is within its chunk
        held = (chunking.CARD_TABLES * plan.table_bytes + chunking.CARD_SMALL_BYTES
                + n * (e * e * chunking.CARD_SLAB_BYTES + 8 * e + 4)
                + piece * chunking.CARD_SCRATCH_BYTES)
        assert plan.chunk_bytes(ch) == held + rounding


def test_card_plan_gives_the_reference_rows(tmp_path, synthea_db, monkeypatch):
    """The card's chunks and pieces, run on the CPU: the same rows in the
    same order, tables, survivors and spill directory contents as the
    reference's plan (rows do not depend on where chunks end)."""
    db = synthea_db
    kw = dict(budget_bytes=512 << 10, n_buckets_log2=8)
    want = j_chunking.mine_chunked(db, with_counts=True, **kw)
    want_fused = j_chunking.mine_fused(db, threshold=3, **kw)
    card = chunking.plan_card_chunks(db.nevents, kw["budget_bytes"], 8)
    assert len(card.chunks) > len(chunking.plan_chunks(db.nevents, kw["budget_bytes"]))
    assert any(card.piece_rows(c) < c.n_patients for c in card.chunks)
    monkeypatch.setattr(chunking, "plan_device_chunks",
                        lambda nev, budget, device, H, net=None: chunking.plan_card_chunks(
                            nev, budget, H))
    got = chunking.mine_chunked(port_db(db), with_counts=True, **kw, **CPU)
    _assert_rows(got, want, "card chunks")
    assert_same(got["counts"], want["counts"], "counts")
    fused = chunking.mine_fused(port_db(db), threshold=3, **kw, **CPU)
    for k in ("seq", "dur", "patient", "counts"):
        assert_same(fused[k], want_fused[k], f"fused {k}")
    paths = chunking.mine_to_files(port_db(db), str(tmp_path / "spill"), **kw, **CPU)
    assert len(paths) == len(card.chunks)
    back = j_chunking.load_files(str(tmp_path / "spill"))
    for k in ("seq", "dur", "patient", "counts"):
        assert_same(back[k], np.asarray(want[k])[want["mask"]] if k != "counts"
                    else want[k], f"files {k}")


@pytest.mark.parametrize("before", [0, 64 << 20, 300 << 20])
def test_card_plan_within_budget_net_of_a_prior_allocation(monkeypatch, before):
    """On the card the chunks are planned against budget_bytes less what
    is already allocated when the fit starts (here 0-300 MiB, e.g. a cuBLAS
    workspace or another fit's tables), so that allocation plus any
    chunk's price stays within the budget."""
    budget = 512 << 20
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: before)
    nevents = np.random.default_rng(36).integers(120, 305, 4985).astype(np.int32)
    plan = chunking.plan_device_chunks(nevents, budget, "cuda", 20)
    assert chunking.net_budget(budget, "cuda") == budget - before
    assert chunking.net_budget(budget, "cpu") == budget
    assert plan.chunks == chunking.plan_card_chunks(nevents, budget - before, 20).chunks
    for c in plan.chunks:
        assert before + plan.chunk_bytes(c) <= budget
    assert plan.chunks[0].start == 0 and plan.chunks[-1].stop == len(nevents)
    if before:
        assert len(plan.chunks) > len(chunking.plan_card_chunks(nevents, budget, 20).chunks)


def test_card_plan_with_nothing_left_takes_a_patient_a_chunk(monkeypatch):
    """Less than one patient's price left: every patient a chunk of its
    own, never split, as for a budget that small."""
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 1 << 30)
    nevents = np.array([40, 3, 0, 17], np.int32)
    plan = chunking.plan_device_chunks(nevents, 1 << 20, "cuda", 12)
    assert [(c.start, c.stop) for c in plan.chunks] == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert chunking.net_budget(1 << 20, "cuda") == 0


@pytest.mark.parametrize("H", [15, 20, 24])
def test_fused_round_pairs_fit_the_net_budget(H):
    """The counting pass's rounds: the cohort on the card, the tables, the
    offsets and 2 B a pair of scratch fit what the budget leaves; a large
    budget gives the plan's fixed round, none gives one pair (a patient
    over it is then a round of its own)."""
    from repro_torch.analysis import roofline
    from repro_torch.kernels import bucket_count as bc

    P, E = 35000, 240
    net = 512 << 20
    pairs = chunking.fused_round_pairs(P, E, net, H)
    table = 4 << H
    held = (8 * P * E + 4 * P + chunking.CARD_TABLES * table + chunking.CARD_SMALL_BYTES
            + bc.scratch_bytes(0, bc.n_partitions(1 << H), bc.MAX_GRID))
    assert 1 < pairs and held + 2 * pairs <= net
    big = chunking.fused_round_pairs(P, E, 64 << 30, H)
    assert big == roofline.FUSED_SCRATCH_BYTES // 2
    assert chunking.fused_round_pairs(P, E, 0, H) == 1
