"""Port parity: core/sparsity and core/chunking.plan_chunks vs the reference."""
import numpy as np
import pytest
import torch

from repro.core import chunking as j_chunking
from repro.core import encoding as j_enc
from repro.core import mining as j_mining
from repro.core import sparsity as j_sparsity
from repro_torch.core import chunking as t_chunking
from repro_torch.core import mining as t_mining
from repro_torch.core import sparsity as t_sparsity
from tests.conftest import random_dbmart
from tests.torch_parity import assert_same


def _corpus(seed, P=10, E=20, V=5, layout="triangular"):
    """Flat mined corpus of a random dbmart; few codes, so support > 1."""
    db = random_dbmart(np.random.default_rng(seed), n_patients=P,
                       max_events=E, n_codes=V)
    fn = "mine_triangular" if layout == "triangular" else "mine_dense"
    mined = getattr(j_mining, fn)(db.phenx, db.date, db.nevents)
    return tuple(np.array(a) for a in j_mining.flatten(mined)), mined


@pytest.mark.parametrize("layout", ["triangular", "dense"])
def test_support_counts(layout):
    (seq, dur, pat, msk), _ = _corpus(1, layout=layout)
    got = t_sparsity.support_counts(torch.from_numpy(seq), torch.from_numpy(pat),
                                    torch.from_numpy(msk))
    want = j_sparsity.support_counts(seq, pat, msk)
    for g, w, name in zip(got, want, ("keys", "patient", "support", "u_key",
                                      "u_support", "n_unique")):
        assert_same(g, w, name)


@pytest.mark.parametrize("layout", ["triangular", "dense"])
@pytest.mark.parametrize("threshold", [1, 3, 6])
def test_screen_sorted(layout, threshold):
    """Two stable sorts reproduce the reference's stable two-key sort: the
    duration column keeps its input order within (id, patient) ties."""
    (seq, dur, pat, msk), _ = _corpus(2, layout=layout)
    got = t_sparsity.screen_sorted(seq, dur, pat, msk, threshold)
    want = j_sparsity.screen_sorted(seq, dur, pat, msk, threshold)
    for g, w, name in zip(got, want, got._fields):
        assert_same(g, w, name)


@pytest.mark.parametrize("H", [1, 12, 14, 20, 24])
def test_hash_bucket_wraps_like_reference(H):
    rng = np.random.default_rng(H)
    ids = np.concatenate([rng.integers(-2**63, 2**63 - 1, 500, dtype=np.int64),
                          [j_enc.SENTINEL, 0, 1, -1, -2**63]]).astype(np.int64)
    assert_same(t_sparsity.hash_bucket(torch.from_numpy(ids), H),
                j_sparsity.hash_bucket(ids, H), f"hash H={H}")


@pytest.mark.parametrize("H", [10, 12, 14])
@pytest.mark.parametrize("layout", ["triangular", "dense"])
def test_local_bucket_counts_and_screen_hash(H, layout):
    _, mined = _corpus(3, P=9, E=24, layout=layout)
    seq, mask = np.array(mined.seq), np.array(mined.mask)
    srt = np.sort(np.where(mask, seq, j_enc.SENTINEL).reshape(9, -1), axis=1)
    assert_same(t_sparsity.row_first_flags(torch.from_numpy(srt)),
                j_sparsity.row_first_flags(srt), "row_first_flags")
    counts = t_sparsity.local_bucket_counts(torch.from_numpy(seq),
                                            torch.from_numpy(mask), H)
    want = j_sparsity.local_bucket_counts(seq, mask, H)
    assert_same(counts, want, "counts")
    for thr in (1, 4):
        assert_same(t_sparsity.screen_hash(seq, mask, thr, H),
                    j_sparsity.screen_hash(seq, mask, thr, H), "screen_hash")
        assert_same(t_sparsity.screen_hash_from_counts(seq, mask, counts, thr, H),
                    j_sparsity.screen_hash_from_counts(seq, mask, want, thr, H),
                    "screen_hash_from_counts")
    assert_same(t_sparsity.merge_bucket_counts(counts, counts, counts),
                j_sparsity.merge_bucket_counts(want, want, want), "merge")


def test_hash_screen_is_one_sided():
    """A sequence with exact support >= threshold is never dropped."""
    (seq, dur, pat, msk), mined = _corpus(4, P=12, E=20, V=4)
    keep = t_sparsity.screen_hash(mined.seq, mined.mask, 5, 6).numpy().reshape(-1)
    s = t_sparsity.screen_sorted(seq, dur, pat, msk, 5)
    exact = set(s.seq[: int(s.n_kept)].tolist())
    kept = set(seq[keep].tolist())
    assert exact <= kept


def test_plan_chunks():
    rng = np.random.default_rng(0)
    nev = rng.integers(0, 60, 40)
    for budget in (1 << 12, 1 << 16, 1 << 20):
        for layout in ("triangular", "dense"):
            assert (t_chunking.plan_chunks(nev, budget, layout=layout)
                    == [t_chunking.Chunk(c.start, c.stop, c.max_events) for c in
                        j_chunking.plan_chunks(nev, budget, layout=layout)])
    assert t_chunking.BYTES_PER_PAIR == j_chunking.BYTES_PER_PAIR


def test_port_mining_feeds_port_screens():
    """Port-mined ids screen to the reference's answer end to end."""
    db = random_dbmart(np.random.default_rng(5), n_patients=8, max_events=16,
                       n_codes=4)
    t = t_mining.mine(db.phenx, db.date, db.nevents, backend="kernel")
    j = j_mining.mine_dense(db.phenx, db.date, db.nevents)
    assert_same(t_sparsity.local_bucket_counts(t.seq, t.mask, 12),
                j_sparsity.local_bucket_counts(j.seq, j.mask, 12), "counts")
