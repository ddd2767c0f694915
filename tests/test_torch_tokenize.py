"""The port's ``data/tokenize`` (a copy of the reference's numpy code)
against the reference, byte for byte: ``gap_bucket``, ``patient_documents``,
``pack_corpus`` and the ``lm_batches`` stream, on a synthea cohort and on
benchmark rows of the paper's Table 1 shape."""
import numpy as np
import pytest

from repro.data import dbmart as j_dbmart
from repro.data import synthea as j_synthea
from repro.data import tokenize as j_tok
from repro_torch.data import tokenize
from tests.torch_parity import assert_same, port_db


def _cohorts():
    pats, dates, phx, _ = j_synthea.generate_cohort(n_patients=48, avg_events=24, seed=5)
    yield j_dbmart.from_rows(pats, dates, phx)
    pid, date, xid, _ = j_synthea.generate_benchmark_rows(12, 120, 0)
    yield j_dbmart.from_rows(pid.tolist(), date.tolist(), [f"phx{v}" for v in xid.tolist()])


def test_gap_bucket():
    days = np.array([-5, 0, 1, 2, 3, 4, 7, 8, 100, 40000, 2**31 - 1], np.int64)
    assert_same(tokenize.gap_bucket(days), j_tok.gap_bucket(days), "gap_bucket")
    assert (tokenize.PAD, tokenize.BOS, tokenize.EOS, tokenize.SEP,
            tokenize.PHENX_OFFSET) == (j_tok.PAD, j_tok.BOS, j_tok.EOS, j_tok.SEP,
                                       j_tok.PHENX_OFFSET)


@pytest.mark.parametrize("which", [0, 1])
def test_documents_corpus_and_batches_match_reference(which):
    db = list(_cohorts())[which]
    pdb = port_db(db)
    got, want = tokenize.patient_documents(pdb), j_tok.patient_documents(db)
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, f"document {i}")
    for seq_len in (32, 128):
        gc = tokenize.pack_corpus(pdb, seq_len)
        wc = j_tok.pack_corpus(db, seq_len)
        assert_same(gc.tokens, wc.tokens, "tokens")
        assert_same(gc.loss_mask, wc.loss_mask, "loss_mask")
        assert gc.vocab_size == wc.vocab_size
        for gb, wb, _ in zip(tokenize.lm_batches(gc, 4, seed=3),
                             j_tok.lm_batches(wc, 4, seed=3), range(3)):
            for key in ("tokens", "labels", "loss_mask"):
                assert_same(gb[key], wb[key], key)
    assert tokenize.pack_corpus(pdb, 64, vocab_size=4096).vocab_size == 4096
