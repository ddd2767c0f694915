"""Port parity: core/encoding, data/dbmart and data/synthea vs the reference."""
import numpy as np
import pytest
import torch

from repro.core import encoding as j_enc
from repro.data import dbmart as j_dbmart
from repro.data import synthea as j_synthea
from repro_torch.core import encoding as t_enc
from repro_torch.data import dbmart as t_dbmart
from repro_torch.data import synthea as t_synthea
from tests.conftest import random_dbmart
from tests.torch_parity import assert_same, port_db


def _ids(rng, n=400):
    return (rng.integers(0, 4000, n).astype(np.int32),
            rng.integers(0, 4000, n).astype(np.int32))


@pytest.mark.parametrize("codec", ["bit", "paper"])
def test_pack_unpack(codec):
    s, e = _ids(np.random.default_rng(0))
    p = t_enc.pack(torch.from_numpy(s), torch.from_numpy(e), codec)
    assert_same(p, j_enc.pack(s, e, codec), "pack")
    ids = np.concatenate([t_enc.pack(torch.from_numpy(s), torch.from_numpy(e),
                                     codec).numpy(),
                          [t_enc.SENTINEL, 0, -1]]).astype(np.int64)
    for got, want in zip(t_enc.unpack(torch.from_numpy(ids), codec),
                         j_enc.unpack(ids, codec)):
        assert_same(got, want, "unpack")


def test_fuse_split_and_floor_buckets():
    rng = np.random.default_rng(1)
    seq = rng.integers(0, 1 << 40, 300).astype(np.int64)
    # negative and huge durations exercise floor division and the clip
    dur = np.concatenate([rng.integers(-100, 4000, 290),
                          [-1, -30, -31, 0, 29, 30, 2**31 - 1, -2**31,
                           30 * (1 << 15), 30 * (1 << 15) - 1]]).astype(np.int32)
    for days in (1, 7, 30):
        assert_same(t_enc.bucket_duration(torch.from_numpy(dur), days),
                    j_enc.bucket_duration(dur, days), f"bucket {days}")
    b = t_enc.bucket_duration(torch.from_numpy(dur)).numpy()
    fused = t_enc.fuse_duration(torch.from_numpy(seq), torch.from_numpy(b))
    assert_same(fused, j_enc.fuse_duration(seq, b), "fuse")
    for got, want in zip(t_enc.split_duration(fused),
                         j_enc.split_duration(np.asarray(fused))):
        assert_same(got, want, "split")


@pytest.mark.parametrize("codec", ["bit", "paper"])
@pytest.mark.parametrize("fused", [False, True])
def test_vocab_decode(codec, fused):
    pats, dates, phx, _ = j_synthea.generate_cohort(12, 10, seed=2)
    jv = j_enc.build_vocab(pats, phx)
    tv = t_enc.build_vocab(pats, phx)
    assert (tv.phenx_strings, tv.patient_keys) == (jv.phenx_strings, jv.patient_keys)
    ids = np.asarray(j_enc.pack(np.arange(jv.n_phenx), np.arange(jv.n_phenx)[::-1],
                                codec))
    if fused:
        ids = np.asarray(j_enc.fuse_duration(ids, np.arange(len(ids)) % 40))
    assert ([tv.decode_sequence(int(i), codec, fused) for i in ids]
            == [jv.decode_sequence(int(i), codec, fused) for i in ids])


def test_encode_rows():
    pats, dates, phx, _ = j_synthea.generate_cohort(20, 12, seed=3)
    got, want = t_enc.encode_rows(pats, dates, phx), j_enc.encode_rows(pats, dates, phx)
    for g, w in zip(got[:3], want[:3]):
        assert_same(g, w, "encode_rows")


@pytest.mark.parametrize("seed", [0, 7])
def test_synthea_generators_match(seed):
    got = t_synthea.generate_cohort(40, 20, seed=seed)
    want = j_synthea.generate_cohort(40, 20, seed=seed)
    assert got[:3] == want[:3]
    assert_same(got[3].covid_date, want[3].covid_date, "covid dates")
    assert got[3].symptom_sets == want[3].symptom_sets
    assert_same(got[3].long_covid, want[3].long_covid, "labels")
    for g, w in zip(t_synthea.generate_benchmark_rows(50, 30, seed),
                    j_synthea.generate_benchmark_rows(50, 30, seed)):
        assert_same(g, w, "benchmark rows")


def _assert_db_same(got, want):
    for name in ("phenx", "date", "nevents"):
        assert_same(getattr(got, name), getattr(want, name), name)
    if want.vocab is not None:
        assert got.vocab.phenx_strings == want.vocab.phenx_strings
        assert got.vocab.patient_keys == want.vocab.patient_keys


@pytest.mark.parametrize("seed", [5, 11])
def test_from_rows_and_first_occurrence_filter(seed):
    pats, dates, phx, _ = j_synthea.generate_cohort(30, 25, seed=seed)
    want = j_dbmart.from_rows(pats, dates, phx)
    got = t_dbmart.from_rows(pats, dates, phx)
    _assert_db_same(got, want)
    _assert_db_same(t_dbmart.first_occurrence_filter(got),
                    j_dbmart.first_occurrence_filter(want))


@pytest.mark.parametrize("case", range(6))
def test_first_occurrence_filter_random(case):
    """The vectorized filter equals the reference's per-event loop, empty
    rows, duplicate codes and unpadded widths included."""
    rng = np.random.default_rng(100 + case)
    db = random_dbmart(rng, n_codes=int(rng.integers(1, 6)))
    _assert_db_same(t_dbmart.first_occurrence_filter(port_db(db)),
                    j_dbmart.first_occurrence_filter(db))


def test_benchmark_cohort_filter():
    pid, date, xid, _ = j_synthea.generate_benchmark_rows(60, 80, seed=0)
    rows = (pid.tolist(), date.tolist(), [f"phx{v}" for v in xid.tolist()])
    want = j_dbmart.first_occurrence_filter(j_dbmart.from_rows(*rows))
    got = t_dbmart.first_occurrence_filter(t_dbmart.from_rows(*rows))
    _assert_db_same(got, want)


def test_from_arrays_keeps_vocab():
    pats, dates, phx, _ = j_synthea.generate_cohort(8, 10, seed=1)
    db = j_dbmart.from_rows(pats, dates, phx)
    _assert_db_same(port_db(db), db)
