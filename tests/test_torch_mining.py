"""Port parity: core/mining and core/queries vs the reference."""
import numpy as np
import pytest
import torch

from repro.core import mining as j_mining
from repro.core import queries as j_queries
from repro_torch.api import MiningConfig
from repro_torch.api import planner as t_planner
from repro_torch.core import mining as t_mining
from repro_torch.core import queries as t_queries
from tests.conftest import random_dbmart
from tests.torch_parity import assert_same


def _db(seed, P=6, E=20, V=None):
    return random_dbmart(np.random.default_rng(seed), n_patients=P,
                         max_events=E, n_codes=V)


def _assert_mined(got, want, what):
    for g, w, name in zip(got, want, ("seq", "dur", "mask")):
        assert_same(g, w, f"{what} {name}")


@pytest.mark.parametrize("codec", ["bit", "paper"])
@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("layout", ["triangular", "dense"])
def test_mine_layouts(codec, fuse, layout):
    db = _db(3, V=9)
    args = (db.phenx, db.date, db.nevents, codec, fuse, 7)
    if layout == "triangular":
        _assert_mined(t_mining.mine_triangular(*args),
                      j_mining.mine_triangular(*args), layout)
    else:
        _assert_mined(t_mining.mine_dense(*args), j_mining.mine_dense(*args), layout)


@pytest.mark.parametrize("P,E", [(0, 8), (1, 1), (4, 2), (5, 33)])
def test_mine_edge_widths(P, E):
    phenx = np.arange(P * E, dtype=np.int32).reshape(P, E) % 5
    date = np.sort(np.arange(P * E, dtype=np.int32).reshape(P, E) % 13, axis=1)
    nevents = np.minimum(np.arange(P, dtype=np.int32), E)
    for fn in ("mine_triangular", "mine_dense"):
        _assert_mined(getattr(t_mining, fn)(phenx, date, nevents),
                      getattr(j_mining, fn)(phenx, date, nevents), fn)


def test_mine_dispatch_flatten_and_count():
    db = _db(4, P=7, E=24)
    t = t_mining.mine(torch.from_numpy(db.phenx), torch.from_numpy(db.date),
                      torch.from_numpy(db.nevents))          # auto -> torch on CPU
    j = j_mining.mine(db.phenx, db.date, db.nevents, backend="jnp")
    _assert_mined(t, j, "auto")
    for g, w in zip(t_mining.flatten(t, 3), j_mining.flatten(j, 3)):
        assert_same(g, w, "flatten")
    dense = t_mining.mine(db.phenx, db.date, db.nevents, backend="kernel")
    assert dense.seq.shape == (7,) + (db.max_events,) * 2
    assert_same(t_mining.count_sequences(db.nevents),
                j_mining.count_sequences(db.nevents), "count")
    assert int(dense.n_mined) == int(t.n_mined) == int(j_mining.count_sequences(db.nevents))
    for E in (0, 1, 2, 9):
        for g, w in zip(t_mining.pair_indices(E), j_mining.pair_indices(E)):
            assert_same(g, w, "pair_indices")


def test_backend_names():
    assert t_mining.resolve_backend("auto", "cpu") == "torch"
    assert t_mining.resolve_backend("auto", "cuda") == "kernel"
    with pytest.raises(ValueError):
        t_mining.resolve_backend("jnp", "cpu")


def test_plain_backend_refuses_cuda():
    """'torch' (the triangular plain version) never runs on the card: asked
    for a CUDA device, the backend and the planner raise."""
    assert t_mining.resolve_backend("torch", "cpu") == "torch"
    assert t_mining.resolve_backend("kernel", "cuda") == "kernel"
    with pytest.raises(ValueError, match="plain version"):
        t_mining.resolve_backend("torch", "cuda")
    with pytest.raises(ValueError, match="plain version"):
        t_planner.make_plan(MiningConfig(backend="torch"), [3, 5], device="cuda")


@pytest.mark.parametrize("codec", ["bit", "paper"])
@pytest.mark.parametrize("fused", [False, True])
def test_queries(codec, fused):
    db = _db(8, P=9, E=18, V=6)
    t = t_mining.mine_triangular(db.phenx, db.date, db.nevents, codec, fused)
    j = j_mining.mine_triangular(db.phenx, db.date, db.nevents, codec, fused)
    seq, mask, dur = np.asarray(j.seq), np.asarray(j.mask), np.asarray(j.dur)
    tseq, tmask = t.seq, t.mask
    for x in range(6):
        assert_same(t_queries.starts_with(tseq, x, codec, fused),
                    j_queries.starts_with(seq, x, codec, fused), "starts_with")
        assert_same(t_queries.ends_with(tseq, x, codec, fused),
                    j_queries.ends_with(seq, x, codec, fused), "ends_with")
        for max_set in (None, 3):
            assert_same(t_queries.end_set(tseq, tmask, x, codec, max_set, fused),
                        j_queries.end_set(seq, mask, x, codec, max_set, fused),
                        "end_set")
        assert_same(t_queries.transitive_ends_with(tseq, tmask, x, codec, None, fused),
                    j_queries.transitive_ends_with(seq, mask, x, codec, None, fused),
                    "transitive_ends_with")
    assert_same(t_queries.min_duration(t.dur, 40), j_queries.min_duration(dur, 40),
                "min_duration")


def test_per_patient_pair_stats():
    db = _db(12, P=8, E=20, V=4)
    j = j_mining.flatten(j_mining.mine_triangular(db.phenx, db.date, db.nevents))
    t = t_mining.flatten(t_mining.mine_triangular(db.phenx, db.date, db.nevents))
    got = t_queries.per_patient_pair_stats(*t, n_patients=8, n_pairs=16)
    want = j_queries.per_patient_pair_stats(*(np.asarray(a) for a in j),
                                            n_patients=8, n_pairs=16)
    for g, w, name in zip(got, want, ("pkey", "key", "seg", "cnt", "dmin",
                                      "dmax", "change")):
        assert_same(g, w, name)
