"""The port's input pipeline (``data/pipeline.py``) against the reference.

Twin of tests/test_pipeline.py: ``balance_buckets`` and
``balance_patients`` must equal the reference's for the same event counts,
the remainder cases (P % n_shards != 0) included, and ``ChunkScheduler``
must plan the reference's chunks and complete every one of them.
"""
import threading

import numpy as np
import pytest

from repro.data import pipeline as j_pipeline
from repro_torch.data import pipeline
from tests.conftest import random_dbmart
from tests.torch_parity import assert_same, port_db


@pytest.mark.parametrize("P,S", [(10, 4), (13, 8), (257, 8), (5, 7), (250, 8),
                                 (12, 3), (1, 1), (0, 2)])
def test_balance_equals_reference(P, S):
    rng = np.random.default_rng(7 + P + S)
    for nevents in (rng.integers(1, 300, P), np.full(P, 20, np.int64)):
        got = pipeline.balance_buckets(nevents, S)
        assert got == j_pipeline.balance_buckets(nevents, S)
        assert max((len(b) for b in got), default=0) <= -(-P // S)
        if P:
            assert_same(pipeline.balance_patients(nevents, S),
                        j_pipeline.balance_patients(nevents, S), "perm")


def test_balance_remainder_not_piled_on_shard0():
    sizes = sorted(len(b) for b in pipeline.balance_buckets(
        np.full(10, 20, np.int64), 4))
    assert sizes == [2, 2, 3, 3]


@pytest.mark.parametrize("n_workers", [1, 3])
def test_chunk_scheduler_equals_reference(n_workers):
    rng = np.random.default_rng(11)
    jdb = random_dbmart(rng, n_patients=40, max_events=24)
    budget = 20_000
    port = pipeline.ChunkScheduler(port_db(jdb), budget)
    ref = j_pipeline.ChunkScheduler(jdb, budget)
    assert [(c.start, c.stop, c.max_events) for c in port.chunks] == \
        [(c.start, c.stop, c.max_events) for c in ref.chunks]
    assert len(port.chunks) > 1
    lock = threading.Lock()
    seen = []

    def worker(c):
        with lock:
            seen.append((c.start, c.stop))
        return c.n_patients

    out = port.run(worker, n_workers=n_workers)
    assert sorted(seen) == [(c.start, c.stop) for c in port.chunks]
    assert sum(out) == jdb.n_patients and len(port.completed) == len(port.chunks)
    assert port.steal() is None

