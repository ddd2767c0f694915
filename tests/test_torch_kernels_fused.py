"""Fused mine+screen counting: the port's plain versions (the CPU branch of
``fused_bucket_counts``, ``ref.block_bucket_counts`` and the kernel's own
algorithm ``ref.fused_table_ref``) against the reference's
``fused_bucket_counts`` (its jnp block path, and its Pallas kernel in
interpret mode), byte for byte.  Mirrors tests/test_kernels_fused.py; the
CUDA kernel is held against these plain versions in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from repro.core import mining as j_mining
from repro.core import sparsity as j_sparsity
from repro.data.dbmart import DBMart
from repro.kernels.tspm_fused import ops as j_ops
from repro_torch.analysis import roofline
from repro_torch.core import encoding, mining, sparsity
from repro_torch.kernels.tspm_fused import ops, ref
from tests.conftest import random_dbmart
from tests.torch_parity import assert_same


def jax_counts(db, codec="bit", fuse_duration=False, bucket_days=30,
               n_buckets_log2=12, backend="jnp", **kw):
    return np.asarray(j_ops.fused_bucket_counts(
        db.phenx, db.date, db.nevents, codec=codec,
        fuse_duration=fuse_duration, bucket_days=bucket_days,
        n_buckets_log2=n_buckets_log2, backend=backend, **kw))


def port_counts(db, codec="bit", fuse_duration=False, bucket_days=30,
                n_buckets_log2=12, **kw):
    before = ops.fused_bucket_counts.launches
    got = ops.fused_bucket_counts(
        torch.from_numpy(db.phenx), torch.from_numpy(db.date),
        torch.from_numpy(db.nevents), codec=codec, fuse_duration=fuse_duration,
        bucket_days=bucket_days, n_buckets_log2=n_buckets_log2, **kw)
    assert ops.fused_bucket_counts.launches == before   # CPU never launches
    return got


def all_port_tables(db, codec="bit", n_buckets_log2=12):
    """The wrapper's table, the contract's and the kernel algorithm's."""
    x, d, n = (torch.from_numpy(a) for a in (db.phenx, db.date, db.nevents))
    return {"ops": port_counts(db, codec, n_buckets_log2=n_buckets_log2),
            "block": ref.block_bucket_counts(x, d, n, codec,
                                             n_buckets_log2=n_buckets_log2),
            "table": ref.fused_table_ref(x, n, n_buckets_log2, codec)}


def assert_all_equal(db, codec="bit", n_buckets_log2=12):
    want = jax_counts(db, codec, n_buckets_log2=n_buckets_log2)
    for name, got in all_port_tables(db, codec, n_buckets_log2).items():
        assert_same(got, want, name)
    return want


@pytest.mark.parametrize("codec", ("bit", "paper"))
@pytest.mark.parametrize("P,E", [(1, 8), (3, 16), (8, 48), (16, 30), (7, 19)])
def test_conformance_random_cohorts(codec, P, E):
    db = random_dbmart(np.random.default_rng(P * 100 + E), n_patients=P,
                       max_events=E)
    assert_all_equal(db, codec)


@pytest.mark.parametrize("codec", ("bit", "paper"))
@pytest.mark.parametrize("P,E,H", [(3, 16, 10), (4, 12, 14)])
def test_plain_versions_match_pallas_kernel(codec, P, E, H):
    """The reference's Pallas kernel itself (interpret mode, H <= 14)."""
    db = random_dbmart(np.random.default_rng(E + H), n_patients=P,
                       max_events=E, n_codes=5)
    want = jax_counts(db, codec, n_buckets_log2=H, backend="kernel",
                      interpret=True)
    for name, got in all_port_tables(db, codec, H).items():
        assert_same(got, want, name)


def test_conformance_fused_duration_ids():
    db = random_dbmart(np.random.default_rng(11), n_patients=9, max_events=24,
                       date_range=900)
    want = jax_counts(db, fuse_duration=True, block_patients=4)
    assert_same(port_counts(db, fuse_duration=True, block_patients=4), want,
                "fused ids")
    assert_same(port_counts(db, fuse_duration=True), want, "plan block")


def test_block_partition_invariance():
    db = random_dbmart(np.random.default_rng(23), n_patients=13, max_events=20)
    want = jax_counts(db)
    for blk in (1, 3, 13, 64):
        assert_same(port_counts(db, block_patients=blk), want, f"block {blk}")
        x, d, n = (torch.from_numpy(a) for a in (db.phenx, db.date, db.nevents))
        assert_same(ref.fused_bucket_counts_ref(
            x, d, n, n_buckets_log2=12, block_patients=blk), want, f"ref {blk}")


def test_support_equals_threshold_edge():
    db = random_dbmart(np.random.default_rng(5), n_patients=10, max_events=16,
                       n_codes=4)
    H = 10
    want = assert_all_equal(db, n_buckets_log2=H)
    got = port_counts(db, n_buckets_log2=H)
    m = mining.mine_triangular(db.phenx, db.date, db.nevents)
    jm = j_mining.mine_triangular(db.phenx, db.date, db.nevents)
    thr = int(want.max())
    for t in (thr, thr + 1):
        keep = sparsity.screen_hash_from_counts(m.seq, m.mask, got, t, H)
        jkeep = j_sparsity.screen_hash_from_counts(jm.seq, jm.mask, want, t, H)
        assert_same(keep, jkeep, f"keep at {t}")
    assert not keep.any()


@pytest.mark.parametrize("P,E", [(0, 8), (4, 0)])
def test_zero_width_guard(P, E):
    z = np.zeros((P, E), np.int32)
    got = ops.fused_bucket_counts(z, z, np.zeros(P, np.int32), n_buckets_log2=8)
    want = j_ops.fused_bucket_counts(z, z, np.zeros(P, np.int32),
                                     n_buckets_log2=8, backend="jnp")
    assert_same(got, want, "zero width")
    assert_same(ref.fused_table_ref(z, np.zeros(P, np.int32), 8), want, "table")


def test_no_pairable_patients():
    db = DBMart(np.tile(np.arange(6, dtype=np.int32), (4, 1)),
                np.zeros((4, 6), np.int32), np.array([0, 1, 0, 1], np.int32))
    want = assert_all_equal(db, n_buckets_log2=8)
    assert want.sum() == 0


@pytest.mark.parametrize("E", (127, 128, 129))
def test_tile_boundary_event_counts(E):
    db = random_dbmart(np.random.default_rng(E), n_patients=2, max_events=E,
                       n_codes=6)
    assert int(db.nevents.max()) > 0
    assert_all_equal(db, n_buckets_log2=10)


def test_duplicate_timestamps_and_codes():
    db = DBMart(np.array([[2, 2, 2, 5, 5, 2, 7, 7],
                          [1, 1, 1, 1, 1, 1, 1, 1]], np.int32),
                np.array([[3, 3, 3, 3, 9, 9, 9, 9],
                          [0, 0, 0, 0, 0, 0, 0, 0]], np.int32),
                np.array([8, 8], np.int32), None)
    got = assert_all_equal(db, n_buckets_log2=10)
    h = int(sparsity.hash_bucket(encoding.pack(1, 1), 10))
    assert got[h] >= 1


@pytest.mark.parametrize("H", (1, 2))
def test_hash_adversary_single_bucket(H):
    db = random_dbmart(np.random.default_rng(31), n_patients=6, max_events=12,
                       n_codes=1)
    want = assert_all_equal(db, n_buckets_log2=H)
    assert want.sum() > 0


def test_ref_block_counts_is_the_contract():
    db = random_dbmart(np.random.default_rng(61), n_patients=3, max_events=10)
    m = mining.mine_dense(db.phenx, db.date, db.nevents)
    P = m.seq.shape[0]
    want = sparsity.local_bucket_counts(m.seq.reshape(P, -1),
                                        m.mask.reshape(P, -1), 10)
    got = ref.block_bucket_counts(db.phenx, db.date, db.nevents, n_buckets_log2=10)
    assert_same(got, want, "contract")


def test_lookback_is_last_earlier_occurrence():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, (5, 17)).astype(np.int32)
    want = np.full(x.shape, -1, np.int32)
    for p in range(x.shape[0]):
        for k in range(x.shape[1]):
            earlier = np.nonzero(x[p, :k] == x[p, k])[0]
            if len(earlier):
                want[p, k] = earlier[-1]
    assert_same(ref.lookback(torch.from_numpy(x)), want, "lookback")


def test_wrapper_refuses_what_it_cannot_serve():
    x = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.fused_bucket_counts(x, x, torch.ones(2, dtype=torch.int32),
                                n_buckets_log2=0)
    with pytest.raises(ValueError):
        ops.fused_bucket_counts(x, x, torch.ones(2, dtype=torch.int32),
                                codec="nope")
    meta = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.fused_bucket_counts(meta, meta, torch.ones(2, dtype=torch.int32,
                                                       device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_table(x, torch.ones(2, dtype=torch.int32), 8)


def test_tile_plan_is_fixed_on_the_cpu():
    plan = roofline.mining_tile_plan(240, 20, device="cpu")
    assert plan == roofline.mining_tile_plan(237, 20, device=torch.device("cpu"))
    assert plan.block_bytes == roofline.CPU_BLOCK_BYTES
    assert plan.block_patients == roofline.CPU_BLOCK_BYTES // (240 * 240 * 26)
    assert not plan.shared_table and plan.smem_bytes == 2 * 240 * 4
    assert plan.threads * plan.blocks_per_sm <= roofline.MAX_THREADS_PER_SM
    small = roofline.mining_tile_plan(240, 15, device="cpu")
    assert small.shared_table and small.smem_bytes == 4 * (1 << 15) + 2 * 240 * 4
    assert small.blocks_per_sm == 1
    assert roofline.mining_tile_plan(3, 8, device="cpu").block_patients >= 1
