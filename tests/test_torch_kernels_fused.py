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
from repro.analysis import roofline as j_roofline
from repro.kernels.tspm_fused import ops as j_ops
from repro_torch.analysis import roofline
from repro_torch.core import encoding, mining, sparsity
from repro_torch.kernels import bucket_count as bc
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
    assert not plan.shared_table and not plan.compact_row
    assert plan.smem_bytes == bc.stage_bytes(roofline.THREADS // 32) + roofline.row_bytes(240)
    assert roofline.row_bytes(240) == 4 * 240 + 4 * 512
    assert roofline.row_bytes(240, compact=True) == 4 * 240
    assert plan.round_pairs == roofline.FUSED_SCRATCH_BYTES // 2
    assert plan.threads * plan.blocks_per_sm <= bc.MAX_THREADS_PER_SM
    small = roofline.mining_tile_plan(240, 15, device="cpu")
    assert small.shared_table
    assert small.smem_bytes == 4 * (1 << 15) + roofline.row_bytes(240)
    assert small.blocks_per_sm == 1
    assert roofline.mining_tile_plan(3, 8, device="cpu").block_patients >= 1


# the longest row the kernel before the partitioned design took: its codes
# and lookbacks, 8 B an event, beside a 4 * 2^H B shared table at H <= 15
PARENT_LONGEST = {12: 27_008, 15: 12_672, 16: 29_056, 20: 29_056, 24: 29_056}


@pytest.mark.parametrize("H", sorted(PARENT_LONGEST))
def test_row_layout_keeps_the_longest_rows(H):
    """Rows as long as the earlier kernel took still fit one block: a long
    row takes the compact layout (its lookbacks alone in shared memory,
    its codes read from global memory).  The plan refuses exactly past the
    compact layout's longest row; the main path's rows keep the full one."""
    table = 4 << H if H <= 15 else 0
    old = PARENT_LONGEST[H]
    assert 8 * old + table <= bc.SMEM_PER_BLOCK < 8 * (old + 8) + table
    beside = table or bc.stage_bytes(roofline.THREADS // 32)
    plan = roofline.mining_tile_plan(old, H, device="cpu")
    assert plan.compact_row and plan.smem_bytes <= bc.SMEM_PER_BLOCK
    assert plan.smem_bytes == 4 * old + beside
    last = (bc.SMEM_PER_BLOCK - beside) // 32 * 8
    assert last > old
    assert roofline.mining_tile_plan(last, H, device="cpu").smem_bytes <= bc.SMEM_PER_BLOCK
    assert roofline.mining_tile_plan(last + 1, H, device="cpu").smem_bytes > bc.SMEM_PER_BLOCK
    main = roofline.mining_tile_plan(320, H, device="cpu")
    assert not main.compact_row and main.smem_bytes == roofline.row_bytes(320) + beside
    # the full layout up to where its set no longer fits beside the table
    # or the stage
    for e in (8, 320, 2048, 8192):
        full = roofline.row_bytes(e) + beside <= bc.SMEM_PER_BLOCK
        assert roofline.mining_tile_plan(e, H, device="cpu").compact_row is not full


def pallas_fused_table(db, H, codec="bit"):
    """The reference's Pallas kernel itself in interpret mode, at any H
    (its wrapper sends H > 14 to the jnp path): 16-event tiles, 4,096-bucket
    tiles."""
    plan = j_roofline.mining_tile_plan(db.max_events, H)
    return np.asarray(j_ops._kernel_block(db.phenx, db.nevents, codec, H, plan,
                                          8, 16, 1 << min(H, 12), True))


@pytest.mark.parametrize("H", (14, 15, 16, 20))
def test_rounds_match_pallas_fused_table(H):
    """Forced small rounds (a cohort takes several) add up to the Pallas
    kernel's table, as do the plan's rounds (one)."""
    db = random_dbmart(np.random.default_rng(40 + H), n_patients=8, max_events=16)
    want = pallas_fused_table(db, H)
    pairs = ops.row_pairs(db.nevents, db.max_events)
    cap = int(pairs.max())
    assert len(ops.fused_rounds(db.nevents, db.max_events, cap)) >= 3
    assert_same(port_counts(db, n_buckets_log2=H, round_pairs=cap), want, "rounds")
    assert_same(port_counts(db, n_buckets_log2=H, round_pairs=1), want, "one each")
    assert_same(port_counts(db, n_buckets_log2=H), want, "plan")


@pytest.mark.parametrize("H", (14, 15, 16, 20))
def test_rounds_single_bucket_adversary_and_empty_cohort(H):
    """Every pair in one bucket (one code) and a cohort with no pairs, in
    rounds of a patient or two."""
    one = random_dbmart(np.random.default_rng(31), n_patients=6, max_events=12,
                        n_codes=1)
    want = pallas_fused_table(one, H)
    assert np.count_nonzero(want) == 1 and want.sum() == len(one.nevents[one.nevents > 1])
    assert_same(port_counts(one, n_buckets_log2=H, round_pairs=2), want, "one bucket")
    empty = DBMart(np.zeros((3, 8), np.int32), np.zeros((3, 8), np.int32),
                   np.array([0, 1, 0], np.int32))
    got = port_counts(empty, n_buckets_log2=H, round_pairs=1)
    assert_same(got, pallas_fused_table(empty, H), "no pairs")
    assert int(got.sum()) == 0


@pytest.mark.parametrize("cap", (1, 5, 45, 100, 10**9))
def test_rounds_cover_every_patient_once_in_order(cap):
    rng = np.random.default_rng(cap)
    nevents = rng.integers(0, 12, 40).astype(np.int32)
    nevents[[3, 17]] = 11                    # 55 pairs: over caps 1, 5, 45
    rounds = ops.fused_rounds(nevents, 10, cap)     # clipped to E = 10: 45
    assert [r[0] for r in rounds] == [0] + [r[1] for r in rounds[:-1]]
    assert rounds[-1][1] == len(nevents)
    pairs = ops.row_pairs(nevents, 10)
    assert pairs.max() == 45
    for a, b, k in rounds:
        assert b > a and k == int(pairs[a:b].sum())
        assert k <= cap or b - a == 1        # over the cap only alone
    if cap >= 45:
        assert all(k <= cap for _, _, k in rounds)
    assert ops.fused_rounds(np.zeros(0, np.int32), 10, cap) == []


def test_round_scratch_fits_every_round():
    nevents = np.array([300, 2, 0, 300, 5, 1, 299], np.int32)
    rounds = ops.fused_rounds(nevents, 304, 50_000)
    assert rounds == [(0, 3, 44_851), (3, 6, 44_860), (6, 7, 44_551)]
    for H, parts in ((20, 32), (24, 64), (28, 64)):
        want = -(-2 * 44_860 // 16) * 16 + 4 * (parts * 396 + 1)
        assert ops.round_scratch_bytes(rounds, H, 396) == want
    assert ops.round_scratch_bytes(rounds, 15, 396) == 0    # a shared table
    assert ops.round_scratch_bytes([], 20, 396) == 0
