"""Histogram kernel: the reference's Pallas kernel (interpret mode) vs the
port's wrapper on CPU tensors (its plain version).  The CUDA kernel is held
against that plain version in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from repro.core import mining as j_mining
from repro.core import sparsity as j_sparsity
from repro.kernels.seq_hist import ops as j_ops
from repro.kernels.seq_hist import seq_hist as j_hist
from repro_torch.core import sparsity as t_sparsity
from repro_torch.kernels import bucket_count as bc
from repro_torch.kernels.seq_hist import ops as t_ops
from repro_torch.kernels.seq_hist import ref as t_ref
from tests.conftest import random_dbmart
from tests.torch_parity import assert_same


@pytest.mark.parametrize("R,T,B", [(8, 128, 512), (4, 64, 512), (8, 512, 4096)])
def test_wrapper_matches_pallas_kernel(R, T, B):
    rng = np.random.default_rng(R * T)
    h = rng.integers(0, B, (R, T)).astype(np.int32)
    m = rng.random((R, T)) < 0.7
    before = t_ops.hist.launches
    got = t_ops.hist(torch.from_numpy(h), torch.from_numpy(m), B)
    want = j_hist.hist(h, m, B, bt=min(512, B), rows=4, interpret=True)
    assert_same(got, want, "hist")
    assert int(got.sum()) == int(m.sum())
    assert t_ops.hist.launches == before  # a CPU tensor never launches


@pytest.mark.parametrize("H", [9, 14, 18])
def test_bucket_counts_matches_reference(H):
    """The twin of the reference's ``ops.bucket_counts`` (its Pallas kernel
    up to 2^14 buckets in interpret mode, its scatter above), byte for
    byte, without a launch on CPU tensors."""
    db = random_dbmart(np.random.default_rng(H), n_patients=9, max_events=14)
    mined = j_mining.mine_triangular(db.phenx, db.date, db.nevents)
    seq, mask = np.array(mined.seq), np.array(mined.mask)
    before = t_ops.hist.launches
    got = t_ops.bucket_counts(torch.from_numpy(seq), torch.from_numpy(mask), H)
    assert_same(got, j_ops.bucket_counts(seq, mask, H), "bucket_counts")
    assert got.dtype == torch.int32 and t_ops.hist.launches == before


@pytest.mark.parametrize("H", [10, 12, 14])
def test_local_bucket_counts_matches_pallas_bucket_counts(H):
    db = random_dbmart(np.random.default_rng(3), n_patients=8, max_events=16)
    mined = j_mining.mine_triangular(db.phenx, db.date, db.nevents)
    seq, mask = np.array(mined.seq), np.array(mined.mask)
    want = j_ops.bucket_counts(seq, mask, H, interpret=True, force_kernel=True)
    assert_same(t_sparsity.local_bucket_counts(torch.from_numpy(seq),
                                               torch.from_numpy(mask), H),
                want, f"H={H}")


def test_dedupes_per_patient():
    """Same sequence twice for one patient counts once (paper semantics)."""
    seq = torch.tensor([[7, 7, 9], [7, 5, 5]], dtype=torch.int64)
    counts = t_sparsity.local_bucket_counts(seq, torch.ones((2, 3), dtype=torch.bool), 10)
    h7 = int(t_sparsity.hash_bucket(torch.tensor(7), 10))
    assert counts[h7] == 2 and counts.dtype == torch.int32


def test_plain_version_drops_out_of_range_ids():
    h = torch.tensor([-1, 0, 3, 4, 2**31 - 1, 3], dtype=torch.int32)
    m = torch.ones(6, dtype=torch.bool)
    assert t_ref.hist_ref(h, m, 4).tolist() == [1, 0, 0, 2]


@pytest.mark.parametrize("H", [1, 8, 14, 15])
def test_one_partition_and_no_scratch_up_to_2_15(H):
    for n in (1, 5000, 1 << 26):
        plan = t_ops.count_plan(n, 1 << H, 132)
        assert plan.partitions == 1 and plan.shared_table
        assert plan.scratch_bytes == 0 and plan.part_blocks == 1
        assert 1 <= plan.grid <= -(-n // t_ops.STEP)


@pytest.mark.parametrize("H,parts", [(16, 2), (20, 32), (24, 512), (27, 4096)])
def test_count_plan_above_2_15(H, parts):
    n = 67_094_016                      # a Table 1 fit block's ids
    plan = t_ops.count_plan(n, 1 << H, 132)
    assert plan.route == "partitioned"
    assert plan.partitions == parts == bc.n_partitions(1 << H)
    assert plan.grid == 132 * 3          # three 66 KB stages an SM
    assert plan.part_blocks == min(132 // min(parts, bc.GROUP_PARTS), n >> 22)
    group = min(parts, bc.GROUP_PARTS)
    assert plan.scratch_bytes == 2 * n + 4 * (group * plan.grid + 1)
    # a few ids, forced on the partitioned route: one block, the scratch
    # still sized for every element
    small = t_ops.count_plan(100, 1 << H, 132, force_route="partitioned")
    assert small.grid == 1 and small.scratch_bytes == 208 + 4 * (group + 1)
    assert small.part_blocks == 1 and small.route == "partitioned"


def test_partitions_of_a_ragged_table():
    assert bc.n_partitions((1 << 15) + 1) == 2
    assert bc.n_partitions(3 << 15) == 3
    assert bc.n_partitions(2**31 - 1) == 1 << 16
    assert bc.scratch_bytes(7, 3, 2) == 16 + 4 * 7


@pytest.mark.parametrize("n,H,want", [
    (1, 20, "global"), (4_194_304, 20, "global"), ((1 << 25) - 1, 20, "global"),
    (1 << 25, 20, "partitioned"), (67_094_016, 16, "partitioned"),
    (67_094_016, 15, "shared"), (10, 1, "shared")])
def test_route_by_size(n, H, want):
    """The partitioned route from GLOBAL_MAX_ELEMENTS elements up (its
    crossover with the global route), the shared table up to 2^15 buckets."""
    assert t_ops.route(n, 1 << H) == want
    plan = t_ops.count_plan(n, 1 << H, 132)
    assert plan.route == want and t_ops.ROUTES.index(want) >= 0
    if want == "global":
        assert plan.scratch_bytes == 0 and plan.part_blocks == 1
        assert plan.grid == min(-(-n // t_ops.GLOBAL_THREADS), 132 * t_ops.GLOBAL_BLOCKS_PER_SM)
