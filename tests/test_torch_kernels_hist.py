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
