"""The port's CUDA kernels and its session on the card, held against their
plain PyTorch versions on the CPU, byte for byte.

Every test here is marked ``cuda`` and skips where no CUDA device is
visible.  The module imports neither JAX nor the reference package, so it
runs on a machine with a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import MiningConfig, MiningSession
from repro_torch.core import encoding, mining, sparsity
from repro_torch.data import dbmart, synthea
from repro_torch.kernels.seq_hist import ops as hist_ops
from repro_torch.kernels.seq_hist import ref as hist_ref
from repro_torch.kernels.tspm_fused import ops as fused_ops
from repro_torch.kernels.tspm_fused import ref as fused_ref
from repro_torch.kernels.tspm_pairgen import ops as pg_ops
from repro_torch.kernels.tspm_pairgen import ref as pg_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where none is visible."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def assert_same(got, want, what: str = "") -> None:
    """Byte equality, dtype and shape included (this module stands alone,
    so it runs where only PyTorch is installed)."""
    a = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    b = want.cpu().numpy() if torch.is_tensor(want) else np.asarray(want)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _pairgen_inputs():
    """(phenx, date, nevents) at the edge shapes the kernel must mask."""
    rng = np.random.default_rng(0)
    for P, E in [(0, 8), (3, 0), (2, 1), (3, 127), (3, 128), (2, 129), (4, 300)]:
        phenx = rng.integers(0, 7, (P, E)).astype(np.int32)   # duplicate codes
        date = np.sort(rng.integers(-40, 60, (P, E)), axis=1).astype(np.int32)
        nevents = rng.integers(0, E + 1, P).astype(np.int32)
        if P >= 2 and E:
            nevents[:2] = [0, 1]
        yield phenx, date, nevents


@pytest.mark.parametrize("codec", ["bit", "paper"])
@pytest.mark.parametrize("fuse", [False, True])
def test_pairgen_kernel_matches_plain_version(cuda_device, codec, fuse):
    for phenx, date, nevents in _pairgen_inputs():
        args = [torch.from_numpy(a) for a in (phenx, date, nevents)]
        before = pg_ops.pairgen.launches
        got = pg_ops.pairgen(*(a.to(cuda_device) for a in args), codec=codec,
                             fuse_duration=fuse, bucket_days=30)
        torch.cuda.synchronize()
        want = pg_ref.pairgen_ref(*args, codec, fuse, 30)
        for g, w, name in zip(got, want, ("seq", "dur", "mask")):
            assert_same(g, w, f"{phenx.shape} {name}")
        assert pg_ops.pairgen.launches == before + (phenx.size > 0)


@pytest.mark.parametrize("H", [1, 12, 14, 15, 16, 20, 24])
def test_hist_kernel_matches_plain_version(cuda_device, H):
    rng = np.random.default_rng(H)
    ids = rng.integers(-2**62, 2**62, (16, 200), dtype=np.int64)
    ids[:, ::7] = ids[:, :1]                   # duplicates within a row
    ids[:, -5:] = encoding.SENTINEL
    seq = torch.from_numpy(ids)
    mask = torch.from_numpy(rng.random(ids.shape) < 0.8)
    h = sparsity.hash_bucket(seq, H)
    before = hist_ops.hist.launches
    got = hist_ops.hist(h.to(cuda_device), mask.to(cuda_device), 1 << H)
    torch.cuda.synchronize()
    assert hist_ops.hist.launches == before + 1
    assert_same(got, hist_ref.hist_ref(h, mask, 1 << H), "hist")
    assert_same(sparsity.local_bucket_counts(seq.to(cuda_device),
                                             mask.to(cuda_device), H),
                sparsity.local_bucket_counts(seq, mask, H), "counts")


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("H", [1, 12, 15])
def test_hist_paths_match_plain_version(cuda_device, H, shared):
    """Both the shared-memory and the global-atomics path, where the table
    fits either."""
    rng = np.random.default_rng(100 + H)
    h = torch.from_numpy(rng.integers(-3, (1 << H) + 3, 5000).astype(np.int32))
    mask = torch.from_numpy(rng.random(5000) < 0.7)
    got = torch.zeros(1 << H, dtype=torch.int32, device=cuda_device)
    hist_ops._launch(h.to(cuda_device), mask.to(cuda_device), got, shared)
    torch.cuda.synchronize()
    assert_same(got, hist_ref.hist_ref(h, mask, 1 << H), "hist path")


@pytest.mark.parametrize("screen", ["sorted", "hash"])
@pytest.mark.parametrize("codec", ["bit", "paper"])
@pytest.mark.parametrize("fuse", [False, True])
def test_session_on_card_matches_cpu(cuda_device, screen, codec, fuse):
    pats, dates, phx, _ = synthea.generate_cohort(n_patients=40, avg_events=30,
                                                  seed=2)
    db = dbmart.from_rows(pats, dates, phx)
    cfg = MiningConfig(threshold=3, screen=screen, codec=codec, fuse_duration=fuse)
    before = pg_ops.pairgen.launches, hist_ops.hist.launches
    card = MiningSession(cfg, device=cuda_device).fit(db)
    assert pg_ops.pairgen.launches == before[0] + 1
    assert hist_ops.hist.launches == before[1] + (screen == "hash")
    cpu = MiningSession(cfg, device="cpu").fit(db)
    assert len(card) == int(mining.count_sequences(db.nevents))
    for f in (lambda fr: fr.collect(), lambda fr: fr.screen().collect(),
              lambda fr: fr.screen().unique()):
        for g, w in zip(f(card), f(cpu)):
            assert_same(g, w, screen)
    assert card.screen().decode(limit=20) == cpu.screen().decode(limit=20)


def _fused_inputs():
    """(phenx, date, nevents): E on and around 128, duplicate codes, rows
    of 0 and 1 events, and a one-code cohort that collides everywhere."""
    rng = np.random.default_rng(7)
    for P, E, V in [(5, 127, 9), (5, 128, 9), (4, 129, 9), (6, 40, 1), (3, 8, 3)]:
        phenx = rng.integers(0, V, (P, E)).astype(np.int32)
        date = np.sort(rng.integers(0, 400, (P, E)), axis=1).astype(np.int32)
        nevents = rng.integers(2, E + 1, P).astype(np.int32)
        nevents[:2] = [0, 1]
        yield phenx, date, nevents


@pytest.mark.parametrize("codec", ["bit", "paper"])
@pytest.mark.parametrize("H", [1, 8, 12, 15, 16, 20, 24])
def test_fused_kernel_matches_plain_versions(cuda_device, codec, H):
    for phenx, date, nevents in _fused_inputs():
        x, d, n = (torch.from_numpy(a) for a in (phenx, date, nevents))
        before = fused_ops.fused_bucket_counts.launches
        got = fused_ops.fused_bucket_counts(x.to(cuda_device), d.to(cuda_device),
                                            n.to(cuda_device), codec=codec,
                                            n_buckets_log2=H)
        torch.cuda.synchronize()
        assert fused_ops.fused_bucket_counts.launches == before + 1
        assert_same(got, fused_ref.fused_table_ref(x, n, H, codec), f"table {H}")
        assert_same(got, fused_ref.block_bucket_counts(x, d, n, codec,
                                                       n_buckets_log2=H),
                    f"contract {H}")


def test_fused_duration_ids_take_the_blocked_kernels(cuda_device):
    phenx, date, nevents = next(_fused_inputs())
    args = [torch.from_numpy(a) for a in (phenx, date, nevents)]
    before = (fused_ops.fused_bucket_counts.launches, pg_ops.pairgen.launches)
    got = fused_ops.fused_bucket_counts(*(a.to(cuda_device) for a in args),
                                        fuse_duration=True, n_buckets_log2=12,
                                        block_patients=2)
    assert fused_ops.fused_bucket_counts.launches == before[0]
    assert pg_ops.pairgen.launches == before[1] + 3
    assert_same(got, fused_ref.fused_bucket_counts_ref(
        *args, fuse_duration=True, n_buckets_log2=12), "fused ids")
    with pytest.raises(ValueError):
        fused_ops.fused_bucket_counts(*(a.to(cuda_device) for a in args),
                                      backend="torch")


@pytest.mark.parametrize("screen", ["sorted", "hash", "fused"])
@pytest.mark.parametrize("engine", ["chunked", "files"])
def test_engines_on_card_match_cpu(cuda_device, engine, screen):
    pats, dates, phx, _ = synthea.generate_cohort(n_patients=40, avg_events=30,
                                                  seed=2)
    db = dbmart.from_rows(pats, dates, phx)
    cfg = MiningConfig(engine=engine, screen=screen, threshold=3,
                       budget_bytes=1 << 20)
    card = MiningSession(cfg, device=cuda_device).fit(db)
    cpu = MiningSession(cfg, device="cpu").fit(db)
    for f in (lambda fr: fr.collect(), lambda fr: fr.screen().collect()):
        for g, w in zip(f(card), f(cpu)):
            assert_same(g, w, f"{engine} {screen}")
