"""The port's CUDA kernels and its session on the card, held against their
plain PyTorch versions on the CPU, byte for byte.

Every test here is marked ``cuda`` and skips where no CUDA device is
visible.  The module imports neither JAX nor the reference package, so it
runs on a machine with a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.api import MiningConfig, MiningSession
from repro_torch.core import encoding, mining, sparsity
from repro_torch.data import dbmart, synthea
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.seq_hist import ops as hist_ops
from repro_torch.models import model as model_lib
from repro_torch.serving import engine as serve_engine
from repro_torch.kernels.tspm_delta import ops as delta_ops
from repro_torch.kernels.seq_hist import ref as hist_ref
from repro_torch.kernels.tspm_fused import ops as fused_ops
from repro_torch.kernels.tspm_fused import ref as fused_ref
from repro_torch.kernels.tspm_pairgen import ops as pg_ops
from repro_torch.kernels.tspm_pairgen import ref as pg_ref
from repro_torch.stream import delta as stream_delta

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where none is visible."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _host(x) -> np.ndarray:
    """A numpy copy of ``x``; bfloat16 as its int16 bits (numpy has no
    bfloat16)."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    x = x.detach().cpu()
    return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()


def assert_same(got, want, what: str = "") -> None:
    """Byte equality, dtype and shape included (this module stands alone,
    so it runs where only PyTorch is installed)."""
    a, b = (_host(x) for x in (got, want))
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
    """Every route of the count: a private shared table (2^H buckets), and
    for 2^H + 2^15 buckets (the last partition ragged) the global route and
    partitions of 2^15 binned through scratch; ids out of range on both
    sides."""
    nb = (1 << H) if shared else (1 << H) + (1 << 15)
    assert hist_ops.count_plan(5000, nb, 132).shared_table == shared
    rng = np.random.default_rng(100 + H)
    h = torch.from_numpy(rng.integers(-3, nb + 3, 5000).astype(np.int32))
    mask = torch.from_numpy(rng.random(5000) < 0.7)
    want = hist_ref.hist_ref(h, mask, nb)
    got = hist_ops.hist(h.to(cuda_device), mask.to(cuda_device), nb)
    torch.cuda.synchronize()
    assert_same(got, want, "hist path")
    for route in (("shared",) if shared else ("global", "partitioned")):
        got = torch.zeros(nb, dtype=torch.int32, device=cuda_device)
        assert hist_ops._launch(h.to(cuda_device), mask.to(cuda_device), got, route) == route
        torch.cuda.synchronize()
        assert_same(got, want, route)


def _hist_edge_cases(h, first, nb):
    """chip_smoke.py phase 3's cases: as given, off 16-byte alignment, no
    counted id, every id in one bucket, ids out of range."""
    yield h, first
    yield h.reshape(-1)[3:], first.reshape(-1)[3:]
    yield h, torch.zeros_like(first)
    yield torch.full_like(h, nb - 1), first
    yield h * 3 - nb, first


@pytest.mark.parametrize("H", list(range(1, 25)))
def test_hist_kernel_edge_cases(cuda_device, H):
    rng = np.random.default_rng(200 + H)
    ids = rng.integers(-2**62, 2**62, (64, 1000), dtype=np.int64)
    ids[:, ::9] = ids[:, :1]
    ids[:, -50:] = encoding.SENTINEL
    mask = torch.from_numpy(rng.random(ids.shape) < 0.8)
    srt = torch.sort(torch.where(mask, torch.from_numpy(ids), encoding.SENTINEL),
                     dim=1).values
    h, first = sparsity.hash_bucket(srt, H), sparsity.row_first_flags(srt)
    routes = ("shared",) if H <= 15 else ("global", "partitioned")
    for hh, ff in _hist_edge_cases(h, first, 1 << H):
        want = hist_ref.hist_ref(hh, ff, 1 << H)
        for route in routes:
            got = torch.zeros(1 << H, dtype=torch.int32, device=cuda_device)
            hist_ops._launch(hh.to(cuda_device), ff.to(cuda_device), got, route)
            torch.cuda.synchronize()
            assert_same(got, want, f"H={H} {route}")


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
@pytest.mark.parametrize("H", list(range(1, 25)))
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


@pytest.mark.parametrize("H", [2, 15, 16, 20, 24])
def test_fused_kernel_in_rounds(cuda_device, H):
    """Rounds of about one patient (several launches, one table), the one-
    code adversary (every pair in one bucket) and a cohort with no pair."""
    for phenx, date, nevents in _fused_inputs():
        x, d, n = (torch.from_numpy(a) for a in (phenx, date, nevents))
        pairs = fused_ops.row_pairs(nevents, phenx.shape[1])
        cap = int(pairs.max())
        rounds = fused_ops.fused_rounds(nevents, phenx.shape[1], cap)
        assert len(rounds) > 1 or np.count_nonzero(pairs) < 2
        before = fused_ops.fused_bucket_counts.launches
        got = fused_ops.fused_bucket_counts(x.to(cuda_device), d.to(cuda_device),
                                            n.to(cuda_device), n_buckets_log2=H,
                                            round_pairs=cap)
        torch.cuda.synchronize()
        assert fused_ops.fused_bucket_counts.launches - before == len(rounds)
        assert_same(got, fused_ref.fused_table_ref(x, n, H), f"rounds {H}")
    none = torch.zeros((3, 8), dtype=torch.int32, device=cuda_device)
    got = fused_ops.fused_table(none, torch.tensor([0, 1, 0], dtype=torch.int32,
                                                   device=cuda_device), H, round_pairs=1)
    assert int(got.sum()) == 0 and got.shape == (1 << H,)


def _long_rows(E: int, m: int, n_distinct: int, codec: str, seed: int):
    """A [3, E] cohort of long rows and a short cohort that counts the same
    pairs: a row of n = E events whose codes cycle through m codes (its
    counted pairs are every (a, b) of them, as in the 2m-event row of the
    same codes), a row of n_distinct distinct codes and a row of one
    event."""
    rng = np.random.default_rng(seed)
    top = 1 << 24 if codec == "bit" else 10**7
    cycle = rng.choice(top, m, replace=False).astype(np.int32)
    distinct = rng.choice(top, n_distinct, replace=False).astype(np.int32)
    long_rows = np.zeros((3, E), np.int32)
    long_rows[0] = cycle[np.arange(E) % m]
    long_rows[1, :n_distinct] = distinct
    long_rows[2, 0] = cycle[0]
    W = max(2 * m, n_distinct)
    short = np.zeros((3, W), np.int32)
    short[0, :2 * m] = cycle[np.arange(2 * m) % m]
    short[1, :n_distinct] = distinct
    short[2, 0] = cycle[0]
    return (long_rows, np.array([E, n_distinct, 1], np.int32),
            short, np.array([2 * m, n_distinct, 1], np.int32))


# (H, E): the longest row the kernel before the partitioned design took at
# that H, a row on the full layout at its longest, and the longest row the
# compact layout takes (tests/test_torch_kernels_fused.py PARENT_LONGEST,
# test_row_layout_keeps_the_longest_rows)
@pytest.mark.parametrize("H,E,last", [(20, 29_056, False), (15, 12_672, False),
                                      (12, 27_008, False), (20, 8_000, False),
                                      (20, 41_152, True), (15, 25_344, True)])
def test_fused_kernel_takes_long_rows(cuda_device, H, E, last):
    """Rows as long as the earlier kernel took, and up to the compact
    layout's limit, against the plain version; one event more is refused."""
    from repro_torch.analysis import roofline

    for codec, seed in (("bit", E), ("paper", E + 1)):
        x, n, xs, ns = _long_rows(E, 97, 3000, codec, seed)
        got = fused_ops.fused_table(torch.from_numpy(x).to(cuda_device),
                                    torch.from_numpy(n).to(cuda_device), H, codec)
        want = fused_ref.fused_table_ref(torch.from_numpy(xs).to(cuda_device),
                                         torch.from_numpy(ns).to(cuda_device), H, codec)
        assert_same(got, want, f"E={E} H={H} {codec}")
        assert int(got.sum()) == 97 * 97 + 3000 * 2999 // 2
    assert roofline.mining_tile_plan(E, H, device=cuda_device).compact_row is (E > 8_000)
    if last:
        wide = torch.zeros((1, E + 8), dtype=torch.int32, device=cuda_device)
        with pytest.raises(ValueError, match="shared memory"):
            fused_ops.fused_table(wide, torch.ones(1, dtype=torch.int32,
                                                   device=cuda_device), H)


@pytest.mark.parametrize("engine", ["chunked", "fused"])
def test_fit_peak_within_budget_after_an_allocation(cuda_device, engine):
    """budget_bytes bounds the process's peak, counted from zero, when 64
    MiB were allocated before the fit (as cuBLAS's workspace would be)."""
    pats, dates, phx, _ = synthea.generate_cohort(n_patients=600, avg_events=300,
                                                  seed=7)
    db = dbmart.from_rows(pats, dates, phx)
    budget = 256 << 20
    kw = (dict(screen="fused") if engine == "fused"
          else dict(screen="hash", engine="chunked"))
    cfg = MiningConfig(threshold=3, budget_bytes=budget, n_buckets_log2=20, **kw)
    torch.cuda.empty_cache()
    held = torch.empty(64 << 20, dtype=torch.uint8, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    card = MiningSession(cfg, device=cuda_device).fit(db)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() <= budget
    del held
    cpu = MiningSession(cfg, device="cpu").fit(db)
    for g, w in zip(card.collect(), cpu.collect()):
        assert_same(g, w, engine)


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


def _delta_inputs():
    """(phenx, date, n_old, n_new, new_phenx, new_date): E and D on and
    around 128, empty delta windows, rows of no delta, a history at full
    plane capacity, and zero-width slabs."""
    rng = np.random.default_rng(13)
    for P, E, D in [(3, 16, 8), (2, 127, 129), (2, 128, 128), (3, 129, 127),
                    (4, 40, 40), (0, 8, 8), (3, 0, 4), (3, 8, 0)]:
        phenx = rng.integers(0, 9, (P, E)).astype(np.int32)
        date = np.sort(rng.integers(-40, 400, (P, E)), axis=1).astype(np.int32)
        n_old = rng.integers(0, E + 1, P).astype(np.int32)
        n_new = rng.integers(0, D + 1, P).astype(np.int32)
        if P >= 2:
            n_new[1] = 0                                    # no delta
        if P and E >= D:
            n_old[0], n_new[0] = E - D, D                   # full planes
        new_ph = rng.integers(0, 9, (P, D)).astype(np.int32)
        new_dt = np.sort(rng.integers(400, 900, (P, D)), axis=1).astype(np.int32)
        yield phenx, date, n_old, n_new, new_ph, new_dt


@pytest.mark.parametrize("codec", ["bit", "paper"])
@pytest.mark.parametrize("fuse", [False, True])
def test_delta_kernel_matches_plain_version(cuda_device, codec, fuse):
    for args in _delta_inputs():
        cpu = [torch.from_numpy(a) for a in args]
        before = delta_ops.delta_pairgen.launches
        got = delta_ops.delta_pairgen(*(a.to(cuda_device) for a in cpu),
                                      codec=codec, fuse_duration=fuse)
        torch.cuda.synchronize()
        want = stream_delta.delta_mine_torch(*cpu, codec, fuse, 30)
        for g, w, name in zip(got, want, ("seq", "dur", "mask")):
            assert_same(g, w, f"{args[0].shape} {name}")
        assert delta_ops.delta_pairgen.launches == before + (got.seq.numel() > 0)
    with pytest.raises(ValueError):
        stream_delta.delta_mine(*(a.to(cuda_device) for a in cpu), backend="torch")


@pytest.mark.parametrize("screen", ["hash", "fused"])
def test_stream_engine_on_card_matches_batch(cuda_device, screen):
    """The stream engine on the card: one tspm_delta launch a tick, the
    sketch table equal to the batch engine's, the frame equal to the
    batch frame and to the stream engine on the CPU."""
    pats, dates, phx, _ = synthea.generate_cohort(n_patients=40, avg_events=30,
                                                  seed=2)
    db = dbmart.from_rows(pats, dates, phx)
    cfg = MiningConfig(engine="stream", screen=screen, threshold=3,
                       budget_bytes=1 << 20)
    before = delta_ops.delta_pairgen.launches
    session = MiningSession(cfg, device=cuda_device)
    card = session.fit(db)
    batch = MiningSession(cfg.replace(engine="batch"), device=cuda_device).fit(db)
    cpu = MiningSession(cfg, device="cpu").fit(db)
    ticks = -(-int((np.asarray(db.nevents) > 0).sum()) // 16)
    assert delta_ops.delta_pairgen.launches - before == ticks
    assert_same(card._corpus.counts(), batch._corpus.counts(), "table")
    for other in (batch, cpu):
        for f in (lambda fr: fr.collect(), lambda fr: fr.screen().collect()):
            for g, w in zip(f(card), f(other)):
                assert_same(g, w, screen)


@pytest.mark.parametrize("engine", ["chunked", "files", "fused"])
def test_chunk_peak_within_budget_on_card(cuda_device, engine):
    """budget_bytes bounds the card's peak memory of a chunked fit."""
    pats, dates, phx, _ = synthea.generate_cohort(n_patients=400, avg_events=60,
                                                  seed=5)
    db = dbmart.from_rows(pats, dates, phx)
    budget = 16 << 20
    kw = (dict(screen="fused", engine="chunked") if engine == "fused"
          else dict(screen="hash", engine=engine))
    cfg = MiningConfig(threshold=3, budget_bytes=budget, n_buckets_log2=16, **kw)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    session = MiningSession(cfg, device=cuda_device)
    card = session.fit(db)
    torch.cuda.synchronize()
    assert session.plan().n_chunks > 1
    assert torch.cuda.max_memory_allocated() - base <= budget
    cpu = MiningSession(cfg, device="cpu").fit(db)
    for g, w in zip(card.collect(), cpu.collect()):
        assert_same(g, w, engine)


@pytest.mark.parametrize("screen", ["hash", "fused"])
@pytest.mark.parametrize("budget_mib", [64, 128, 512])
def test_chunk_peak_within_budget_at_long_histories(cuda_device, screen, budget_mib):
    """budget_bytes bounds the peak where a chunk's tensors pass 1 MiB (the
    caching allocator's rounding counts) and a piece holds many rows of
    ~300 events (the row sort's scratch, block after block); the rows
    equal a one-chunk fit's, in order."""
    pats, dates, phx, _ = synthea.generate_cohort(n_patients=600, avg_events=300,
                                                  seed=7)
    db = dbmart.from_rows(pats, dates, phx)
    budget = budget_mib << 20
    cfg = dict(threshold=3, engine="chunked", screen=screen, n_buckets_log2=20)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    session = MiningSession(MiningConfig(budget_bytes=budget, **cfg), device=cuda_device)
    card = session.fit(db)
    torch.cuda.synchronize()
    assert session.plan().n_chunks > 1
    assert torch.cuda.max_memory_allocated() - base <= budget
    whole = MiningSession(MiningConfig(budget_bytes=16 << 30, **cfg),
                          device=cuda_device).fit(db)
    for g, w in zip(card._corpus._raw, whole._corpus._raw):
        assert_same(g, w, screen)


# (atol, rtol): float32 2e-5 + 2e-5 |want|; bfloat16 2e-5 + 2^-6 |want|, two
# bfloat16 ulps, chip_smoke.py's limit (2e-2 would be near |want| itself
# at long S)
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-5, 2.0 ** -6)}


FLASH_CASES = [
    (1, 2, 2, 1, 1, 64, dict(causal=True)),
    (2, 4, 2, 129, 129, 64, dict(causal=True)),
    (1, 6, 2, 200, 200, 128, dict(causal=True, window=16, softcap=50.0)),
    (1, 3, 1, 96, 40, 32, dict(causal=False, window=16)),
    (1, 8, 1, 64, 160, 256, dict(causal=False)),
    (1, 2, 2, 100, 300, 16, dict(causal=True)),
    (1, 4, 4, 63, 1000, 128, dict(causal=False)),
    (2, 8, 4, 129, 129, 256, dict(causal=True)),
    (1, 8, 2, 1000, 1000, 256, dict(causal=True, window=300, softcap=50.0)),
    (1, 2, 1, 8192, 8192, 64, dict(causal=True, window=4096)),
    (1, 4, 2, 700, 700, 64, dict(causal=True, window=300, softcap=50.0)),
    (2, 8, 1, 200, 200, 64, dict(causal=True)),
    (1, 4, 2, 96, 40, 64, dict(causal=False, window=16)),
    (1, 4, 2, 63, 1000, 64, dict(causal=True)),
    # D 160 (zamba2-2.7b's shared attention): wgmma in bfloat16, ffma in float32
    (1, 4, 4, 129, 129, 160, dict(causal=True)),
    (1, 8, 2, 63, 1000, 160, dict(causal=False)),
    (1, 8, 1, 1000, 129, 160, dict(causal=True)),
    (1, 4, 2, 700, 700, 160, dict(causal=True, window=300, softcap=50.0)),
    (1, 4, 2, 96, 40, 160, dict(causal=False, window=16)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,kw", FLASH_CASES)
def test_flash_kernel_matches_plain_version(cuda_device, dtype, B, Hq, Hkv, Sq, Skv,
                                            D, kw):
    """Ragged tiles, GQA, window, softcap, Sq != Skv, rows with no visible
    key, through the route ``ops.route`` names (wgmma for bfloat16 at D >=
    64, tf32x3 for float32 at D = 64: window 4,096 at S = 8,192, softcap 50
    with a window, GQA group 8, rows that see no key, Sq != Skv); float32
    within 2e-5 + 2e-5 |want|, bfloat16 within 2e-5 + 2^-6 |want|."""
    g = torch.Generator(cuda_device).manual_seed(Sq * D)
    q = torch.randn(B, Hq, Sq, D, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(B, Hkv, Skv, D, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(B, Hkv, Skv, D, generator=g, device=cuda_device).to(dtype)
    route = flash_ops.route(dtype, D)
    before = flash_ops.attention.launches, flash_ops.attention.route_launches[route]
    got = flash_ops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (flash_ops.attention.launches, flash_ops.attention.route_launches[route]) \
        == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_ref.attention_ref(q, k, v, **kw)
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    if D == 160:    # the wgmma route's third, half-filled box on its own
        torch.testing.assert_close(got[..., 128:].float(), want[..., 128:].float(),
                                   atol=atol, rtol=rtol)
        assert want[..., 128:].float().abs().max() > 0.1


# the forward's log-sum-exp against the plain version's: the float32
# output's limit (chip_smoke.py's LSE_TOL)
LSE_TOL = 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,kw", FLASH_CASES)
def test_flash_lse_matches_plain_version(cuda_device, dtype, B, Hq, Hkv, Sq, Skv, D, kw):
    """Each route writes each row's log-sum-exp when given the pointer:
    within 2e-5 + 2e-5 |want| of ``attention_ref(..., return_lse=True)``,
    +inf where a row sees no key, and ``o`` byte-identical to the launch
    without it (the serving launch)."""
    g = torch.Generator(cuda_device).manual_seed(Sq * D + 1)
    q = torch.randn(B, Hq, Sq, D, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(B, Hkv, Skv, D, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(B, Hkv, Skv, D, generator=g, device=cuda_device).to(dtype)
    route = flash_ops.route(dtype, D)
    before = flash_ops.attention.route_launches[route]
    plain = flash_ops.attention(q, k, v, **kw)
    o, lse = flash_ops.attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert flash_ops.attention.route_launches[route] == before + 2
    assert_same(o, plain)
    _, want = flash_ref.attention_ref(q, k, v, return_lse=True, **kw)
    seen = torch.isfinite(want)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    assert (lse[~seen] == torch.inf).all()
    torch.testing.assert_close(lse[seen], want[seen], atol=LSE_TOL, rtol=LSE_TOL)


def test_flash_lse_takes_no_gradient(cuda_device):
    """``return_lse`` under autograd raises (the log-sum-exp is not
    differentiated; the gradient path asks for it itself)."""
    q = torch.randn(1, 2, 8, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(ValueError, match="return_lse takes no gradient"):
        flash_ops.attention(q, q, q, return_lse=True)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv", [(1, 3, 1, 10, 13), (2, 4, 2, 129, 200)])
def test_tf32x3_prepass_matches_plain_version(cuda_device, B, Hq, Hkv, Sq, Skv):
    """The tf32x3 pre-pass writes ``ref.tf32x3_operands`` byte for byte
    into the scratch the route is given (the main kernel only reads it): k
    as TF32 hi and lo planes, V transposed in ``value_key_order`` with
    zeros past Skv."""
    g = torch.Generator(cuda_device).manual_seed(Sq)
    q, k, v = (torch.randn(B, H, S, 64, generator=g, device=cuda_device)
               for H, S in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv)))
    scratch = torch.full((flash_ops.tf32x3_scratch_elems(k.shape),), float("nan"),
                         device=cuda_device)
    flash_ops._launch(q, k, v, torch.empty_like(q), causal=True, window=None, softcap=None,
                      scratch=scratch)
    want = torch.cat([t.reshape(-1) for t in flash_ref.tf32x3_operands(k, v)])
    assert_same(scratch, want)


def test_tf32x3_releases_its_scratch_and_never_takes_ffma(cuda_device):
    """A float32 call at D = 64 launches tf32x3 (never ffma), allocates the
    pre-pass's scratch for the call only, and leaves only its output."""
    g = torch.Generator(cuda_device).manual_seed(3)
    q, k, v = (torch.randn(2, H, 300, 64, generator=g, device=cuda_device) for H in (8, 2, 2))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launches = dict(flash_ops.attention.route_launches)
    got = flash_ops.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    after = flash_ops.attention.route_launches
    assert after["tf32x3"] == launches["tf32x3"] + 1 and after["ffma"] == launches["ffma"]
    scratch = 4 * flash_ops.tf32x3_scratch_elems(k.shape)
    assert torch.cuda.max_memory_allocated() - before >= scratch + got.numel() * 4
    assert torch.cuda.memory_allocated() - before == -(-got.numel() * 4 // 512) * 512


def test_flash_kernel_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros(1, 2, 8, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_ops.attention(x, x, x)
    h = torch.zeros(1, 2, 8, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        flash_ops.attention(h, h, h)
    e = torch.zeros(0, 2, 8, 64, device=cuda_device)
    before = flash_ops.attention.launches
    assert flash_ops.attention(e, e, e).shape == e.shape
    assert flash_ops.attention.launches == before


def _bwd_inputs(dev, B, Hq, Hkv, Sq, Skv, D, dtype, seed):
    g = torch.Generator(dev).manual_seed(seed)
    return [torch.randn(B, H, S, D, generator=g, device=dev).to(dtype)
            for H, S in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv), (Hq, Sq))]


def _assert_bwd_within_limit(got, q, k, v, o, do, kw):
    want64, _, _, limits = flash_ref.attention_bwd_limit(q, k, v, o, do, **kw)
    for name, g, w64, limit in zip(("dq", "dk", "dv"), got, want64, limits):
        diff = (g.double() - w64).abs()
        assert g.dtype == q.dtype and g.shape == w64.shape, name
        assert (diff <= limit).all(), f"{name}: max |diff| {diff.max().item()}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,kw", [
    (2, 4, 2, 1, 1, 64, dict(causal=True)),
    (2, 4, 2, 129, 129, 64, dict(causal=True)),
    (1, 4, 4, 100, 260, 16, dict(causal=True)),
    (1, 4, 4, 260, 100, 32, dict(causal=False)),
    (1, 6, 2, 200, 200, 128, dict(causal=True, window=16, softcap=50.0)),
    (1, 8, 1, 130, 130, 256, dict(causal=True, window=64, softcap=50.0)),
    (1, 4, 2, 96, 40, 64, dict(causal=False, window=16)),
    (1, 6, 2, 96, 96, 64, dict(causal=True, window=1)),
    (1, 4, 2, 63, 63, 128, dict(causal=True)),
    (1, 4, 2, 127, 127, 256, dict(causal=True)),
    (1, 4, 2, 128, 128, 64, dict(causal=True)),
    (1, 4, 2, 1000, 1000, 256, dict(causal=True)),
    (1, 4, 2, 63, 1000, 256, dict(causal=True)),
    (1, 4, 2, 1000, 129, 128, dict(causal=False)),
    (1, 8, 8, 200, 200, 256, dict(causal=True)),
    (1, 8, 2, 200, 200, 256, dict(causal=True)),
    (1, 8, 1, 200, 200, 64, dict(causal=True)),
    (1, 4, 2, 700, 700, 256, dict(causal=True, window=300, softcap=50.0)),
    (1, 4, 2, 96, 40, 256, dict(causal=False, window=16)),
])
def test_flash_bwd_kernel_matches_plain_version(cuda_device, dtype, B, Hq, Hkv, Sq, Skv,
                                                D, kw):
    """The backward kernel (one count, on the route ``ops.bwd_route``
    names: wgmma for bfloat16 at D 64/128/256, ffma else) against the plain
    version in float64, within ``ref.attention_bwd_limit`` (``BWD_ERR_FACTOR``
    times the float32 plain version's own error, plus the rounding to
    bfloat16), given the forward's log-sum-exp: ragged tiles, Sq != Skv
    causal and not, every head width, GQA groups 1 to 8, windows, softcap,
    rows that see no key."""
    q, k, v, do = _bwd_inputs(cuda_device, B, Hq, Hkv, Sq, Skv, D, dtype, Sq + D)
    o, lse = flash_ops.attention(q, k, v, return_lse=True, **kw)
    route = flash_ops.bwd_route(dtype, D)
    before = flash_ops.attention_bwd.launches, flash_ops.attention_bwd.route_launches[route]
    got = flash_ops.attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert (flash_ops.attention_bwd.launches,
            flash_ops.attention_bwd.route_launches[route]) == (before[0] + 1, before[1] + 1)
    _assert_bwd_within_limit(got, q, k, v, o, do, kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_repeats_bit_for_bit(cuda_device, dtype):
    """No atomics: two backward calls give the same bytes, on each route."""
    D = 64 if dtype == torch.float32 else 256
    q, k, v, do = _bwd_inputs(cuda_device, 2, 12, 4, 300, 300, D, dtype, 1)
    o, lse = flash_ops.attention(q, k, v, return_lse=True, causal=True)
    a = flash_ops.attention_bwd(q, k, v, o, do, lse, causal=True)
    b = flash_ops.attention_bwd(q, k, v, o, do, lse, causal=True)
    for x, y in zip(a, b):
        assert_same(x, y)


def test_flash_bwd_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros(1, 2, 8, 48, device=cuda_device)
    lse = torch.zeros(1, 2, 8, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_ops.attention_bwd(x, x, x, x, x, lse)
    y = torch.zeros(1, 2, 8, 64, device=cuda_device)
    with pytest.raises(ValueError, match="device and dtype"):
        flash_ops.attention_bwd(y, y, y, y.bfloat16(), y, lse)
    with pytest.raises(ValueError, match="lse must be float32"):
        flash_ops.attention_bwd(y, y, y, y, y, lse.bfloat16())
    e = torch.zeros(0, 2, 8, 64, device=cuda_device)
    before = flash_ops.attention_bwd.launches
    dq, dk, dv = flash_ops.attention_bwd(e, e, e, e, e, torch.zeros(0, 2, 8, device=cuda_device))
    assert dq.shape == e.shape and flash_ops.attention_bwd.launches == before
    info = flash_ops.bwd_kernel_info(torch.float32, 256)
    assert info["dkv"]["key_rows"] == 32 and info["dkv"]["shared_bytes"] <= 232448


def test_flash_forward_builds_spill_nothing(cuda_device):
    """Every tensor-core build of the forward (wgmma at each of its widths,
    D 160's three boxes among them; tf32x3) and the ffma build at float32 D
    160 keep their registers (no local bytes) and fit a block's shared
    memory; D 160 streams 64-key tiles."""
    builds = [(torch.bfloat16, D) for D in flash_ops.WGMMA_HEAD_DIMS]
    builds += [(torch.float32, 64), (torch.float32, 160)]
    for dtype, D in builds:
        info = flash_ops.kernel_info(dtype, D)
        assert info["local_bytes"] == 0, (dtype, D, info)
        assert 0 < info["shared_bytes"] <= 232448
    assert flash_ops.kernel_info(torch.bfloat16, 160)["key_rows"] == 64


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,kw", [
    (1, 4, 2, 129, 129, dict(causal=True)),
    (1, 4, 2, 63, 1000, dict(causal=True)),
    (1, 4, 2, 1000, 129, dict(causal=False)),
    (1, 8, 1, 200, 200, dict(causal=True)),
    (1, 4, 2, 300, 300, dict(causal=True, window=16, softcap=50.0)),
    (1, 4, 2, 96, 40, dict(causal=False, window=16)),
])
def test_flash_bwd_at_d160_matches_plain_version(cuda_device, dtype, B, Hq, Hkv, Sq, Skv,
                                                 kw):
    """The backward at D 160 (zamba2-2.7b's shared attention): wgmma in
    bfloat16 (three 64-column boxes), ffma in float32, through autograd
    (``_Attention``) as training calls it: one count on that route, dq,
    dk and dv within ``ref.attention_bwd_limit`` of the float64 plain
    version, the last 32 columns on their own too, and a second run
    byte-equal."""
    D = 160
    q, k, v, do = _bwd_inputs(cuda_device, B, Hq, Hkv, Sq, Skv, D, dtype, Sq + 7)
    route = flash_ops.bwd_route(dtype, D)
    assert route == ("wgmma" if dtype == torch.bfloat16 else "ffma")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = flash_ops.attention(*leaves, **kw)
    before = flash_ops.attention_bwd.route_launches[route]
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert flash_ops.attention_bwd.route_launches[route] == before + 1
    o, lse = flash_ops.attention(q, k, v, return_lse=True, **kw)
    _assert_bwd_within_limit(got, q, k, v, o, do, kw)
    want64, _, _, limits = flash_ref.attention_bwd_limit(q, k, v, o, do, **kw)
    for g, w64, limit in zip(got, want64, limits):
        tail = (g[..., 128:].double() - w64[..., 128:]).abs()
        assert (tail <= limit[..., 128:]).all() and w64[..., 128:].abs().max() > 0
    again = flash_ops.attention_bwd(q, k, v, o, do, lse, **kw)
    for x, y in zip(flash_ops.attention_bwd(q, k, v, o, do, lse, **kw), again):
        assert_same(x, y)


def test_flash_bwd_wgmma_builds_spill_nothing(cuda_device):
    """Every build of the wgmma backward keeps its registers (no local
    bytes) and fits a block's shared memory; its streamed tiles are 64 rows,
    32 at D 160 and 256.  The ffma build at float32 D 160 spills nothing
    either."""
    for D in flash_ops.BWD_WGMMA_HEAD_DIMS:
        info = flash_ops.bwd_kernel_info(torch.bfloat16, D)
        assert set(info) == {"prepass", "bwd_wgmma"}
        assert all(k["local_bytes"] == 0 for k in info.values()), (D, info)
        assert info["bwd_wgmma"]["shared_bytes"] <= 232448
        assert info["bwd_wgmma"]["key_rows"] == (32 if D > 128 else 64)
    info = flash_ops.bwd_kernel_info(torch.float32, 160)
    assert all(k["local_bytes"] == 0 for k in info.values()), info
    assert info["dkv"]["key_rows"] == 64 and info["dkv"]["shared_bytes"] <= 232448


def test_attention_gradient_on_card_goes_through_the_kernel(cuda_device, monkeypatch):
    """Under autograd a CUDA tensor's attention launches the backward
    kernel, never the plain version (which would raise here), and
    ``wq.grad`` of a reduced tspm-mlho's train-mode loss on the card is
    there and matches the CPU's (plain versions)."""
    from repro_torch.training import train_loop

    cfg = get_config("tspm-mlho", reduced=True)
    mdl = model_lib.build(cfg)
    card = train_loop.trainable(mdl.init(torch.Generator(cuda_device).manual_seed(0)))
    cpu = copy.deepcopy(card).to("cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(4, cfg.vocab_size, (2, 40)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1), "loss_mask": np.ones_like(toks, bool)}
    loss_fn = train_loop.make_loss_fn(mdl)
    grads = []
    for model, dev in ((card, cuda_device), (cpu, "cpu")):
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        before = flash_ops.attention_bwd.launches
        if dev != "cpu":
            with monkeypatch.context() as m:
                for name in ("attention_ref", "attention_bwd_ref", "attention_lse_ref"):
                    m.setattr(flash_ref, name, lambda *a, **k: pytest.fail("plain version ran"))
                loss, _ = loss_fn(model, tb)
                loss.backward()
            torch.cuda.synchronize()
        else:
            loss, _ = loss_fn(model, tb)
            loss.backward()
        launched = flash_ops.attention_bwd.launches - before
        assert launched == (cfg.n_layers if dev != "cpu" else 0)
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n, g in grads[0].items():
        assert g is not None, n
        torch.testing.assert_close(g.cpu(), grads[1][n], atol=1e-4, rtol=1e-3)
    assert grads[0]["blocks.0.attn.wq.weight"].abs().sum() > 0


def test_train_steps_on_card_match_cpu(cuda_device):
    """Three train steps of reduced tspm-mlho from one state, on the card
    and on the CPU: loss and ce per step within 1e-4 relative."""
    from repro_torch.training import optimizer as opt_lib, train_loop

    cfg = get_config("tspm-mlho", reduced=True)
    mdl = model_lib.build(cfg)
    state = train_loop.init_state(mdl, torch.Generator("cpu").manual_seed(0))
    params = copy.deepcopy(state.params).to(cuda_device)
    card = train_loop.TrainState(params, opt_lib.init(dict(params.named_parameters())))
    step = train_loop.make_train_step(mdl, opt_lib.OptConfig(peak_lr=1e-3, warmup_steps=0,
                                                             decay_steps=10))
    rng = np.random.default_rng(1)
    before = flash_ops.attention_bwd.launches
    for i in range(3):
        toks = rng.integers(4, cfg.vocab_size, (4, 64)).astype(np.int32)
        batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
                 "loss_mask": np.ones_like(toks, bool)}
        card, mc = step(card, batch)
        state, ms = step(state, batch)
        for k in ("loss", "ce", "grad_norm"):
            assert float(mc[k]) == pytest.approx(float(ms[k]), rel=1e-4), (i, k)
    assert flash_ops.attention_bwd.launches - before == 3 * cfg.n_layers
    assert int(card.opt.step) == 3 and card.opt.mu["embed.table"].device.type == "cuda"


def test_zamba2_train_step_takes_the_wgmma_backward_at_d160(cuda_device):
    """A train step of zamba2-2.7b's full widths cut to one group (6 Mamba2
    layers and one shared attention invocation of 32 heads x 160) in
    bfloat16 launches the backward once, on the wgmma route, and its loss
    and gradient norm are finite; the same step in float32 takes ffma and
    matches the CPU's loss and gradient norm within 1e-4 relative."""
    from repro_torch.training import optimizer as opt_lib, train_loop

    base = get_config("zamba2-2.7b").replace(n_layers=6, remat="none")
    rng = np.random.default_rng(2)
    toks = rng.integers(4, base.vocab_size, (1, 257)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": np.ones((1, 256), bool)}
    opt_cfg = opt_lib.OptConfig(peak_lr=1e-4, warmup_steps=0, decay_steps=10)
    for dtype, route in (("bfloat16", "wgmma"), ("float32", "ffma")):
        cfg = base.replace(dtype=dtype)
        mdl = model_lib.build(cfg)
        state = train_loop.init_state(mdl, torch.Generator(cuda_device).manual_seed(0))
        cpu = None
        if dtype == "float32":
            params = copy.deepcopy(state.params).to("cpu")
            cpu = train_loop.TrainState(params, opt_lib.init(dict(params.named_parameters())))
        before = dict(flash_ops.attention_bwd.route_launches)
        step = train_loop.make_train_step(mdl, opt_cfg)
        state, m = step(state, batch)
        torch.cuda.synchronize()
        after = flash_ops.attention_bwd.route_launches
        assert after[route] == before[route] + 1 and sum(after.values()) == sum(
            before.values()) + 1, (dtype, after)
        assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
        if cpu is not None:
            cpu, mc = step(cpu, batch)
            for k in ("loss", "ce", "grad_norm"):
                assert float(m[k]) == pytest.approx(float(mc[k]), rel=1e-4), k
        del state, cpu
        torch.cuda.empty_cache()


def test_reduced_encdec_on_card_matches_cpu(cuda_device):
    """Reduced seamless-m4t-large-v2 on the card (the flash kernel on the
    encoder's non-causal self-attention and the decoder's cross-attention,
    Sq != Skv) against the CPU on the same weights: train logits, and
    prefill + 6 decode steps, within 2e-4; the prefill launches three
    kernels a layer pair, a decode step none."""
    cfg = get_config("seamless-m4t-large-v2", reduced=True)
    mdl = model_lib.build(cfg)
    card = mdl.init(torch.Generator(cuda_device).manual_seed(0))
    cpu = copy.deepcopy(card).to("cpu")
    rng = np.random.default_rng(3)
    src = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    toks = rng.integers(4, cfg.vocab_size, (2, 30)).astype(np.int32)
    out = []
    for params, dev in ((card, cuda_device), (cpu, "cpu")):
        batch = {"src_embeds": torch.from_numpy(src).to(dev),
                 "tokens": torch.from_numpy(toks).to(dev)}
        with torch.no_grad():
            full, _ = mdl.apply(params, batch, mode="train")
        caches = mdl.init_caches(2, 30, src_len=40, device=dev)
        before = flash_ops.attention.launches
        got, caches = mdl.apply(params, dict(batch, tokens=batch["tokens"][:, :24]),
                                mode="prefill", caches=caches)
        prefill = flash_ops.attention.launches - before
        steps = [got[:, 0]]
        for t in range(24, 30):
            got, caches = mdl.apply(params, {"tokens": batch["tokens"][:, t:t + 1]},
                                    mode="decode", caches=caches)
            steps.append(got[:, 0])
        assert flash_ops.attention.launches - before == prefill
        assert prefill == (cfg.n_enc_layers + 2 * cfg.n_dec_layers if dev != "cpu" else 0)
        out.append((full.cpu(), torch.stack(steps, 1).cpu()))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("arch", ["tspm-mlho", "gemma2-2b", "deepseek-moe-16b",
                                  "llama4-maverick-400b-a17b", "pixtral-12b", "xlstm-125m",
                                  "zamba2-2.7b"])
def test_reduced_model_serves_on_card_as_on_cpu(cuda_device, arch):
    """Greedy serving of a reduced model: the card (flash kernel, one
    launch per attention layer per wave: none for xlstm-125m, one a shared
    invocation for zamba2-2.7b) gives the CPU's tokens."""
    cfg = get_config(arch, reduced=True)
    mdl = model_lib.build(cfg)
    card = mdl.init(torch.Generator(cuda_device).manual_seed(0))
    cpu = copy.deepcopy(card).to("cpu")
    rng = np.random.default_rng(0)
    results = []
    for params, dev in ((card, cuda_device), (cpu, "cpu")):
        eng = serve_engine.ServeEngine(mdl, params, batch_size=2, max_len=64,
                                       device=dev)
        for rid, n in enumerate((40, 33, 40)):
            eng.submit(serve_engine.Request(rid, rng.integers(4, cfg.vocab_size, n)
                                            .astype(np.int32), 12))
        before = flash_ops.attention.launches
        results.append(eng.run())
        launched = flash_ops.attention.launches - before
        per_wave = {"xlstm": 0, "hybrid": cfg.n_layers // max(cfg.shared_attn_every, 1)}
        assert launched == (per_wave.get(cfg.family, cfg.n_layers) * 2 if dev != "cpu" else 0)
        rng = np.random.default_rng(0)
    for rid in results[0]:
        np.testing.assert_array_equal(results[0][rid], results[1][rid])


# --- MoE and attention dispatch on the card ----------------------------------
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "llama4-maverick-400b-a17b"])
def test_moe_apply_on_card_matches_cpu(cuda_device, arch):
    """``moe.apply`` of a reduced MoE layer on the card against the CPU on
    the same weights and input (float32): the routing (``eid``, ``order``,
    ``keep``, ``slot``) byte-equal, ``y`` within 2e-4 and ``aux`` within
    1e-6 relative; in bfloat16 the card's ``y`` repeats bit for bit (no
    float atomics in the combine)."""
    from repro_torch.models import moe

    cfg = get_config(arch, reduced=True)
    mdl = model_lib.build(cfg)
    card = mdl.init(torch.Generator(cuda_device).manual_seed(0))
    i = [b.kind for b in card.blocks].index("moe")
    layer = card.blocks[i].ffn
    cpu_layer = copy.deepcopy(layer).to("cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 40, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        got_r = moe.route(layer, x.reshape(-1, cfg.d_model).to(cuda_device), cfg)
        want_r = moe.route(cpu_layer, x.reshape(-1, cfg.d_model), cfg)
        for name in ("eid", "order", "keep", "slot"):
            assert_same(getattr(got_r, name), getattr(want_r, name), name)
        y, aux = moe.apply(layer, x.to(cuda_device), cfg)
        want, want_aux = moe.apply(cpu_layer, x, cfg)
    torch.testing.assert_close(y.cpu(), want, atol=2e-4, rtol=2e-4)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
    bf = copy.deepcopy(layer).to(torch.bfloat16)
    bf.router.data = layer.router.data.clone()               # the router stays float32
    xb = x.to(cuda_device, torch.bfloat16)
    with torch.no_grad():
        a, _ = moe.apply(bf, xb, cfg.replace(dtype="bfloat16"))
        b, _ = moe.apply(bf, xb, cfg.replace(dtype="bfloat16"))
    assert a.dtype == torch.bfloat16
    assert_same(a, b, "bfloat16 y twice")


def test_tf32_stays_off_for_float32_matmuls(cuda_device):
    """Float32 router logits on the card must not run on TF32 (a flip of
    experts at margins of ~1e-3): the port sets no TF32 switch, so after
    building and serving a reduced MoE model both stay at PyTorch's
    defaults."""
    cfg = get_config("deepseek-moe-16b", reduced=True)
    mdl = model_lib.build(cfg)
    params = mdl.init(torch.Generator(cuda_device).manual_seed(0))
    caches = mdl.init_caches(2, 16, device=cuda_device)
    toks = torch.randint(4, cfg.vocab_size, (2, 8), device=cuda_device)
    mdl.apply(params, {"tokens": toks}, mode="prefill", caches=caches)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("Sq", [1, 2, 40])
def test_one_query_row_never_reaches_the_kernel_on_card(cuda_device, Sq):
    """Under ``'flash'`` a CUDA tensor with Sq = 1 takes ``blocked_sdpa``
    (no launch), as the reference's dispatch, and equals the CPU's; Sq > 1
    launches the kernel once."""
    from repro_torch.models import attention

    cfg = get_config("gemma2-2b", reduced=True).replace(attn_impl="flash")
    rng = np.random.default_rng(Sq)
    q = torch.from_numpy(rng.standard_normal((2, Sq, 4, 256)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 40, 2, 256)).astype(np.float32))
            for _ in range(2))
    before = flash_ops.attention.launches
    got = attention.full_attention(*(t.to(cuda_device) for t in (q, k, v)), cfg,
                                   causal=False, window=None)
    torch.cuda.synchronize()
    assert flash_ops.attention.launches - before == (Sq > 1)
    want = attention.full_attention(q, k, v, cfg, causal=False, window=None)
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=2e-5)


def test_flash_gqa_32_8_at_d128_takes_wgmma(cuda_device):
    """pixtral-12b's attention shape (GQA 32/8, D 128, bfloat16, causal)
    launches the wgmma route and equals the plain version within the
    bfloat16 limit."""
    gen = torch.Generator(cuda_device).manual_seed(0)
    q = torch.randn(1, 32, 300, 128, generator=gen, device=cuda_device).to(torch.bfloat16)
    k, v = (torch.randn(1, 8, 300, 128, generator=gen, device=cuda_device)
            .to(torch.bfloat16) for _ in range(2))
    assert flash_ops.route(q.dtype, 128) == "wgmma"
    before = flash_ops.attention.route_launches["wgmma"]
    got = flash_ops.attention(q, k, v, causal=True)
    assert flash_ops.attention.route_launches["wgmma"] - before == 1
    want = flash_ref.attention_ref(q, k, v, causal=True)
    atol, rtol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


# --- the sharded engine and checkpoints on the card -------------------------
def _cohort(seed: int, P: int = 12, E: int = 18):
    """A random numeric dbmart (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    nevents = rng.integers(0, E + 1, P).astype(np.int32)
    phenx = rng.integers(0, 25, (P, E)).astype(np.int32)
    date = np.sort(rng.integers(0, 400, (P, E)), axis=1).astype(np.int32)
    return dbmart.from_arrays(phenx, date, nevents)


def _shard_ops(db, seed: int, n_shards: int) -> list:
    """Submits of random chronological chunks with ticks, runs, migrations
    (of queued, resident and spilled patients) and rebalances between."""
    rng = np.random.default_rng(seed)
    ops, cursors = [], np.zeros(db.n_patients, np.int64)
    alive = [p for p in range(db.n_patients) if db.nevents[p] > 0]
    while alive:
        p = alive[int(rng.integers(len(alive)))]
        lo = int(cursors[p])
        hi = min(lo + int(rng.integers(1, 4)), int(db.nevents[p]))
        ops.append(("submit", p, lo, hi))
        cursors[p] = hi
        if hi == int(db.nevents[p]):
            alive.remove(p)
        r = rng.random()
        ops += [("tick",)] if r < 0.2 else [("run",)] if r < 0.35 else []
        if rng.random() < 0.25:
            ops.append(("migrate", p, int(rng.integers(n_shards))))
        if rng.random() < 0.1:
            ops.append(("rebalance",))
    ops.append(("run",))
    ops += [("migrate", p, (p + 1) % n_shards) for p in range(db.n_patients)
            if db.nevents[p] > 0 and p % 3 == 0]
    return ops


def _apply(session, db, ops) -> None:
    for op in ops:
        if op[0] == "submit":
            session.submit(op[1], db.date[op[1], op[2]:op[3]],
                           db.phenx[op[1], op[2]:op[3]])
        elif op[0] == "migrate":
            if op[1] in session.service.pids:
                session.service.migrate(op[1], op[2])
        elif op[0] == "rebalance":
            session.service.rebalance(imbalance_threshold=1.1)
        else:
            getattr(session.service, op[0])()


def _assert_same_sharded(a, b) -> None:
    sa, sb = a.service, b.service
    x, y = sa.snapshot(), sb.snapshot()
    for name in ("seq", "dur", "patient", "counts"):
        assert_same(getattr(x, name), getattr(y, name), name)
    assert sa.pids == sb.pids and sa.router.pinned == sb.router.pinned
    assert sa.migrations == sb.migrations and sa.n_ticks == sb.n_ticks
    for va, vb in zip(sa.shards, sb.shards):
        assert {k: va.store.tier_of(k) for k in vb.store.pids} == \
            {k: vb.store.tier_of(k) for k in vb.store.pids}


def _shard_config(tmp_path, tag: str, placement: str = "host") -> MiningConfig:
    return MiningConfig(n_shards=3, router="hash", placement=placement,
                        tick_patients=3, n_buckets_log2=10, screen="hash",
                        threshold=2, budget_bytes=20_000, disk_bytes=2_000,
                        disk_dir=str(tmp_path / tag), rebalance_every=3,
                        imbalance_threshold=1.1)


@pytest.mark.parametrize("placement", ["host", "devices"])
def test_sharded_replay_on_card_matches_cpu(cuda_device, tmp_path, placement):
    """3 shards evicting through the host and disk tiers, migrations of
    resident and spilled patients and rebalances: the card's replay equals
    the CPU's byte for byte (rows, merged table, pins, tiers), with one
    tspm_delta launch a shard tick."""
    db = _cohort(5)
    ops = _shard_ops(db, 6, 3)
    sessions = []
    for d in (cuda_device, "cpu"):
        s = MiningSession(_shard_config(tmp_path, str(d).replace(":", ""), placement),
                          device=d)
        before = delta_ops.delta_pairgen.launches
        _apply(s, db, ops)
        sessions.append((s, delta_ops.delta_pairgen.launches - before))
    (card, launches), (cpu, _) = sessions
    assert launches == len(card.service.stats) > 0
    assert card.service.migrations and all(
        sv.device == cuda_device for sv in card.service.shards)
    spilled = {sv.store.tier_of(k) for sv in card.service.shards
               for k in sv.store.pids}
    assert {"host", "disk"} <= spilled
    _assert_same_sharded(card, cpu)
    for g, w in zip(card.frame().screen().collect(), cpu.frame().screen().collect()):
        assert_same(g, w)


@pytest.mark.parametrize("writer,reader", [("cuda", "cpu"), ("cpu", "cuda")])
def test_checkpoint_restores_across_devices(cuda_device, tmp_path, writer, reader):
    """A session checkpointed on one device restores on the other (every
    tensor rebuilt there) and continues as an uninterrupted run does."""
    db = _cohort(8)
    ops = _shard_ops(db, 9, 3)
    cut = len(ops) // 2
    dev = {"cuda": cuda_device, "cpu": torch.device("cpu")}
    first = MiningSession(_shard_config(tmp_path, "w", "devices"), device=dev[writer])
    _apply(first, db, ops[:cut])
    path = first.checkpoint(str(tmp_path / "ck"), extra={"cut": cut})
    resumed = MiningSession.restore(path, device=dev[reader])
    assert resumed.restore_extra == {"cut": cut}
    assert all(sv.sketch.counts.device.type == reader and
               sv.store.phenx.device.type == reader for sv in resumed.service.shards)
    _apply(resumed, db, ops[cut:])
    whole = MiningSession(_shard_config(tmp_path, "u", "devices"), device=dev[reader])
    _apply(whole, db, ops)
    _assert_same_sharded(resumed, whole)


def test_merge_sharded_counts_on_card(cuda_device):
    from repro_torch.distributed.sharding import merge_sharded_counts
    from repro_torch.launch.mesh import make_data_mesh

    rng = np.random.default_rng(3)
    tables = [torch.from_numpy(rng.integers(0, 50, 1 << 10).astype(np.int32))
              for _ in range(4)]
    want = sum(t.to(torch.int64) for t in tables).to(torch.int32)
    for mesh in (None, make_data_mesh()):
        got = merge_sharded_counts([t.to(cuda_device) for t in tables], mesh)
        assert got.device == cuda_device and got.dtype == torch.int32
        assert_same(got, want)


def test_devices_placement_over_two_cards(tmp_path):
    """One shard a card on a host with two or more cards; equals 'host'."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (one shard a card)")
    db = _cohort(11)
    ops = _shard_ops(db, 12, 3)
    out = []
    for placement in ("devices", "host"):
        s = MiningSession(_shard_config(tmp_path, placement, placement), device="cuda")
        _apply(s, db, ops)
        out.append(s)
    assert len({sv.device for sv in out[0].service.shards}) >= 2
    _assert_same_sharded(*out)


# --- the tick journal and query serving on the card --------------------------
def _journal_config(tmp_path, tag: str, **kw) -> MiningConfig:
    return _shard_config(tmp_path, tag).replace(
        journal_dir=str(tmp_path / f"journal_{tag}"), journal_commit_every=2, **kw)


def _journaled_run(tmp_path, device, tag: str):
    """A journaled 3-shard replay on ``device``: eviction through the host
    and disk tiers, migrations of resident and spilled patients, an
    external admit and a checkpoint, then more ticks."""
    from repro_torch.stream.service import StreamService

    db = _cohort(5)
    ops = _shard_ops(db, 6, 3)
    donor = StreamService(tick_patients=2, n_buckets_log2=10, device=device)
    donor.submit(99, [1, 2, 9], [3, 4, 6])
    donor.run()
    s = MiningSession(_journal_config(tmp_path, tag), device=device)
    before = delta_ops.delta_pairgen.launches
    _apply(s, db, ops)
    s.service.admit_patient(donor.extract_patient(99), dst=1)
    s.checkpoint(str(tmp_path / f"ckpt_{tag}"))
    s.submit(99, [12], [5])
    s.submit(0, [500], [7])
    s.service.run()
    return s, delta_ops.delta_pairgen.launches - before


def test_journaled_replay_on_card_verifies_and_crosses_devices(cuda_device, tmp_path):
    """A journal written on the card verifies there (its replay launching
    tspm_delta once a shard tick) and replays on the CPU to the card's
    state; a journal written on the CPU replays on the card the same way."""
    from repro_torch.journal import read_journal
    from repro_torch.journal.entries import entry_kind

    card, launches = _journaled_run(tmp_path, cuda_device, "card")
    assert launches == len(card.service.stats) > 0
    spilled = {sv.store.tier_of(k) for sv in card.service.shards for k in sv.store.pids}
    assert {"host", "disk"} <= spilled and card.service.migrations
    kinds = [entry_kind(e) for e, _ in read_journal(card.config.journal_dir)]
    assert {"evict", "migrate", "checkpoint", "commit"} <= set(kinds)
    before = delta_ops.delta_pairgen.launches
    res = card.verify()
    assert res.ok, str(res)
    assert delta_ops.delta_pairgen.launches - before == len(card.service.stats)
    on_cpu = MiningSession.replay(card.config.journal_dir, device="cpu")
    assert on_cpu.device.type == "cpu"
    _assert_same_sharded(on_cpu, card)

    cpu, _ = _journaled_run(tmp_path, "cpu", "cpu")
    on_card = MiningSession.replay(cpu.config.journal_dir, device=cuda_device)
    assert all(sv.device == cuda_device for sv in on_card.service.shards)
    _assert_same_sharded(on_card, cpu)
    _assert_same_sharded(on_card, card)


def test_server_on_card_matches_cpu(cuda_device):
    """A server on a card stream session gives the CPU's keep masks and
    features() at every tick; its columns and predicate rows lie on the
    card."""
    from repro_torch.serving.tspm import plan

    db = _cohort(31, P=10, E=16)
    codes = np.unique(db.phenx[db.phenx >= 0])
    plans = [plan().screen(), plan().screen(1).starts_with(int(codes[0])),
             plan().min_duration(30).ends_with(int(codes[-1])),
             plan().screen().top_k(4), plan().starts_with(int(codes[1])).screen(2),
             plan().transitive_ends_with(int(codes[0])).screen()]
    ids = None
    pair = []
    for d in (cuda_device, "cpu"):
        s = MiningSession(MiningConfig(threshold=2, tick_patients=3, n_buckets_log2=10,
                                       screen="hash"), device=d)
        if ids is None:
            batch = MiningSession(MiningConfig(threshold=1, screen="hash",
                                               n_buckets_log2=10), device="cpu").fit(db)
            ids = np.unique(batch.arrays()[0])[::7].astype(np.int64)
        pair.append((s, s.serve(batch_size=4, feature_ids=ids)))
    for s, _ in pair:
        for p in range(db.n_patients):
            n = int(db.nevents[p])
            if n:
                s.submit(p, db.date[p, :n], db.phenx[p, :n])
    (card, srv), (cpu, cpu_srv) = pair
    while card.service.queue:
        card.service.tick()
        cpu.service.tick()
        got, want = srv.query_batch(plans), cpu_srv.query_batch(plans)
        for p, g, w in zip(plans, got, want):
            assert g.view.tick == w.view.tick
            assert_same(g.keep, w.keep, str(p))
        for a, b in zip(srv.features(), cpu_srv.features()):
            assert_same(a, b)
    view = srv.view()
    cols = view.columns()
    assert all(getattr(cols, f).device == cuda_device
               for f in ("start", "end", "dur", "screen", "valid"))
    assert view.pred_cache and all(r.device == cuda_device
                                   for r in view.pred_cache.values())


def test_dropping_the_server_frees_its_device_memory(cuda_device):
    """A static server's columns and predicate rows go with the server."""
    import gc

    from repro_torch.serving.tspm import plan

    db = _cohort(41, P=16, E=24)
    session = MiningSession(MiningConfig(threshold=2, screen="hash", n_buckets_log2=10),
                            device=cuda_device)
    session.fit(db)
    session.frame().keep_mask()
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    srv = session.serve(batch_size=8)
    with srv:
        res = [srv.submit(plan().screen(t).min_duration(d)).result(timeout=60)
               for t in (1, 2) for d in (0, 30)]
    assert torch.cuda.memory_allocated() > before
    assert all(r.keep.dtype == np.bool_ for r in res)
    del srv, res
    gc.collect()
    assert torch.cuda.memory_allocated() == before
