"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with one visible CUDA device:

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/csrc`` with
``nvcc`` (into ``build/kernels/``), then:

  1. prints the device (``torch.cuda.get_device_name`` and ``nvidia-smi``'s
     name and power limit);
  2. builds the kernels and prints the build seconds;
  3. holds each kernel byte for byte against its plain PyTorch version on
     the card, at edge shapes (P = 0, E = 0/1/127/128/129, nevents 0/1,
     duplicate codes and dates, both codecs with and without the fused
     duration; H = 1..24 with SENTINEL ids present); ``tspm_fused`` against
     ``fused_table_ref`` and ``block_bucket_counts`` for both codecs at
     H = 1/8/12/15/16/20/24, including a one-code cohort whose ids collide
     everywhere;
  4. drives the main path — ``MiningSession(...).fit(db)`` then
     ``frame.screen().collect()`` — on the paper's Table 1 cohort (4,985
     patients at ~471 events, first-occurrence filter) with
     ``screen='hash'`` and then ``screen='sorted'``, with the kernels'
     launch counts set to 0 just before each and read just after; it checks
     the row count against ``count_sequences``, the hash table's sum
     against the distinct (patient, id) pairs, and that the exact screen's
     kept set lies inside the hash screen's;
     then runs the ``chunked`` and ``files`` engines on the same cohort at
     one ``budget_bytes`` and requires the same rows in the same order and
     the same bucket table (no host sort: both visit the same chunks);
  5. holds the session on the card against the session on the CPU (plain
     versions) on the first 256 patients, byte for byte, for every engine
     (batch, chunked, files) under every screen (sorted, hash, fused);
  6. times each kernel at the main path's full-size shapes with CUDA
     events, beside its bound, its plain version and a library call, times
     the histogram's shared-memory and global-atomics paths against each
     other on the same ids hashed to 2^12 buckets, and times the phases of
     the fit;
  7. drives the paper's Table 2 cohort (35,000 patients at ~318 events,
     E = 240) through ``MiningSession(engine='chunked', screen='hash')``
     and ``MiningSession(screen='fused')`` at the same ``budget_bytes``,
     and requires the fused table to equal the chunked engine's merged
     table, the fused survivors to equal the chunked rows that the table
     keeps, in the same order, and the corpus-free counting pass alone to
     peak under 1 GB of device memory; it times ``tspm_fused`` there.

Every failed check raises, so the script exits non-zero.  The last three
lines of its output are the ``nvidia-smi`` line, the ``kernels`` JSON line
and the result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N_PATIENTS, AVG_EVENTS, SEED = 4985, 471, 0   # the paper's Table 1 cohort
TABLE2_PATIENTS, TABLE2_EVENTS = 35000, 318   # the paper's Table 2 cohort
THRESHOLD = 5
H_DEFAULT = 20                 # MiningConfig.n_buckets_log2
BUDGET_BYTES = 4 << 30         # budget_bytes of the chunked/files/fused runs
CHECK_BUDGET_BYTES = 64 << 20  # ... of the card-vs-CPU runs (several chunks)
FUSED_PASS_LIMIT = 10**9       # the corpus-free counting pass's peak (1 GB)
CHECK_PATIENTS = 256
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
INT_OPS_PER_S = 67e12          # H100 SXM non-tensor 32-bit rate (data sheet fp32)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean milliseconds of ``fn`` on the device, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(torch, got, want) -> float:
    """0.0 when the tensors are byte-identical, else their largest
    difference (raises, since every kernel must match exactly)."""
    for g, w in zip(got, want):
        w = w.to(g.device)
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            diff = (g.double() - w.double()).abs().max().item() if g.numel() else 0.0
            raise RuntimeError(f"kernel differs from its plain version: "
                               f"{g.dtype}{tuple(g.shape)} vs "
                               f"{w.dtype}{tuple(w.shape)}, max |diff| {diff}")
    return 0.0


def pairgen_edge_cases():
    rng = np.random.default_rng(0)
    for P, E in [(0, 8), (3, 0), (2, 1), (4, 127), (4, 128), (3, 129), (2, 304)]:
        phenx = rng.integers(0, 7, (P, E)).astype(np.int32)          # duplicate codes
        date = np.sort(rng.integers(-40, 60, (P, E)), axis=1).astype(np.int32)  # ties
        nevents = rng.integers(0, E + 1, P).astype(np.int32)
        if P >= 2 and E:
            nevents[:2] = [0, 1]
        yield phenx, date, nevents
    big = rng.integers(0, 2**24 - 1, (2, 64)).astype(np.int32)       # full codec width
    yield big, np.sort(rng.integers(0, 40000, (2, 64)), axis=1).astype(np.int32), \
        np.array([64, 40], np.int32)


def random_cohort(rng, n_patients: int, max_events: int, n_codes: int,
                  date_range: int = 400):
    """(phenx, date, nevents) drawn as tests/conftest.py::random_dbmart
    draws them, so a seed gives the reference tests' cohort."""
    nevents = rng.integers(0, max_events + 1, n_patients).astype(np.int32)
    e_pad = -(-max(int(nevents.max(initial=1)), 1) // 8) * 8
    phenx = rng.integers(0, n_codes, (n_patients, e_pad)).astype(np.int32)
    date = np.sort(rng.integers(0, date_range, (n_patients, e_pad)).astype(np.int32),
                   axis=1)
    for p in range(n_patients):
        n = int(nevents[p])
        if n < e_pad:
            date[p, n:] = date[p, n - 1] if n else 0
    return phenx, date, nevents


def fused_edge_cases():
    """E on and around 128, duplicate codes, rows of 0 and 1 events, and
    the hash adversary of tests/test_kernels_fused.py (one code, H = 1/2)."""
    rng = np.random.default_rng(2)
    for P, E, V in [(5, 127, 9), (5, 128, 9), (4, 129, 9), (3, 8, 3), (64, 304, 40)]:
        phenx = rng.integers(0, V, (P, E)).astype(np.int32)
        date = np.sort(rng.integers(0, 400, (P, E)), axis=1).astype(np.int32)
        nevents = rng.integers(2, E + 1, P).astype(np.int32)
        nevents[:2] = [0, 1]
        yield phenx, date, nevents
    yield random_cohort(np.random.default_rng(31), 6, 12, 1)


def check_fused_kernel(torch, dev) -> tuple[float, int]:
    """Phase 3 for ``tspm_fused``: the kernel against the plain version of
    its own algorithm on the card and against the contract
    (``block_bucket_counts``, materializing) on the CPU; and the
    fused-duration route (pair generation + histogram per block)."""
    from repro_torch.core import encoding
    from repro_torch.kernels.tspm_fused import ops as fused_ops, ref as fused_ref

    err, n = 0.0, 0
    for phenx, date, nevents in fused_edge_cases():
        cpu = [torch.from_numpy(a) for a in (phenx, date, nevents)]
        x, d, nev = (a.to(dev) for a in cpu)
        for codec in encoding.CODECS:
            for H in (1, 2, 8, 12, 15, 16, 20, 24):
                got = fused_ops.fused_bucket_counts(x, d, nev, codec=codec,
                                                    n_buckets_log2=H)
                err = max(err, max_abs_err(torch, [got], [
                    fused_ref.fused_table_ref(x, nev, H, codec)]))
                err = max(err, max_abs_err(torch, [got], [
                    fused_ref.block_bucket_counts(*cpu, codec, n_buckets_log2=H)]))
                n += 2
            got = fused_ops.fused_bucket_counts(x, d, nev, codec=codec,
                                                fuse_duration=True,
                                                n_buckets_log2=12, block_patients=2)
            err = max(err, max_abs_err(torch, [got], [fused_ref.fused_bucket_counts_ref(
                *cpu, codec, True, 30, 12)]))
            n += 1
    empty = fused_ops.fused_bucket_counts(*(torch.zeros((0, 8), dtype=torch.int32,
                                                        device=dev),) * 2,
                                          torch.zeros(0, dtype=torch.int32, device=dev),
                                          n_buckets_log2=4)
    require(empty.shape == (16,) and int(empty.sum()) == 0, "empty fused table")
    return err, n


def check_kernels(torch, dev) -> dict:
    """Phase 3: every kernel against its plain version on the card."""
    from repro_torch.core import encoding, sparsity
    from repro_torch.kernels.seq_hist import ops as hist_ops, ref as hist_ref
    from repro_torch.kernels.tspm_pairgen import ops as pg_ops, ref as pg_ref

    err = {"tspm_pairgen": 0.0, "seq_hist": 0.0}
    n = 0
    for phenx, date, nevents in pairgen_edge_cases():
        cpu = [torch.from_numpy(a) for a in (phenx, date, nevents)]
        for codec in encoding.CODECS:
            for fuse in (False, True):
                got = pg_ops.pairgen(*(a.to(dev) for a in cpu), codec=codec,
                                     fuse_duration=fuse, bucket_days=30)
                want = pg_ref.pairgen_ref(*(a.to(dev) for a in cpu), codec, fuse, 30)
                err["tspm_pairgen"] = max(err["tspm_pairgen"],
                                          max_abs_err(torch, got, want))
                n += 1
    rng = np.random.default_rng(1)
    for H in (1, 12, 14, 15, 16, 20, 24):
        ids = rng.integers(-2**62, 2**62, (64, 1000), dtype=np.int64)
        ids[:, ::9] = ids[:, :1]                 # repeats inside each row
        ids[:, -50:] = encoding.SENTINEL
        mask = torch.from_numpy(rng.random(ids.shape) < 0.8).to(dev)
        seq = torch.from_numpy(ids).to(dev)
        srt = torch.sort(torch.where(mask, seq, encoding.SENTINEL), dim=1).values
        h, first = sparsity.hash_bucket(srt, H), sparsity.row_first_flags(srt)
        want = hist_ref.hist_ref(h, first, 1 << H)
        got = hist_ops.hist(h, first, 1 << H)
        err["seq_hist"] = max(err["seq_hist"], max_abs_err(torch, [got], [want]))
        paths = (False, True) if 1 << H <= hist_ops.MAX_SHARED_BUCKETS else (False,)
        for shared in paths:                      # each path alone, as timed
            got = torch.zeros_like(want)
            hist_ops._launch(h, first, got, shared)
            err["seq_hist"] = max(err["seq_hist"], max_abs_err(torch, [got], [want]))
            n += 1
        cpu_counts = sparsity.local_bucket_counts(seq.cpu(), mask.cpu(), H)
        err["seq_hist"] = max(err["seq_hist"], max_abs_err(
            torch, [sparsity.local_bucket_counts(seq, mask, H)], [cpu_counts]))
        n += 2
    empty = hist_ops.hist(torch.zeros(0, dtype=torch.int32, device=dev),
                          torch.zeros(0, dtype=torch.bool, device=dev), 16)
    require(empty.shape == (16,) and int(empty.sum()) == 0, "empty histogram")
    err["tspm_fused"], n_fused = check_fused_kernel(torch, dev)
    n += n_fused
    torch.cuda.synchronize()
    print(f"phase 3: {n} kernel comparisons byte-identical", flush=True)
    return err


def make_cohort(n_patients: int = N_PATIENTS, avg_events: int = AVG_EVENTS,
                seed: int = SEED):
    """The comparison protocol's cohort: benchmark rows, string-coded like
    the paper's dbmart, then the first-occurrence filter."""
    from repro_torch.data import dbmart, synthea

    pid, date, xid, _ = synthea.generate_benchmark_rows(n_patients, avg_events, seed)
    db = dbmart.from_rows(pid.tolist(), date.tolist(), [f"phx{v}" for v in xid.tolist()])
    return dbmart.first_occurrence_filter(db)


def distinct_pairs(seq: np.ndarray, patient: np.ndarray) -> int:
    """Distinct (id, patient) pairs of a canonical (id, patient)-sorted corpus."""
    if not len(seq):
        return 0
    return int(1 + np.count_nonzero((seq[1:] != seq[:-1]) | (patient[1:] != patient[:-1])))


def launch_counters() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels.seq_hist import ops as hist_ops
    from repro_torch.kernels.tspm_fused import ops as fused_ops
    from repro_torch.kernels.tspm_pairgen import ops as pg_ops

    return {"tspm_pairgen": pg_ops.pairgen, "seq_hist": hist_ops.hist,
            "tspm_fused": fused_ops.fused_bucket_counts}


def zero_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


def fit_engine(torch, db, device, **config) -> dict:
    """One ``MiningSession.fit`` with the launch counts zeroed just before
    and read just after, its host wall (ended by a synchronize) and the
    peak device memory of the fit."""
    from repro_torch.api import MiningConfig, MiningSession

    session = MiningSession(MiningConfig(**config), device=device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    frame = session.fit(db)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    return dict(frame=frame, plan=session.plan(), launches=read_launches(),
                fit_s=fit_s, peak_device_bytes=torch.cuda.max_memory_allocated())


def engine_rows(frame):
    """The frame's rows in the order the engine produced them, before the
    canonical host sort (which this must not trigger)."""
    raw = frame._corpus._raw
    require(raw is not None, "frame was canonicalized before its rows were read")
    return raw


def run_main_path(torch, db, screen: str, device) -> dict:
    """Phase 4: one fit through the entry points, counts zeroed before and
    read after; returns the frame, its screened keep mask and times."""
    r = fit_engine(torch, db, device, threshold=THRESHOLD, screen=screen)
    frame = r["frame"]
    t1 = time.perf_counter()
    seq, dur, patient, _ = frame.arrays()          # canonical order
    t2 = time.perf_counter()
    result = frame.screen().collect()
    t3 = time.perf_counter()
    return dict(frame=frame, seq=seq, dur=dur, patient=patient, result=result,
                keep=frame.screen().keep_mask(), launches=r["launches"],
                peak_device_bytes=r["peak_device_bytes"], fit_s=r["fit_s"],
                canonicalize_s=t2 - t1, screen_collect_s=t3 - t2)


def check_main_path(torch, db, device) -> dict:
    from repro_torch.core import mining

    n_seq = int(mining.count_sequences(db.nevents))
    out = {}
    runs = {}
    for screen in ("hash", "sorted"):
        r = run_main_path(torch, db, screen, device)
        runs[screen] = r
        require(r["launches"]["tspm_pairgen"] > 0, f"{screen}: pairgen never launched")
        if screen == "hash":
            require(r["launches"]["seq_hist"] > 0, "hash: seq_hist never launched")
        require(len(r["seq"]) == n_seq,
                f"{screen}: {len(r['seq'])} rows != count_sequences {n_seq}")
        sup = r["result"].support
        require(len(r["result"].seq) == len(sup) and (sup >= 1).all(),
                f"{screen}: support column")
        if screen == "sorted":
            require((sup >= THRESHOLD).all(), "sorted: kept support below threshold")
        out[screen] = {k: r[k] for k in ("launches", "peak_device_bytes", "fit_s",
                                         "canonicalize_s", "screen_collect_s")}
        out[screen]["kept_rows"] = int(len(r["result"].seq))
        print(f"phase 4 ({screen}): {json.dumps(out[screen])}", flush=True)
    h, s = runs["hash"], runs["sorted"]
    counts = h["frame"]._corpus.counts()
    pairs = distinct_pairs(h["seq"], h["patient"])
    require(int(counts.astype(np.int64).sum()) == pairs,
            f"hash table sums to {int(counts.sum())}, not the {pairs} distinct pairs")
    for name in ("seq", "dur", "patient"):
        require(np.array_equal(h[name], s[name]), f"canonical {name} differs by screen")
    require(not (s["keep"] & ~h["keep"]).any(), "exact kept set not inside hash kept set")
    out.update(rows=n_seq, distinct_pairs=pairs,
               patients=db.n_patients, max_events=db.max_events)
    return out


def check_card_vs_cpu(torch, db, device) -> dict:
    """Phase 5: the session on the card equals the session on the CPU, for
    every engine under every screen."""
    from repro_torch.api import MiningConfig, MiningSession

    small = db.slice_patients(0, CHECK_PATIENTS)
    rows = {}
    for engine in ("batch", "chunked", "files"):
        for screen in ("sorted", "hash", "fused"):
            cfg = MiningConfig(engine=engine, screen=screen, threshold=THRESHOLD,
                               budget_bytes=CHECK_BUDGET_BYTES)
            frames = [MiningSession(cfg, device=d).fit(small) for d in (device, "cpu")]
            for f in (lambda fr: fr.collect(), lambda fr: fr.screen().collect()):
                got, want = f(frames[0]), f(frames[1])
                for g, w in zip(got, want):
                    require(g.dtype == w.dtype and g.tobytes() == w.tobytes(),
                            f"{engine}/{screen}: card and CPU frames differ")
            rows[f"{engine}/{screen}"] = len(frames[0])
    print(f"phase 5: card == CPU on {CHECK_PATIENTS} patients, every engine and "
          f"screen ({json.dumps(rows)})", flush=True)
    return {"patients": CHECK_PATIENTS, "rows": rows}


def check_files_vs_chunked(torch, db, device) -> dict:
    """Phase 4b: the files and chunked engines at one budget visit the same
    chunks, so their rows agree in order, with the same bucket table; the
    spill goes to a temporary directory that the session removes."""
    import tempfile

    def spills():
        return {n for n in os.listdir(tempfile.gettempdir()) if n.startswith("tspm_spill_")}

    before = spills()
    runs, out = {}, {}
    for engine in ("chunked", "files"):
        r = fit_engine(torch, db, device, engine=engine, screen="hash",
                       threshold=THRESHOLD, budget_bytes=BUDGET_BYTES)
        require(r["launches"]["tspm_pairgen"] > 0 and r["launches"]["seq_hist"] > 0,
                f"{engine}: a kernel of the path never launched")
        runs[engine] = r
        out[engine] = {"fit_s": r["fit_s"], "launches": r["launches"],
                       "n_chunks": r["plan"].n_chunks, "rows": len(r["frame"]),
                       "peak_device_bytes": r["peak_device_bytes"]}
        print(f"phase 4b ({engine}): {json.dumps(out[engine])}", flush=True)
    require(spills() == before, "the files engine left its spill directory behind")
    c, f = runs["chunked"]["frame"], runs["files"]["frame"]
    require(runs["files"]["plan"].n_chunks > 1, "files: the budget gave one chunk")
    for name, a, b in zip(("seq", "dur", "patient"), engine_rows(c), engine_rows(f)):
        require(a.dtype == b.dtype and np.array_equal(a, b),
                f"files and chunked rows differ in {name}")
    require(np.array_equal(c._corpus.counts(), f._corpus.counts()),
            "files and chunked bucket tables differ")
    out["budget_bytes"] = BUDGET_BYTES
    return out


def host_keep(torch, seq: np.ndarray, counts: np.ndarray, device,
              piece: int = 1 << 26) -> np.ndarray:
    """The hash screen's keep mask of host rows, computed on the card a
    piece at a time."""
    from repro_torch.core import sparsity

    keep = np.empty(len(seq), bool)
    table = torch.from_numpy(counts).to(device)
    for s in range(0, len(seq), piece):
        ids = torch.from_numpy(seq[s:s + piece]).to(device)
        keep[s:s + piece] = sparsity.screen_hash_from_counts(
            ids, torch.ones_like(ids, dtype=torch.bool), table, THRESHOLD,
            H_DEFAULT).cpu().numpy()
    return keep


def check_table2(torch, db, device) -> dict:
    """Phase 7: the paper's Table 2 cohort through the chunked hash screen
    and the corpus-free fused screen, compared row for row."""
    from repro_torch.core import mining
    from repro_torch.kernels.tspm_fused import ops as fused_ops

    n_seq = int(mining.count_sequences(db.nevents))
    out = {"patients": db.n_patients, "max_events": db.max_events, "rows": n_seq,
           "budget_bytes": BUDGET_BYTES}
    ch = fit_engine(torch, db, device, engine="chunked", screen="hash",
                    threshold=THRESHOLD, budget_bytes=BUDGET_BYTES)
    require(ch["plan"].n_chunks >= 4, f"chunked: {ch['plan'].n_chunks} chunks, not >= 4")
    require(ch["launches"]["tspm_pairgen"] > 0 and ch["launches"]["seq_hist"] > 0,
            "chunked: a kernel of the path never launched")
    c_rows = engine_rows(ch["frame"])
    require(len(c_rows[0]) == n_seq, f"chunked: {len(c_rows[0])} rows != {n_seq}")
    c_counts = ch["frame"]._corpus.counts()
    keep = host_keep(torch, c_rows[0], c_counts, device)
    out["chunked"] = {"engine": ch["plan"].engine, "n_chunks": ch["plan"].n_chunks,
                      "fit_s": ch["fit_s"], "rows": n_seq, "kept_rows": int(keep.sum()),
                      "peak_device_bytes": ch["peak_device_bytes"],
                      "launches": ch["launches"]}
    print(f"phase 7 (chunked, hash): {json.dumps(out['chunked'])}", flush=True)

    fu = fit_engine(torch, db, device, screen="fused", threshold=THRESHOLD,
                    budget_bytes=BUDGET_BYTES)
    require(fu["launches"]["tspm_fused"] >= 1, "fused: tspm_fused never launched")
    require(fu["launches"]["tspm_pairgen"] > 0, "fused: the re-mine never launched")
    f_rows = engine_rows(fu["frame"])
    f_counts = fu["frame"]._corpus.counts()
    require(f_counts.dtype == c_counts.dtype and np.array_equal(f_counts, c_counts),
            "fused table != the chunked engine's merged table")
    require(len(f_rows[0]) == int(keep.sum()), "fused survivors != chunked kept rows")
    whole = bool(keep.all())
    for name, a, b in zip(("seq", "dur", "patient"), f_rows, c_rows):
        require(a.dtype == b.dtype and np.array_equal(a, b if whole else b[keep]),
                f"fused survivors differ from the chunked kept rows in {name}")
    out["fused"] = {"engine": fu["plan"].engine, "fit_s": fu["fit_s"],
                    "rows": len(f_rows[0]), "kept_rows": len(f_rows[0]),
                    "peak_device_bytes": fu["peak_device_bytes"],
                    "launches": fu["launches"]}
    out["table_sum"] = int(c_counts.astype(np.int64).sum())
    print(f"phase 7 (fused): {json.dumps(out['fused'])}", flush=True)
    launches = fu["launches"]
    del ch, fu, c_rows, f_rows, keep

    # the corpus-free counting pass alone: the cohort and the table
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    args = [torch.from_numpy(a).to(device) for a in (db.phenx, db.date, db.nevents)]
    counts = fused_ops.fused_bucket_counts(*args, n_buckets_log2=H_DEFAULT)
    torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    require(np.array_equal(counts.cpu().numpy(), c_counts),
            "the counting pass alone gives another table")
    require(peak < FUSED_PASS_LIMIT,
            f"fused counting pass peaked at {peak} B of device memory, not < 1 GB")
    out["fused_counting_pass"] = {"seconds": pass_s, "peak_device_bytes": peak,
                                  "limit_bytes": FUSED_PASS_LIMIT}
    print(f"phase 7 (fused counting pass alone): "
          f"{json.dumps(out['fused_counting_pass'])}", flush=True)
    del args, counts
    torch.cuda.empty_cache()
    return out, launches


def hist_bound(n: int, counted: int, n_buckets: int) -> dict:
    """Least time of the histogram on these inputs: every mask byte is read,
    h only where the mask is set, and the table is written once."""
    return {"bytes": (n + 4 * counted + 4 * n_buckets) / HBM_BYTES_PER_S * 1e3,
            "operations": counted / INT_OPS_PER_S * 1e3}


def time_hist_paths(torch, h, first, H: int) -> dict:
    """Phase 6a: the histogram's shared-memory and global-atomics paths on
    the main path's ids, hashed to a table small enough for both."""
    from repro_torch.kernels.seq_hist import ops as hist_ops

    nb = 1 << H
    out = {"H": H, "n": h.numel(), "counted": int(first.sum())}
    tables = {}
    for name, shared in (("shared_ms", True), ("global_ms", False)):
        table = torch.zeros(nb, dtype=torch.int32, device=h.device)
        out[name] = cuda_ms(torch, lambda: hist_ops._launch(h, first, table.zero_(),
                                                            shared), 10)
        tables[name] = table
    require(torch.equal(tables["shared_ms"], tables["global_ms"]),
            f"seq_hist paths disagree at H={H}")
    bound = hist_bound(out["n"], out["counted"], nb)
    out["bound_ms"] = max(bound.values())
    return out


def time_kernels(torch, db, dev, err: dict, launches: dict):
    """Phase 6a: each kernel at the main path's full-size shapes."""
    from repro_torch.core import encoding, sparsity
    from repro_torch.kernels.seq_hist import ops as hist_ops, ref as hist_ref
    from repro_torch.kernels.tspm_pairgen import ops as pg_ops, ref as pg_ref

    phenx, date, nevents = (torch.from_numpy(a).to(dev)
                            for a in (db.phenx, db.date, db.nevents))
    P, E = phenx.shape
    pairs = P * E * E
    got = pg_ops.pairgen(phenx, date, nevents)
    err["tspm_pairgen"] = max(err["tspm_pairgen"], max_abs_err(
        torch, got, pg_ref.pairgen_ref(phenx, date, nevents)))
    pg_ms = cuda_ms(torch, lambda: pg_ops.pairgen(phenx, date, nevents), 5)
    pg_plain = cuda_ms(torch, lambda: pg_ref.pairgen_ref(phenx, date, nevents), 3)
    pg_bytes = 2 * P * E * 4 + P * 4 + pairs * (8 + 4 + 1)
    pg_bound = {"bytes": pg_bytes / HBM_BYTES_PER_S * 1e3,
                "operations": pairs / INT_OPS_PER_S * 1e3}

    H = 20                                        # MiningConfig.n_buckets_log2
    flat = torch.where(got.mask, got.seq, encoding.SENTINEL).reshape(P, -1)
    del got
    srt = torch.sort(flat, dim=1).values
    del flat
    first = sparsity.row_first_flags(srt)
    paths = time_hist_paths(torch, sparsity.hash_bucket(srt, 12), first, 12)
    h = sparsity.hash_bucket(srt, H)
    del srt
    n, nb = h.numel(), 1 << H
    table = hist_ops.hist(h, first, nb)
    err["seq_hist"] = max(err["seq_hist"], max_abs_err(
        torch, [table], [hist_ref.hist_ref(h, first, nb)]))
    weights = first.reshape(-1).to(torch.float32)
    lib = torch.bincount(h.reshape(-1), weights=weights, minlength=nb)
    require(torch.equal(lib.to(torch.int32), table), "bincount yardstick disagrees")
    hs_ms = cuda_ms(torch, lambda: hist_ops.hist(h, first, nb), 10)
    hs_plain = cuda_ms(torch, lambda: hist_ref.hist_ref(h, first, nb), 3)
    hs_lib = cuda_ms(torch, lambda: torch.bincount(h.reshape(-1), weights=weights,
                                                    minlength=nb), 3)
    counted = int(first.sum())
    hs_bound = hist_bound(n, counted, nb)
    del h, first, weights, lib, table
    torch.cuda.empty_cache()

    print(f"seq_hist paths at H=12: {json.dumps(paths)}", flush=True)
    return paths, [
        kernel_row("tspm_pairgen", "src/repro/kernels/tspm_pairgen/pairgen.py:29",
                   launches, err, pg_ms, pg_plain, pg_bound, None, f"P={P} E={E}"),
        kernel_row("seq_hist", "src/repro/kernels/seq_hist/seq_hist.py:25",
                   launches, err, hs_ms, hs_plain, hs_bound, hs_lib,
                   f"N={n} H={H} counted={counted}"),
    ]


def kernel_row(name, replaces, launches, err, ms, plain, bound, lib_ms, shape):
    by = max(bound, key=bound.get)
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": launches[name], "max_abs_err": err[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bound[by], "bound_by": by,
            "library_ms": lib_ms, "shape": shape}


def time_fused(torch, db, dev, err: dict) -> dict:
    """``tspm_fused`` at a cohort's full size and H = 20, beside its bound
    and the plain version of its algorithm, with CUDA events.  The bound
    reads the cohort once and writes the table once (bytes), or does one
    64-bit multiply-shift and one add per counted pair (operations)."""
    from repro_torch.kernels.tspm_fused import ops as fused_ops, ref as fused_ref

    x, nev = (torch.from_numpy(a).to(dev) for a in (db.phenx, db.nevents))
    P, E = x.shape
    got = fused_ops.fused_table(x, nev, H_DEFAULT)
    err["tspm_fused"] = max(err["tspm_fused"], max_abs_err(
        torch, [got], [fused_ref.fused_table_ref(x, nev, H_DEFAULT)]))
    n = db.nevents.astype(np.int64)
    counted = int(np.sum(n * (n - 1) // 2))   # every code is distinct in a row
    require(int(got.sum()) == counted, "tspm_fused counted another number of pairs")
    ms = cuda_ms(torch, lambda: fused_ops.fused_table(x, nev, H_DEFAULT), 10)
    plain = cuda_ms(torch, lambda: fused_ref.fused_table_ref(x, nev, H_DEFAULT), 2)
    bound = {"bytes": (P * E * 4 + P * 4 + 4 * (1 << H_DEFAULT)) / HBM_BYTES_PER_S * 1e3,
             "operations": 2 * counted / INT_OPS_PER_S * 1e3}
    del x, nev, got
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain, "bound": bound,
            "shape": f"P={P} E={E} H={H_DEFAULT} counted={counted}"}


def time_fit_phases(torch, db, device) -> dict:
    """Phase 6b: the batch engine's phases, each ended by a synchronize."""
    from repro_torch.api import SequenceFrame
    from repro_torch.core import mining, sparsity

    t = {}
    t0 = time.perf_counter()
    args = [torch.from_numpy(a).to(device) for a in (db.phenx, db.date, db.nevents)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mined = mining.mine(*args)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = sparsity.local_bucket_counts(mined.seq, mined.mask, 20)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    frame = SequenceFrame(*mining.flatten(mined), counts=counts)
    t4 = time.perf_counter()
    t.update(host_to_device_s=t1 - t0, mine_s=t2 - t1, hash_counts_s=t3 - t2,
             compact_and_copy_to_host_s=t4 - t3, rows=len(frame))
    del mined, counts, frame
    torch.cuda.empty_cache()
    return t


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    name, card = torch.cuda.get_device_name(0), smi()
    print(f"device: {name} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    per_source = _build.build_all()
    print(f"phase 2: built {sorted(per_source)} in {time.perf_counter() - t0:.1f} s "
          f"({json.dumps(per_source)})", flush=True)

    dev = torch.device("cuda", 0)
    err = check_kernels(torch, dev)
    t0 = time.perf_counter()
    db = make_cohort()
    print(f"cohort: {db.n_patients} patients, E={db.max_events}, "
          f"{db.total_events} events, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    main_path = check_main_path(torch, db, dev)
    files_vs_chunked = check_files_vs_chunked(torch, db, dev)
    card_vs_cpu = check_card_vs_cpu(torch, db, dev)
    hist_paths, kernels = time_kernels(torch, db, dev, err,
                                       main_path["hash"]["launches"])
    fused_t1 = time_fused(torch, db, dev, err)
    phases = time_fit_phases(torch, db, dev)
    phases.update(canonicalize_s=main_path["hash"]["canonicalize_s"],
                  fit_s=main_path["hash"]["fit_s"],
                  screen_collect_s=main_path["hash"]["screen_collect_s"])
    del db

    t0 = time.perf_counter()
    db2 = make_cohort(TABLE2_PATIENTS, TABLE2_EVENTS)
    print(f"cohort: {db2.n_patients} patients, E={db2.max_events}, "
          f"{db2.total_events} events, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    table2, fused_launches = check_table2(torch, db2, dev)
    fused_t2 = time_fused(torch, db2, dev, err)
    kernels.append(kernel_row(
        "tspm_fused", "src/repro/kernels/tspm_fused/fused.py:134", fused_launches,
        err, fused_t2["ms"], fused_t2["plain_ms"], fused_t2["bound"], None,
        fused_t2["shape"]))
    kernels[-1]["table1"] = {"ms": fused_t1["ms"], "plain_ms": fused_t1["plain_ms"],
                             "bound_ms": max(fused_t1["bound"].values()),
                             "shape": fused_t1["shape"]}
    print(json.dumps({"fit_phases": phases, "main_path": main_path,
                      "files_vs_chunked": files_vs_chunked, "card_vs_cpu": card_vs_cpu,
                      "seq_hist_paths": hist_paths, "table2": table2,
                      "wall_s": time.perf_counter() - t_start}), flush=True)
    print(f"nvidia-smi: {smi()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
