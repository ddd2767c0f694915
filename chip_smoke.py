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
     duration; H = 1..24 with SENTINEL ids present);
  4. drives the main path — ``MiningSession(...).fit(db)`` then
     ``frame.screen().collect()`` — on the paper's Table 1 cohort (4,985
     patients at ~471 events, first-occurrence filter) with
     ``screen='hash'`` and then ``screen='sorted'``, with the kernels'
     launch counts set to 0 just before each and read just after; it checks
     the row count against ``count_sequences``, the hash table's sum
     against the distinct (patient, id) pairs, and that the exact screen's
     kept set lies inside the hash screen's;
  5. holds the session on the card against the session on the CPU (plain
     versions) on the first 256 patients, byte for byte;
  6. times each kernel at the main path's full-size shapes with CUDA
     events, beside its bound, its plain version and a library call, times
     the histogram's shared-memory and global-atomics paths against each
     other on the same ids hashed to 2^12 buckets, and times the phases of
     the fit.

Every failed check raises, so the script exits non-zero.  The last three
lines of its output are the ``nvidia-smi`` line, the ``kernels`` JSON line
and the result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N_PATIENTS, AVG_EVENTS, SEED = 4985, 471, 0   # the paper's Table 1 cohort
THRESHOLD = 5
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


def run_main_path(torch, db, screen: str, device) -> dict:
    """Phase 4: one fit through the entry points, counts zeroed before and
    read after; returns the frame, its screened keep mask and times."""
    from repro_torch.api import MiningConfig, MiningSession
    from repro_torch.kernels.seq_hist import ops as hist_ops
    from repro_torch.kernels.tspm_pairgen import ops as pg_ops

    session = MiningSession(MiningConfig(threshold=THRESHOLD, screen=screen),
                            device=device)
    torch.cuda.reset_peak_memory_stats()
    pg_ops.pairgen.launches = hist_ops.hist.launches = 0
    t0 = time.perf_counter()
    frame = session.fit(db)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    seq, dur, patient, _ = frame.arrays()          # canonical order
    t2 = time.perf_counter()
    result = frame.screen().collect()
    t3 = time.perf_counter()
    launches = {"tspm_pairgen": pg_ops.pairgen.launches,
                "seq_hist": hist_ops.hist.launches}
    return dict(frame=frame, seq=seq, dur=dur, patient=patient, result=result,
                keep=frame.screen().keep_mask(), launches=launches,
                peak_device_bytes=peak, fit_s=t1 - t0, canonicalize_s=t2 - t1, screen_collect_s=t3 - t2)


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
    """Phase 5: the session on the card equals the session on the CPU."""
    from repro_torch.api import MiningConfig, MiningSession

    small = db.slice_patients(0, CHECK_PATIENTS)
    rows = 0
    for screen in ("hash", "sorted"):
        frames = [MiningSession(MiningConfig(threshold=THRESHOLD, screen=screen),
                                device=d).fit(small) for d in (device, "cpu")]
        for f in (lambda fr: fr.collect(), lambda fr: fr.screen().collect()):
            got, want = f(frames[0]), f(frames[1])
            for g, w in zip(got, want):
                require(g.dtype == w.dtype and g.tobytes() == w.tobytes(),
                        f"{screen}: card and CPU frames differ")
        rows = len(frames[0])
    print(f"phase 5: card == CPU on {CHECK_PATIENTS} patients ({rows} rows)", flush=True)
    return {"patients": CHECK_PATIENTS, "rows": rows}


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

    def row(name, replaces, ms, plain, bound, lib_ms, shape):
        by = max(bound, key=bound.get)
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{name}.cu", "replaces": replaces,
                "launches": launches[name], "max_abs_err": err[name],
                "ms": ms, "plain_ms": plain, "bound_ms": bound[by], "bound_by": by,
                "library_ms": lib_ms, "shape": shape}

    print(f"seq_hist paths at H=12: {json.dumps(paths)}", flush=True)
    return paths, [
        row("tspm_pairgen", "src/repro/kernels/tspm_pairgen/pairgen.py:29",
            pg_ms, pg_plain, pg_bound, None, f"P={P} E={E}"),
        row("seq_hist", "src/repro/kernels/seq_hist/seq_hist.py:25",
            hs_ms, hs_plain, hs_bound, hs_lib,
            f"N={n} H={H} counted={counted}"),
    ]


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
    card_vs_cpu = check_card_vs_cpu(torch, db, dev)
    hist_paths, kernels = time_kernels(torch, db, dev, err,
                                       main_path["hash"]["launches"])
    phases = time_fit_phases(torch, db, dev)
    phases.update(canonicalize_s=main_path["hash"]["canonicalize_s"],
                  fit_s=main_path["hash"]["fit_s"],
                  screen_collect_s=main_path["hash"]["screen_collect_s"])
    print(json.dumps({"fit_phases": phases, "main_path": main_path,
                      "card_vs_cpu": card_vs_cpu, "seq_hist_paths": hist_paths}),
          flush=True)
    print(f"nvidia-smi: {smi()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
