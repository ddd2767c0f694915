"""Streaming mining launcher: replay a synthetic cohort as deltas.

  PYTHONPATH=src python -m repro_torch.launch.stream --patients 200 --waves 8
  PYTHONPATH=src python -m repro_torch.launch.stream --shards 4 --router hash \
      --rebalance-every 4 --device cpu

Generates a Synthea-style cohort, replays it wave-by-wave through the
unified session API (``repro_torch.api.MiningSession`` on ``--device``,
the card unless the caller passes ``cpu``; the planner picks the stream or
sharded engine from the config), and prints ingest throughput, sample
chainable-frame queries and a ``state_digest=`` line over the final
corpus/sketch/pid state — the same digest as the reference's launcher for
the same arguments, so a run, a checkpointed run stopped with
``--stop-after-wave`` and its ``--resume`` can be compared across
processes and packages.

``--journal-dir DIR`` journals every session event into a hash-chained
tick journal (``repro_torch.journal``) and verifies it on ``--device``
after the run; ``--replay-journal DIR`` skips ingest entirely and
reconstructs the session on ``--device`` from a journal of either package
instead.  Both modes print the ``state_digest=`` line, so a replay drill
can diff a journaled run against its replay across processes.
"""
from __future__ import annotations

import argparse
import hashlib
import time

import numpy as np

from repro_torch.api import MiningConfig, MiningSession
from repro_torch.data import dbmart, synthea
from repro_torch.stream.shard import ShardedStreamService, ShardRouter


def replay_waves(db, svc, n_waves: int, seed: int = 0, start_wave: int = 0):
    """Split each patient's history into ~n_waves chronological deltas and
    interleave them (wave-major), mimicking encounter-by-encounter arrival.
    ``svc`` is anything with ``submit`` (a service or a MiningSession).
    ``start_wave`` skips earlier waves without submitting them (the wave
    cuts are seed-deterministic, so a resumed replay continues the exact
    delta schedule a checkpointed run left off at)."""
    rng = np.random.default_rng(seed)
    cuts = []
    for p in range(db.n_patients):
        n = int(db.nevents[p])
        k = min(n_waves, max(n, 1))
        edges = np.sort(rng.choice(np.arange(1, n), size=k - 1, replace=False)) \
            if n > 1 and k > 1 else np.zeros(0, np.int64)
        cuts.append(np.concatenate([[0], edges, [n]]).astype(np.int64))
    for w in range(n_waves):
        if w < start_wave:
            continue
        for p in range(db.n_patients):
            c = cuts[p]
            if w + 1 < len(c) and c[w] < c[w + 1]:
                lo, hi = int(c[w]), int(c[w + 1])
                svc.submit(p, db.date[p, lo:hi], db.phenx[p, lo:hi])
        yield w


def state_digest(svc) -> str:
    """One hex digest over the final corpus, sketch table and pid table —
    the cross-process comparison key of a resume drill and of a journal
    replay drill."""
    snap = svc.snapshot()
    h = hashlib.sha256()
    for name in ("seq", "dur", "patient", "counts"):
        h.update(np.ascontiguousarray(
            np.asarray(getattr(snap, name))).tobytes())
    pids = svc.pids if hasattr(svc, "shards") else svc.store.pids
    h.update(repr(sorted((str(k), int(v))
                         for k, v in dict(pids).items())).encode())
    return h.hexdigest()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--patients", type=int, default=200)
    ap.add_argument("--avg-events", type=int, default=32)
    ap.add_argument("--waves", type=int, default=8)
    ap.add_argument("--tick-patients", type=int, default=16)
    ap.add_argument("--threshold", type=int, default=4)
    ap.add_argument("--buckets-log2", type=int, default=20)
    ap.add_argument("--backend", default="auto",
                    choices=["torch", "kernel", "auto"],
                    help="delta mining: 'kernel' (the tspm_delta kernel on "
                         "the card), 'torch' (the plain version, CPU only) "
                         "or 'auto' (by device)")
    ap.add_argument("--device", default="cuda",
                    help="where the session runs: 'cuda' (default) or 'cpu'")
    ap.add_argument("--budget-mb", type=int, default=0,
                    help="store byte budget in MiB (0 = unbounded)")
    ap.add_argument("--disk-bytes", type=int, default=0,
                    help="host-spill byte budget: evicted histories past "
                         "it demote into the compressed disk tier "
                         "(0 = host tier unbounded, no disk tier)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="checkpoint the session here after every wave "
                         "(atomic step_<wave> dirs; see --resume)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint in "
                         "--checkpoint-dir and continue the replay from "
                         "the next wave (config comes from the "
                         "checkpoint; continuation is byte-identical to "
                         "an uninterrupted run)")
    ap.add_argument("--stop-after-wave", type=int, default=None,
                    metavar="W", help="exit after checkpointing wave W "
                    "(simulates a killed service; pair with --resume)")
    ap.add_argument("--shards", type=int, default=1,
                    help="patient shards (over the device mesh under "
                         "'devices' placement)")
    ap.add_argument("--placement", default="auto",
                    choices=["auto", "host", "devices"],
                    help="shard state placement: 'devices' pins one shard "
                         "per device (two-pass ticks, async migration "
                         "admits), 'host' keeps shards serial on --device, "
                         "'auto' picks 'devices' when there is >= 1 device "
                         "per shard")
    ap.add_argument("--router", default="balance",
                    choices=["hash", "balance"],
                    help="patient->shard routing (balance pins by LPT "
                         "pair cost, hash needs no prior knowledge)")
    ap.add_argument("--rebalance-every", type=int, default=0,
                    help="migrate patients off hot shards every N ticks "
                         "(0 = sticky routing, no rebalancing)")
    ap.add_argument("--imbalance-threshold", type=float, default=1.5,
                    help="rebalance when the hottest shard's resident "
                         "pair cost exceeds this multiple of the mean")
    ap.add_argument("--min-gain", type=float, default=0.05,
                    help="migration hysteresis: skip moves that lower the "
                         "hot shard's load by less than this fraction of "
                         "the mean (prevents patient ping-pong)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="enable telemetry and dump the metrics snapshot "
                         "(flat name{labels} -> value JSON) on exit")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable telemetry and dump the span tree as a "
                         "Chrome trace (chrome://tracing / Perfetto) on exit")
    ap.add_argument("--busy-weighted-rebalance", action="store_true",
                    help="weight LPT rebalancing by the device-timed "
                         "shard_load() busy fractions")
    ap.add_argument("--journal-dir", default=None, metavar="DIR",
                    help="append a hash-chained tick journal of every "
                         "session event here and verify it after the run")
    ap.add_argument("--journal-commit-every", type=int, default=16,
                    metavar="N", help="merkle commitment cadence (ticks) "
                                      "for --journal-dir")
    ap.add_argument("--replay-journal", default=None, metavar="DIR",
                    help="skip ingest: reconstruct the session on --device "
                         "from this journal directory (cohort/engine flags "
                         "are ignored — the journal's open entry carries "
                         "the config) and print its state digest")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.replay_journal:
        t0 = time.perf_counter()
        session = MiningSession.replay(args.replay_journal, device=args.device)
        dt = time.perf_counter() - t0
        svc = session.service
        print(f"replayed {args.replay_journal} in {dt:.2f}s "
              f"({svc.n_ticks} ticks)")
        print(f"state_digest={state_digest(svc)}")
        return session
    if args.rebalance_every and args.shards <= 1:
        ap.error("--rebalance-every requires --shards > 1 "
                 "(rebalancing migrates patients between shards)")
    if args.busy_weighted_rebalance and not args.rebalance_every:
        ap.error("--busy-weighted-rebalance requires --rebalance-every")
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume requires --checkpoint-dir")
    telemetry = bool(args.metrics_json or args.trace_out)

    config = MiningConfig(
        threshold=args.threshold, screen="hash", backend=args.backend,
        n_buckets_log2=args.buckets_log2, tick_patients=args.tick_patients,
        budget_bytes=(args.budget_mb << 20) or None,
        disk_bytes=args.disk_bytes or None,
        n_shards=args.shards, router=args.router,
        placement=args.placement,
        rebalance_every=args.rebalance_every or None,
        imbalance_threshold=args.imbalance_threshold,
        min_gain=args.min_gain, telemetry=telemetry,
        busy_weighted_rebalance=args.busy_weighted_rebalance,
        journal_dir=args.journal_dir,
        journal_commit_every=args.journal_commit_every)

    pats, dates, phx, _ = synthea.generate_cohort(
        n_patients=args.patients, avg_events=args.avg_events, seed=args.seed)
    db = dbmart.from_rows(pats, dates, phx)
    mesh = None
    router = None
    if args.shards > 1:
        from repro_torch.launch.mesh import make_data_mesh

        mesh = make_data_mesh(device=args.device)
        if args.router == "balance":
            router = ShardRouter.balanced(list(range(db.n_patients)),
                                          db.nevents, args.shards)
    start_wave = 0
    if args.resume:
        session = MiningSession.restore(args.checkpoint_dir,
                                        device=args.device, mesh=mesh,
                                        vocab=db.vocab)
        start_wave = int(session.restore_extra.get("next_wave", 0))
        print(f"resumed from {args.checkpoint_dir} at wave {start_wave}")
    else:
        session = MiningSession(config, device=args.device, mesh=mesh,
                                router=router, vocab=db.vocab)
    print(session.plan())

    def _status():
        # cheap counters only: a snapshot() here would concat and merge
        # inside the timed loop and skew the reported ingest throughput
        svc = session.service
        if isinstance(svc, ShardedStreamService):
            corpus = sum(len(c[0]) for s in svc.shards for c in s._corpus)
            return (f"corpus={corpus:,} resident=" +
                    "/".join(str(len(s.store.rows)) for s in svc.shards))
        return (f"corpus={sum(len(c[0]) for c in svc._corpus):,} "
                f"resident={len(svc.store.rows)}")

    t0 = time.perf_counter()
    for w in replay_waves(db, session, args.waves, args.seed,
                          start_wave=start_wave):
        session.service.run()
        print(f"wave {w}: {_status()}")
        if args.checkpoint_dir:
            path = session.checkpoint(args.checkpoint_dir, step=w,
                                      extra={"next_wave": w + 1})
            print(f"checkpoint -> {path}")
        if args.stop_after_wave is not None and w >= args.stop_after_wave:
            print(f"stopping after wave {w} (resume with --resume)")
            break
    dt = time.perf_counter() - t0
    svc = session.service
    ev = sum(s.n_events for s in svc.stats)
    pairs = sum(s.n_pairs for s in svc.stats)
    print(f"ingested {ev:,} events / {pairs:,} pairs over "
          f"{len(svc.stats)} ticks in {dt:.2f}s ({ev/dt:,.0f} events/s)")
    if args.shards > 1:
        loads = svc.shard_loads()
        busy = svc.shard_load()
        print(f"migrations={len(svc.migrations)} shard_load_mb=" +
              "/".join(f"{b / (1 << 20):.1f}" for b in loads) +
              " shard_busy=" + "/".join(f"{f:.2f}" for f in busy))

    if args.journal_dir:
        res = session.verify()
        j = session.journal()
        print(f"journal {args.journal_dir}: {j.n_entries} entries, "
              f"{j.n_commits} commitments -> {res}")
        if not res.ok:
            raise SystemExit(f"journal verification failed: {res.proof}")

    if args.metrics_json:
        import json

        with open(args.metrics_json, "w") as fh:
            json.dump(session.metrics(), fh, indent=2, sort_keys=True)
        print(f"metrics snapshot -> {args.metrics_json}")
    if args.trace_out:
        session.trace().dump_chrome_trace(args.trace_out)
        print(f"chrome trace -> {args.trace_out}")

    frame = session.frame()
    covid = db.vocab.phenx_index[synthea.COVID]
    n = frame.starts_with(covid).screen().n_kept
    print(f"sequences starting with COVID-19 (support>={args.threshold}): "
          f"{n:,}")
    n = frame.min_duration(60).screen().n_kept
    print(f"sequences spanning >=60 days (screened): {n:,}")
    print(f"state_digest={state_digest(svc)}")
    return session


if __name__ == "__main__":
    main()
