"""Quickstart: mine transitive sequences through the unified session API,
on the PyTorch port.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The twin of ``examples/quickstart.py`` on ``repro_torch.api``; it prints
the same lines.  Alphanumeric dbmart -> ``MiningSession.fit`` on the
device (the planner picks the engine; print ``session.plan(db)`` to see
why, or force one with ``MiningConfig(engine=...)``) -> chainable screen /
top-k -> human-readable sequences; then the corpus-free screen, a stream
that checkpoints mid-way and resumes, and the query server over it.
"""
import argparse
import tempfile

from repro_torch.api import MiningConfig, MiningSession
from repro_torch.data import dbmart, synthea
from repro_torch.serving.tspm import plan


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device
    pats, dates, phx, _ = synthea.generate_cohort(
        n_patients=128, avg_events=32, seed=42)
    db = dbmart.from_rows(pats, dates, phx)
    print(f"dbmart: {db.n_patients} patients, {db.total_events} events, "
          f"{db.vocab.n_phenx} unique phenX")

    session = MiningSession(MiningConfig(threshold=5), device=dev)
    print(session.plan(db))
    frame = session.fit(db)
    print(f"mined {len(frame):,} transitive sequences")
    print(f"screened at support>=5: kept {frame.screen().n_kept:,}")

    print("\nmost supported transitive sequences:")
    for d in frame.top_k(8).decode():
        print(f"  {d.text:55s} support={d.support}")

    # --- corpus-free screening ---------------------------------------------
    # screen="fused" counts support in the [2^H] bucket table without ever
    # materializing the [P, n, n] pair corpus (the tspm_fused kernel on the
    # card), then materializes survivors only — byte-identical to the
    # materializing path above.
    fused = MiningSession(MiningConfig(threshold=5, screen="fused"),
                          device=dev).fit(db)
    print(f"\ncorpus-free screen kept {fused.screen().n_kept:,} "
          f"(same bytes, no corpus on the screen pass)")

    # --- streaming with checkpoint / resume --------------------------------
    # The same cohort arriving incrementally, with a byte budget tight
    # enough to spill and a disk budget demoting cold histories into the
    # compressed block tier; the session checkpoints mid-stream and a
    # fresh session restores it, continuing byte-identically.
    stream = MiningSession(MiningConfig(
        threshold=5, screen="hash", tick_patients=16,
        budget_bytes=1 << 20, disk_bytes=1 << 18), device=dev, vocab=db.vocab)
    for p in range(db.n_patients):
        n = int(db.nevents[p])
        stream.submit(p, db.date[p, :n], db.phenx[p, :n])
    stream.tick()                              # ingest one wave...
    with tempfile.TemporaryDirectory() as ckpt:
        stream.checkpoint(ckpt)                # ...snapshot it atomically
        resumed = MiningSession.restore(ckpt, device=dev, vocab=db.vocab)
    resumed.run()                              # drain the rest after "restart"
    print(f"\nresumed stream: kept {resumed.frame().screen().n_kept:,} "
          f"at support>=5 (continuation is byte-identical)")

    # --- query serving -----------------------------------------------------
    # The read path: session.serve() publishes a snapshot-isolated replica
    # at every tick boundary and answers plan chains in batched waves —
    # byte-identical to chaining the same ops on the frame, but one
    # predicate dispatch on the device per wave of distinct plans plus an
    # LRU keyed on canonical plans, so repeated/permuted queries are cache
    # hits.
    server = resumed.serve(batch_size=16)
    queries = [plan().screen().min_duration(30),
               plan().min_duration(30).screen(),    # same canonical plan
               plan().screen().top_k(8)]
    with server:                                    # background wave loop
        results = [server.submit(q).result(timeout=60) for q in queries]
    for q, r in zip(queries, results):
        print(f"  serve {str(q):40s} -> {r.n_kept:,} rows "
              f"@ tick {r.view.tick}")
    st = server.stats()
    print(f"served {st['queries']} queries in {st['waves']} wave(s), "
          f"cache hit ratio {st['cache_hit_ratio']:.2f}")


if __name__ == "__main__":
    main()
