"""Serving launcher: LM generation or tSPM+ query serving, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tspm-mlho
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tspm-mlho --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --workload queries \\
      --patients 64 --clients 32 --queries 128

``--workload lm`` (default) runs batched generation over the LM wave
scheduler with random weights from ``--seed``; ``--workload queries``
mines a synthetic cohort through a live streaming session on ``--device``,
stands up ``session.serve()``, and drives concurrent clients through the
batched query path, printing wave/cache stats and the per-query latency
spread.
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch


def main_lm(args):
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Request, ServeEngine

    device = model_lib.resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    mdl = model_lib.build(cfg)
    params = mdl.init(torch.Generator(device).manual_seed(args.seed))
    print(f"serving {args.arch} on {device}: params="
          f"{model_lib.param_count(params):,} batch={args.batch}")

    eng = ServeEngine(mdl, params, batch_size=args.batch, max_len=args.max_len,
                      temperature=args.temperature, device=device)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        prompt = rng.integers(4, cfg.vocab_size, args.prompt_len) \
            .astype(np.int32)
        eng.submit(Request(i, prompt, max_new_tokens=args.max_new))

    t0 = time.time()
    results = eng.run(torch.Generator(device).manual_seed(args.seed))
    dt = time.time() - t0
    total = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests, {total} tokens "
          f"in {dt:.2f}s ({total/dt:.1f} tok/s)")
    for rid in sorted(results)[:4]:
        print(f"  req {rid}: {results[rid][:12].tolist()} ...")
    return results


def main_queries(args):
    from repro_torch.api import MiningConfig, MiningSession
    from repro_torch.data import dbmart, synthea
    from repro_torch.serving.tspm import plan

    pats, dates, phx, _ = synthea.generate_cohort(
        n_patients=args.patients, avg_events=16, seed=args.seed)
    db = dbmart.from_rows(pats, dates, phx)
    session = MiningSession(MiningConfig(threshold=args.threshold,
                                         tick_patients=8), device=args.device)
    server = session.serve(batch_size=args.batch)
    for p in range(db.n_patients):
        n = int(db.nevents[p])
        if n:
            session.submit(p, db.date[p, :n], db.phenx[p, :n])
    session.run()
    view = server.view()
    print(f"serving {view.n_rows:,} mined rows at tick {view.tick} on "
          f"{session.device} (batch={args.batch}, clients={args.clients})")

    rng = np.random.default_rng(args.seed)
    codes = np.unique(db.phenx[db.phenx >= 0]) if db.phenx.size else [0]
    plans = [plan().screen().starts_with(int(rng.choice(codes)))
             for _ in range(args.queries)]

    lats: list[float] = []
    lock = threading.Lock()
    server.start()

    def client(chunk):
        for p in chunk:
            t0 = time.perf_counter()
            server.submit(p).result(timeout=60)
            dt = time.perf_counter() - t0
            with lock:
                lats.append(dt)

    threads = [threading.Thread(
        target=client, args=(plans[i::args.clients],))
        for i in range(args.clients)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t0
    server.stop()

    lat = np.sort(np.asarray(lats))
    p50 = float(lat[int(0.50 * (len(lat) - 1))]) * 1e3
    p99 = float(lat[int(0.99 * (len(lat) - 1))]) * 1e3
    st = server.stats()
    print(f"served {st['queries']} queries in {wall:.2f}s "
          f"({st['queries']/wall:.0f} q/s) over {st['waves']} waves")
    print(f"  latency p50={p50:.2f}ms p99={p99:.2f}ms  "
          f"cache hit ratio={st['cache_hit_ratio']:.2f}")
    return st


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("lm", "queries"), default="lm")
    ap.add_argument("--arch", default="tspm-mlho")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    # queries workload
    ap.add_argument("--patients", type=int, default=64)
    ap.add_argument("--threshold", type=int, default=3)
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--queries", type=int, default=128)
    args = ap.parse_args(argv)
    if args.workload == "queries":
        if args.batch == 4:     # lm default is too small for query waves
            args.batch = 32
        return main_queries(args)
    return main_lm(args)


if __name__ == "__main__":
    main()
