"""Serving launcher: LM generation on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tspm-mlho
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tspm-mlho --reduced --device cpu

``--workload lm`` (default) runs batched generation over the LM wave
scheduler with random weights from ``--seed``.  ``--workload queries``
(tSPM+ query serving, ``serving/tspm``) is not ported yet.
"""
from __future__ import annotations

import argparse
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
    args = ap.parse_args(argv)
    if args.workload == "queries":
        raise NotImplementedError(
            "--workload queries (serving/tspm, session.serve()) is not ported "
            "yet (ROADMAP queue 1, item 15)")
    return main_lm(args)


if __name__ == "__main__":
    main()
