"""End-to-end training launcher: tSPM+ pipeline -> LM training, on the card.

Synthetic cohort -> dbmart -> token corpus -> train with checkpoints,
preemption guard, straggler watchdog.  The twin of the reference's
``launch/train.py``: the same flags and log lines, plus ``--device``
(default ``cuda``; ``cpu`` runs the plain versions).  A resumed run
restarts the batch iterator from the seed, as the reference's does.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tspm-mlho
  PYTHONPATH=src python -m repro_torch.launch.train --arch tspm-mlho --reduced \\
      --device cpu --steps 200 --ckpt-dir CKPT

Beyond the reference's lines it prints, after each blocking checkpoint
save and each restore, a ``state_digest=`` over the state's bytes (a
resumed run's digest equals the saved run's), and at the end the step
time (host clock around each step, ended by a synchronize), tokens a
second, peak device memory and the attention kernels' launches (the
backward's by route too).
"""
from __future__ import annotations

import argparse
import hashlib
import time

import torch

from repro_torch import obs as obs_lib
from repro_torch.configs import get_config
from repro_torch.data import synthea, tokenize
from repro_torch.data.dbmart import from_rows
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import model as model_lib
from repro_torch.training import checkpoint, elastic
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_loop


def state_digest(state: train_loop.TrainState) -> str:
    """sha256 over every leaf of the state (parameters by name, moments,
    step), in ``checkpoint``'s leaf order."""
    h = hashlib.sha256()
    for leaf in checkpoint._flatten(train_loop.state_tree(state))[0]:
        h.update(leaf.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _save(ckpt_dir: str, step: int, state) -> None:
    path = checkpoint.save(ckpt_dir, step, train_loop.state_tree(state))
    print(f"checkpoint {path} state_digest={state_digest(state)}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tspm-mlho")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--patients", type=int, default=256)
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="dump the training metrics snapshot as JSON on exit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    device = model_lib.resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    # data: the paper's pipeline feeding the LM
    pats, dates, phx, _ = synthea.generate_cohort(
        n_patients=args.patients, avg_events=40, seed=args.seed)
    db = from_rows(pats, dates, phx)
    corpus = tokenize.pack_corpus(db, seq_len=args.seq)
    vocab_needed = corpus.vocab_size
    if cfg.vocab_size < vocab_needed:
        cfg = cfg.replace(vocab_size=vocab_needed)
    print(f"corpus: {corpus.tokens.shape} vocab={corpus.vocab_size} "
          f"({db.total_events} events, {db.n_patients} patients)")

    mdl = model_lib.build(cfg)
    state = train_loop.init_state(mdl, torch.Generator(device).manual_seed(args.seed))
    print(f"model: {args.arch} params={model_lib.param_count(state.params):,}")

    opt_cfg = opt_lib.OptConfig(peak_lr=args.lr, warmup_steps=20,
                                decay_steps=args.steps)
    step_fn = train_loop.make_train_step(mdl, opt_cfg, microbatches=args.microbatches)

    start = 0
    if args.ckpt_dir:
        latest = checkpoint.latest(args.ckpt_dir)
        if latest:
            tree, manifest = checkpoint.restore(latest, train_loop.state_tree(state))
            state = train_loop.restore_state(state, tree)
            start = manifest["step"]
            print(f"resumed from {latest} at step {start}")
            print(f"restored state_digest={state_digest(state)}", flush=True)

    guard = elastic.PreemptionGuard()
    watchdog = elastic.StepWatchdog()
    batches = tokenize.lm_batches(corpus, args.batch, seed=args.seed)
    # training observability goes through the same registry as the mining
    # stack (repro_torch.obs): the log line below and the --metrics-json
    # snapshot read from one source of truth
    tel = obs_lib.Telemetry()
    reg = tel.metrics
    m_steps = reg.counter("train.steps")
    m_stragglers = reg.counter("train.stragglers")
    m_loss = reg.gauge("train.loss")
    m_ce = reg.gauge("train.ce")
    m_lr = reg.gauge("train.lr")
    m_step_s = reg.histogram("train.step_s")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    fwd0, bwd0 = flash_ops.attention.launches, flash_ops.attention_bwd.launches
    routes0 = dict(flash_ops.attention_bwd.route_launches)
    t0 = time.time()
    for step in range(start, args.steps):
        if guard.preempted:
            print(f"preempted at step {step}; checkpointing and exiting")
            if args.ckpt_dir:
                _save(args.ckpt_dir, step, state)
            return state
        batch = next(batches)
        watchdog.start()
        ts = time.perf_counter()
        state, metrics = step_fn(state, batch)
        if cuda:
            torch.cuda.synchronize(device)
        slow = watchdog.stop(step)
        m_step_s.observe(time.perf_counter() - ts)
        m_steps.inc()
        if slow:
            m_stragglers.inc()
        m_loss.set(float(metrics["loss"]))
        m_ce.set(float(metrics["ce"]))
        m_lr.set(float(metrics["lr"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step}: loss={m_loss.value:.4f} "
                  f"ce={m_ce.value:.4f} "
                  f"lr={m_lr.value:.2e}"
                  + (" [straggler]" if slow else ""), flush=True)
        if args.ckpt_dir and step and step % args.ckpt_every == 0:
            checkpoint.save_async(args.ckpt_dir, step, train_loop.state_tree(state))
    checkpoint.wait()
    if args.ckpt_dir:
        _save(args.ckpt_dir, args.steps, state)
    snap = reg.snapshot()
    if args.metrics_json:
        import json

        with open(args.metrics_json, "w") as fh:
            json.dump(snap, fh, indent=2, sort_keys=True)
        print(f"metrics snapshot -> {args.metrics_json}")
    step_sum = snap.get("train.step_s", {})
    steps = snap["train.steps"]
    print(f"done in {time.time()-t0:.1f}s "
          f"({steps} steps, "
          f"{snap['train.stragglers']} stragglers, "
          f"mean step {step_sum.get('sum', 0.0) / max(steps, 1):.3f}s)")
    tokens = steps * args.batch * args.seq
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    print(f"throughput on {device}: mean step {step_sum.get('sum', 0.0) / max(steps, 1)}s, "
          f"tokens/s {tokens / max(step_sum.get('sum', 0.0), 1e-12)}, "
          f"peak_device_bytes {peak}, flash_attention launches "
          f"{flash_ops.attention.launches - fwd0}, flash_attention_bwd launches "
          f"{flash_ops.attention_bwd.launches - bwd0} ("
          + ", ".join(f"{r} {n - routes0[r]}"
                      for r, n in flash_ops.attention_bwd.route_launches.items()) + ")",
          flush=True)
    return state


if __name__ == "__main__":
    main()
