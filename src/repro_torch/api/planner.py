"""Execution planner: pick the engine from cohort size vs budget vs arrival.

The R package "split[s] the dbmart in chunks with an adaptive size to fit
the available memory limitations" and falls back to a file-based mode; the
reference's streaming subsystem added incremental arrival and sharding.
The planner encodes that decision tree once, using the same cost model
everywhere (``chunking.BYTES_PER_PAIR`` over padded pair slabs):

  * incremental input          -> 'stream' (or 'sharded' when n_shards > 1);
  * batch input, n_shards > 1  -> 'sharded' (the config asked for shards);
  * flat corpus > spill_bytes  -> 'files' (host RAM is the next wall);
  * working set fits budget    -> 'batch';
  * otherwise                  -> 'chunked'.

Under ``screen='fused'`` the working set is the corpus-free counting
pass's (one patient block of the plan in ``analysis/roofline``, plus the
table), not the whole corpus, and the plan says ``corpus_free``.

``MiningConfig.engine`` short-circuits the tree — the plan records that it
was forced.  The port runs the ``batch``, ``chunked`` and ``files`` engines
with every screen; a plan that needs anything else (streaming, sharding,
telemetry) raises ``NotImplementedError`` naming the ROADMAP.md item that
ports it, and never runs something else in its place.
"""
from __future__ import annotations

import numpy as np

from repro_torch.analysis import roofline
from repro_torch.api.config import MiningConfig, Plan
from repro_torch.core import chunking, mining

# flat corpus row: 8B seq + 4B dur + 4B patient + 1B mask
_BYTES_PER_ROW = 17

#: where each piece that is not ported yet is queued in ROADMAP.md
NOT_PORTED = {
    "stream": "ROADMAP.md queue 1 item 11 (streaming)",
    "sharded": "ROADMAP.md queue 1 item 12 (sharding)",
    "telemetry": "ROADMAP.md queue 1 item 6 (obs/ telemetry)",
}


def _not_ported(what: str, key: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {NOT_PORTED[key]}")


def _working_set(nevents: np.ndarray, backend: str,
                 pad_multiple: int = 8) -> int:
    """One-shot mining working set: the whole cohort as a single chunk."""
    e = int(np.max(nevents, initial=1))
    e = max(-(-e // pad_multiple) * pad_multiple, 1)
    factor = 1.0 if backend == "kernel" else 0.5  # dense vs triangular
    return int(len(nevents) * e * e * chunking.BYTES_PER_PAIR * factor)


def _fused_working_set(nevents: np.ndarray, config: MiningConfig, device,
                       pad_multiple: int = 8) -> int:
    """Screen-pass working set under ``screen='fused'``: one patient block
    of dense pair slabs plus the [2^H] table — independent of P once the
    cohort exceeds a block (the corpus is never materialized before the
    screen)."""
    e = int(np.max(nevents, initial=1))
    e = max(-(-e // pad_multiple) * pad_multiple, 1)
    plan = roofline.mining_tile_plan(e, config.n_buckets_log2, device=device)
    blk = min(plan.block_patients, len(nevents))
    return int(blk * e * e * chunking.BYTES_PER_PAIR
               + (4 << config.n_buckets_log2))


def _corpus_bytes(nevents: np.ndarray) -> int:
    n = nevents.astype(np.int64)
    return int(np.sum(n * (n - 1) // 2)) * _BYTES_PER_ROW


def make_plan(config: MiningConfig, nevents=None, incremental: bool = False,
              device="cuda") -> Plan:
    """Decide the engine for a cohort (``nevents`` per patient) mined on
    ``device`` (the card unless the caller asks for the CPU, as the
    session); raises ``NotImplementedError`` for what is not ported."""
    if config.telemetry:
        raise _not_ported("MiningConfig(telemetry=True)", "telemetry")
    nevents = (np.zeros(0, np.int64) if nevents is None
               else np.asarray(nevents, np.int64))
    fused = config.screen == "fused"
    backend = mining.resolve_backend(config.backend, device)
    if not len(nevents):
        ws = 0
    elif fused:
        ws = _fused_working_set(nevents, config, device)
    else:
        ws = _working_set(nevents, backend)
    corpus = _corpus_bytes(nevents) if len(nevents) else 0
    budget = config.budget_bytes
    n_chunks = (len(chunking.plan_chunks(nevents, budget))
                if budget is not None and len(nevents) else 1)
    common = dict(working_set_bytes=ws, budget_bytes=budget,
                  disk_bytes=config.disk_bytes,
                  corpus_bytes=corpus, n_chunks=n_chunks,
                  n_shards=config.n_shards, placement="host",
                  incremental=incremental, corpus_free=fused)

    if config.engine is not None:
        plan = Plan(config.engine,
                    "forced by MiningConfig.engine override", **common)
    elif incremental:
        plan = Plan("sharded" if config.n_shards > 1 else "stream",
                    "incremental input (submit/tick)", **common)
    elif config.n_shards > 1:
        plan = Plan("sharded", f"config requests {config.n_shards} patient "
                    "shards", **common)
    elif config.spill_bytes is not None and corpus > config.spill_bytes:
        plan = Plan("files", "flat corpus exceeds spill_bytes; chunks spill "
                    "to disk and screen via the merged count table", **common)
    elif budget is None or ws <= budget:
        plan = Plan("batch", "corpus-free fused screen working set fits the "
                    "byte budget" if fused else
                    "mining working set fits the byte budget", **common)
    else:
        plan = Plan("chunked", "working set exceeds budget_bytes; mining "
                    f"adaptively in {n_chunks} patient chunks", **common)
    if plan.engine in NOT_PORTED:
        raise _not_ported(f"engine {plan.engine!r} ({plan.reason})", plan.engine)
    return plan
