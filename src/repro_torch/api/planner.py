"""Execution planner: pick the engine from cohort size vs budget vs arrival.

The R package "split[s] the dbmart in chunks with an adaptive size to fit
the available memory limitations" and falls back to a file-based mode; the
reference's streaming subsystem added incremental arrival and sharding.
The planner encodes that decision tree once, using the reference's cost
model for the choice (``chunking.BYTES_PER_PAIR`` over padded pair slabs):

  * incremental input          -> 'stream' (or 'sharded' when n_shards > 1);
  * batch input, n_shards > 1  -> 'sharded' (the config asked for shards);
  * flat corpus > spill_bytes  -> 'files' (host RAM is the next wall);
  * working set fits budget    -> 'batch';
  * otherwise                  -> 'chunked'.

Under ``screen='fused'`` the working set is the corpus-free counting
pass's (one patient block of the plan in ``analysis/roofline``, plus the
table), not the whole corpus, and the plan says ``corpus_free``.

On the card the chunk count is the card's plan
(``chunking.plan_card_chunks``, which prices the dense slab and its
scratch so that ``budget_bytes`` bounds the card's peak); on the CPU it is
the reference's ``plan_chunks``.

For the sharded engine the plan also resolves *placement*: with
``placement='auto'`` shards are pinned one per device whenever sharding is
on (``n_shards > 1``) and the session's device type has at least as many
devices as shards (``torch.cuda.device_count()`` for the card, 1 for the
CPU), else they stay host-serial on the session's device — so on one
H100 ``n_shards=4`` gives ``'host'``, as the reference does with fewer
devices than shards.  Both placements are byte-identical.

``MiningConfig.engine`` short-circuits the tree — the plan records that it
was forced.  The port runs the ``batch``, ``chunked``, ``files``,
``stream`` and ``sharded`` engines with every screen, with or without
telemetry and the tick journal.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis import roofline
from repro_torch.api.config import MiningConfig, Plan
from repro_torch.core import chunking, mining

# flat corpus row: 8B seq + 4B dur + 4B patient + 1B mask
_BYTES_PER_ROW = 17

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


def resolve_placement(config: MiningConfig, device="cuda") -> str:
    """Shard placement for the sharded engine, 'auto' resolved against the
    devices of ``device``'s type: one shard per device when there are
    enough, else host-serial.  Forced 'devices' is honored even with fewer
    devices than shards (round-robin, still correct)."""
    if config.placement != "auto":
        return config.placement
    kind = torch.device(device).type
    count = torch.cuda.device_count() if kind == "cuda" else 1
    if config.n_shards > 1 and count >= config.n_shards:
        return "devices"
    return "host"


def make_plan(config: MiningConfig, nevents=None, incremental: bool = False,
              device="cuda") -> Plan:
    """Decide the engine for a cohort (``nevents`` per patient) mined on
    ``device`` (the card unless the caller asks for the CPU, as the
    session) or an incremental session (``incremental=True``, no cohort
    known up front)."""
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
    n_chunks = (len(chunking.plan_device_chunks(
        nevents, budget, device, config.n_buckets_log2).chunks)
        if budget is not None and len(nevents) else 1)
    common = dict(working_set_bytes=ws, budget_bytes=budget,
                  disk_bytes=config.disk_bytes,
                  corpus_bytes=corpus, n_chunks=n_chunks,
                  n_shards=config.n_shards,
                  placement=resolve_placement(config, device),
                  incremental=incremental, corpus_free=fused)

    if config.engine is not None:
        plan = Plan(config.engine,
                    "forced by MiningConfig.engine override", **common)
    elif incremental and config.n_shards > 1:
        plan = Plan("sharded", f"incremental input over {config.n_shards} "
                    f"patient shards ({common['placement']} placement)",
                    **common)
    elif incremental:
        plan = Plan("stream", "incremental input (submit/tick)", **common)
    elif config.n_shards > 1:
        plan = Plan("sharded", f"config requests {config.n_shards} patient "
                    "shards; batch input replayed through them "
                    f"({common['placement']} placement)", **common)
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
    return plan
