"""Streaming mining subsystem (incremental tSPM+).

Batch mining re-derives all ``n(n-1)/2`` pairs per patient on every run;
a clinical stream appends a handful of events per encounter, so only the
``O(delta * n)`` pairs ending in a new event are actually new.  This
package keeps the screened sequence corpus continuously up to date:

  * ``store``   — device-resident padded patient history planes with
                  per-patient cursors, regrowth, and byte-budget eviction
                  through the host and disk tiers (storage/);
  * ``delta``   — delta mining ([P, E, D] slabs; the plain version + the
                  ``tspm_delta`` CUDA kernel, kernels/tspm_delta);
  * ``counts``  — online support sketch: exact distinct-(patient, seq)
                  hash-bucket counts, incrementally updated, mergeable
                  with batch-screen counts (core/sparsity);
  * ``service`` — micro-batching ingest loop + snapshot queries;
  * ``events``  — the typed session-event union + the subscribe/emit
                  dispatcher the services publish through;
  * ``shard``   — patient->shard router (sticky until migrated) +
                  per-shard services on one device or one each; global
                  screen by one table sum; live patient migration and
                  load-triggered LPT rebalancing.

Invariant (tested against the reference): replaying a dbmart
event-by-event through ``service.StreamService`` yields the same corpus,
support counts, and query masks as ``core.mining`` + ``core.sparsity`` on
the full dbmart.
"""
from repro_torch.stream import counts, delta, events, service, shard, \
    store  # noqa: F401
