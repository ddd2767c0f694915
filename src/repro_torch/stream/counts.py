"""Online support sketch: incremental distinct-(patient, sequence) counts.

Batch screening (core/sparsity.local_bucket_counts) dedupes sequences per
patient row, multiply-shift hashes them into 2^H buckets and histograms
them.  The streaming sketch maintains the *same* bucket table
incrementally: per patient it keeps the sorted set of sequence ids already
contributed, and a tick's delta slab increments a bucket only for ids the
patient has never produced (dedup within the delta by sort-run flags,
against history by binary search).  Consequences, both tested against the
reference:

  * the table equals ``local_bucket_counts`` of the full batch-mined
    corpus after any replay order — not an approximation of it;
  * it stays mergeable with batch-screen counts
    (``sparsity.merge_bucket_counts``) and keeps the one-sided error of
    the hash screen: collisions only ever over-count, so a non-sparse
    sequence is never dropped.

The histogram of a tick's novel ids is ``kernels/seq_hist`` (the CUDA
kernel on the card, its plain version on the CPU), as in the batch screen.

Shard migration hands a patient's row between sketches with
``extract_row`` / ``admit_row``: the sorted distinct-id set moves, and the
bucket table transfers by subtract-at-source / add-at-dest — each side's
table stays exactly ``local_bucket_counts`` of *its* patient set.

The table and the set planes are tensors on the sketch's ``device``.  A
fold replaces the table (it is never written in place, so a snapshot that
holds the previous one keeps its bytes); the set planes are updated in
place, and ``state_dict`` copies them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs as obs_lib
from repro_torch.core import sparsity
from repro_torch.core.encoding import SENTINEL, as_tensor
from repro_torch.kernels.seq_hist import ops as hist_ops


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t`` that later in-place updates of ``t`` do
    not reach (``.numpy()`` of a CPU tensor shares its memory)."""
    a = t.detach().cpu().numpy()
    return a.copy() if t.device.type == "cpu" else a


def sketch_update(counts, stored, seq, mask, n_buckets_log2: int):
    """One tick: (counts', merged per-patient sets, per-row novel counts).

    ``stored`` [B, C] are the patients' sorted sentinel-padded sequence
    sets; ``seq``/``mask`` [B, T] the tick's delta slab rows.  Every call
    records its ``(B, C, T)`` in ``sketch_update.shapes``.
    """
    B, C = stored.shape
    flat = torch.where(mask.reshape(B, -1), as_tensor(seq, torch.int64).reshape(B, -1),
                       SENTINEL)
    sketch_update.shapes.add((B, C, flat.shape[1]))
    srt = torch.sort(flat, dim=1).values
    del flat
    first = sparsity.row_first_flags(srt)   # same dedup as the batch screen
    idx = torch.searchsorted(stored, srt)    # left side, as jnp.searchsorted
    present = torch.gather(stored, 1, idx.clamp_(0, C - 1)) == srt
    novel = first & ~present
    h = sparsity.hash_bucket(srt, n_buckets_log2)
    counts = counts + hist_ops.hist(h, novel, 1 << n_buckets_log2)
    merged = torch.sort(
        torch.cat([stored, torch.where(novel, srt, SENTINEL)], dim=1),
        dim=1).values
    return counts, merged, torch.sum(novel, dim=1).to(torch.int32)


sketch_update.shapes = set()


class _PendingSketchUpdate:
    """Device phase of one tick's sketch fold, awaiting host bookkeeping.

    ``counts`` was already swapped in by ``update_begin`` (the device work
    is queued; nothing blocked).  ``update_finish`` reads ``n_novel`` and
    lands ``merged`` in the set planes."""

    __slots__ = ("pids", "merged", "n_novel")

    def __init__(self, pids, merged, n_novel):
        self.pids = pids
        self.merged = merged
        self.n_novel = n_novel


class OnlineSupportSketch:
    """Incrementally maintained hash-bucket support table + per-patient sets.

    ``device`` holds the table and set planes (the store's device; the
    card unless the caller passes ``'cpu'``): tick folds and handoff
    scatters stay there."""

    def __init__(self, n_buckets_log2: int = 20, pad_multiple: int = 64,
                 device="cuda", telemetry=None, labels: dict | None = None):
        self.n_buckets_log2 = n_buckets_log2
        self.pad_multiple = pad_multiple
        self.device = torch.device(device)
        self.counts = torch.zeros(1 << n_buckets_log2, dtype=torch.int32,
                                  device=self.device)
        self.seqset = torch.full((0, pad_multiple), SENTINEL, dtype=torch.int64,
                                 device=self.device)
        self.n_distinct = np.zeros(0, np.int32)
        self.obs = telemetry if telemetry is not None else obs_lib.NOOP
        lbl = labels or {}
        m = self.obs.metrics
        self._m_novel = m.counter("sketch.novel_ids", **lbl)
        self._m_growths = m.counter("sketch.plane_growths", **lbl)
        self._m_load = m.gauge("sketch.bucket_load_factor", **lbl)
        self._m_cols = m.gauge("sketch.set_columns", **lbl)

    @property
    def n_patients(self) -> int:
        return self.seqset.shape[0]

    def _pad(self, rows: int, cols: int) -> None:
        """Grow the set planes by ``rows`` rows and ``cols`` columns of
        SENTINEL."""
        P, C = self.seqset.shape
        grown = torch.full((P + rows, C + cols), SENTINEL, dtype=torch.int64,
                           device=self.device)
        grown[:P, :C] = self.seqset
        self.seqset = grown

    def ensure_patients(self, n: int) -> None:
        if n <= self.n_patients:
            return
        grow = -(-n // 8) * 8 - self.n_patients
        self._pad(grow, 0)
        self.n_distinct = np.pad(self.n_distinct, (0, grow))

    def _ensure_columns(self, n: int) -> None:
        """Widen the per-patient set planes to hold ``n`` ids (round up to
        the pad multiple, double geometrically — one growth policy for
        tick updates and migration admits)."""
        need = -(-max(n, 1) // self.pad_multiple) * self.pad_multiple
        if need <= self.seqset.shape[1]:
            return
        need = max(need, 2 * self.seqset.shape[1])
        self._pad(0, need - self.seqset.shape[1])
        self._m_growths.inc()

    def update(self, pids, seq, mask) -> int:
        """Fold a tick's delta slab rows into the table; returns #novel ids.

        Pids must be distinct: rows gather/scatter the per-patient sets,
        so a repeated pid would double-count its buckets and lose part of
        its merged set."""
        return self.update_finish(self.update_begin(pids, seq, mask))

    def update_begin(self, pids, seq, mask) -> _PendingSketchUpdate:
        """Device phase only: queue the fold and swap the new table in
        without any host transfer (``update_finish`` completes the host
        bookkeeping)."""
        pids = np.asarray(pids, np.int32)
        if len(np.unique(pids)) != len(pids):
            raise ValueError("duplicate pids in one sketch update")
        self.ensure_patients(int(pids.max(initial=-1)) + 1)
        rows = torch.from_numpy(pids.astype(np.int64)).to(self.device)
        stored = self.seqset[rows]
        B = stored.shape[0]
        self.counts, merged, n_novel = sketch_update(
            self.counts, stored, as_tensor(seq, torch.int64).reshape(B, -1),
            as_tensor(mask, torch.bool).reshape(B, -1), self.n_buckets_log2)
        return _PendingSketchUpdate(pids, merged, n_novel)

    def update_finish(self, pending: _PendingSketchUpdate) -> int:
        """Host phase: read the novel counts, grow the set planes if a
        patient's distinct set outgrew them, and land the merged rows."""
        pids, merged = pending.pids, pending.merged
        n_novel = pending.n_novel.cpu().numpy()
        self.n_distinct[pids] += n_novel
        self._ensure_columns(int(self.n_distinct.max(initial=1)))
        C = self.seqset.shape[1]
        if merged.shape[1] < C:
            merged = torch.cat([merged, torch.full(
                (merged.shape[0], C - merged.shape[1]), SENTINEL,
                dtype=torch.int64, device=self.device)], dim=1)
        self.seqset[torch.from_numpy(pids.astype(np.int64)).to(self.device)] = \
            merged[:, :C]
        n = int(n_novel.sum())
        self._m_novel.inc(n)
        return n

    def sample_metrics(self) -> None:
        """Snapshot-time gauges: bucket load factor (occupied / 2^H — one
        device->host table copy, so never sampled per tick) and the
        per-patient set plane width."""
        if not self.obs.enabled:
            return
        table = self.counts.cpu().numpy()
        self._m_load.set(float(np.count_nonzero(table)) / max(len(table), 1))
        self._m_cols.set(int(self.seqset.shape[1]))

    # --- migration handoff --------------------------------------------------
    def _bucket_transfer(self, ids: np.ndarray, sign: int) -> None:
        """Add ``sign`` to each id's bucket (a new table tensor)."""
        h = sparsity.hash_bucket(torch.from_numpy(np.array(ids, np.int64)),
                                 self.n_buckets_log2).to(torch.int64)
        w = torch.full(h.shape, sign, dtype=torch.int32)
        self.counts = self.counts.index_add(0, h.to(self.device), w.to(self.device))

    def extract_row(self, pid: int) -> np.ndarray:
        """Withdraw a patient's set: returns its sorted distinct sequence
        ids and *subtracts* one from each id's bucket, so this table is
        again exactly ``local_bucket_counts`` of the remaining patients.
        The row stays allocated (pids are never reused) but zeroed."""
        if pid >= self.n_patients:
            return np.zeros(0, np.int64)
        n = int(self.n_distinct[pid])
        ids = self.seqset[pid].cpu().numpy()[:n].copy()
        if n:
            self._bucket_transfer(ids, -1)
            self.seqset[pid] = SENTINEL
            self.n_distinct[pid] = 0
        return ids

    def admit_row(self, pid: int, ids) -> None:
        """Install a migrated patient's sorted distinct-id set at ``pid``
        and *add* one to each id's bucket (the other half of the
        subtract/add transfer; extract then admit is a global no-op)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        self.ensure_patients(pid + 1)
        self._ensure_columns(len(ids))
        row = np.full(self.seqset.shape[1], SENTINEL, np.int64)
        row[: len(ids)] = ids
        self.seqset[pid] = torch.from_numpy(row).to(self.device)
        self.n_distinct[pid] = len(ids)
        if len(ids):
            self._bucket_transfer(ids, 1)

    # --- checkpoint ---------------------------------------------------------
    def state_dict(self) -> dict:
        """Bucket table + per-patient set planes (shapes included: the
        restored planes keep their exact width)."""
        return {"counts": to_host(self.counts),
                "seqset": to_host(self.seqset),
                "n_distinct": self.n_distinct.copy()}

    def load_state_dict(self, state: dict) -> None:
        """Inverse of :meth:`state_dict`; takes the reference sketch's
        ``state_dict()`` too (its arrays turned to numpy)."""
        self.counts = torch.from_numpy(
            np.array(state["counts"], np.int32)).to(self.device)
        self.seqset = torch.from_numpy(
            np.array(state["seqset"], np.int64)).to(self.device)
        self.n_distinct = np.asarray(state["n_distinct"], np.int32).copy()

    # --- interop with the batch screen -------------------------------------
    def merged_with(self, batch_counts):
        """Sketch counts + batch-screen bucket counts (same table format)."""
        return sparsity.merge_bucket_counts(
            self.counts, as_tensor(batch_counts, torch.int32).to(self.device))

    def keep_mask(self, seq, mask, threshold: int):
        """Hash-screen keep mask over any corpus using the live table."""
        return sparsity.screen_hash_from_counts(
            seq, mask, self.counts, threshold, self.n_buckets_log2)

    def survivors(self, seq, dur, patient, threshold: int, mask=None):
        """Compact a corpus to its hash-screen survivors using the live
        table — the streaming half of ``screen='fused'``: because this
        table exactly equals the batch ``local_bucket_counts``, the
        compacted arrays are byte-identical to the corpus-free batch
        path's survivors on the same corpus."""
        return sparsity.screen_survivors(
            seq, dur, patient, self.counts, threshold, self.n_buckets_log2,
            mask=mask)
