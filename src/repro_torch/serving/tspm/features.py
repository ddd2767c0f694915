"""Streaming feature store: per-patient presence vectors, tick-consistent.

Maintains the ``SequenceFrame.to_features(feature_ids=...)`` presence
matrix *incrementally*: every tick's freshly-mined rows arrive through the
service's delta hook, are matched against the (sorted) feature-id list by
binary search, and staged; at publication the replica folds the staging
buffer into a copy-on-write boolean matrix that is captured *into* the
published view.  Queries against a view therefore see the features of
exactly that view's tick — point-in-time consistent with its corpus — and
the matrices handed to past views are never mutated again.

Staging and the copy-on-write fold are host numpy (the delta feed and the
snapshots are host arrays); :meth:`FeatureStore.matrix` hands back CPU
tensors, as ``SequenceFrame.to_features`` does.

Exactness argument (property-tested in tests/test_torch_serving_tspm.py):

  * presence is monotone — a mined (patient, seq) row never un-happens, so
    OR-ing delta hits into the matrix equals recomputing presence over the
    full corpus at every tick;
  * for ``screen='fused'`` frames the corpus is compacted to hash-screen
    survivors, but survival is per-*id* and determined solely by the
    bucket-count table, so presence over survivors equals raw presence
    with a per-feature column mask ``counts[hash(id)] >= threshold`` —
    applied at matrix build time against the view's own table.

Scope: the store tracks the full mined-row feed — rows mined by ticks
(the delta hook), the bootstrap snapshot taken when serving starts, and
rows arriving with migration-admitted patients (the ``Migrated`` event
with ``src=None`` carries the admitted state; ``on_admitted`` stages its
already-mined corpus rows, which never appear in any tick feed).
Patients extracted from a live service keep their accumulated features —
presence is append-only.  Internal shard-to-shard migrations need no
handling: their rows were already staged by past tick feeds.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.core import msmr, sparsity
from repro_torch.core.encoding import SENTINEL


class FeatureStore:
    """Incrementally-maintained patient x feature presence matrix.

    ``feature_ids`` must be sorted strictly increasing int64 (the same
    contract ``msmr.feature_matrix`` binary-searches against).  Rows are
    indexed by the *original integer patient key*, matching the patient
    column of session frames over int-keyed cohorts.
    """

    def __init__(self, feature_ids):
        ids = np.asarray(feature_ids, np.int64).reshape(-1)
        if len(ids) and np.any(np.diff(ids) <= 0):
            raise ValueError("feature_ids must be sorted strictly "
                             "increasing (msmr binary-search contract)")
        self.feature_ids = ids
        self._x = np.zeros((0, len(ids)), bool)
        self._staging: list[tuple[np.ndarray, np.ndarray]] = []
        self._lock = threading.Lock()

    # --- ingest side --------------------------------------------------------
    def stage_rows(self, patient_keys, seq) -> None:
        """Stage aligned (patient key, mined seq id) rows for the next fold
        (used for bootstrap and by the delta hook)."""
        k = self.feature_ids
        seq = np.asarray(seq, np.int64).reshape(-1)
        if len(k) == 0 or len(seq) == 0:
            return
        keys = np.asarray(patient_keys).reshape(-1)
        if not np.issubdtype(keys.dtype, np.integer):
            raise TypeError("feature store requires integer patient keys; "
                            f"got dtype {keys.dtype}")
        idx = np.clip(np.searchsorted(k, seq), 0, len(k) - 1)
        hit = k[idx] == seq
        if not hit.any():
            return
        with self._lock:
            self._staging.append((keys[hit].astype(np.int64), idx[hit]))

    def on_delta(self, keys, slot_idx, seq, dur) -> None:
        """StreamService delta subscriber: ``keys`` are the wave's patient
        keys, ``slot_idx`` maps each mined row to its wave slot."""
        if len(self.feature_ids) == 0 or len(seq) == 0:
            return
        keys = np.asarray(keys)
        if not np.issubdtype(keys.dtype, np.integer):
            raise TypeError("feature store requires integer patient keys; "
                            f"got dtype {keys.dtype}")
        self.stage_rows(keys[np.asarray(slot_idx)], seq)

    def on_admitted(self, state) -> None:
        """Migration-admit subscriber (``Migrated`` with ``src=None``):
        stage the admitted patient's already-mined corpus rows — they
        predate this cohort's ticks, so no tick feed will ever carry
        them."""
        seq = np.asarray(state.corpus_seq, np.int64).reshape(-1)
        if len(self.feature_ids) == 0 or len(seq) == 0:
            return
        self.stage_rows(np.full(len(seq), state.key), seq)

    def fold(self) -> np.ndarray:
        """Fold staged deltas into a fresh matrix and return it.

        Copy-on-write: the returned array is never mutated by later folds,
        so views capture it by reference.  Row capacity grows
        geometrically, like every other streaming plane."""
        with self._lock:
            staged, self._staging = self._staging, []
        if staged:
            rows = np.concatenate([r for r, _ in staged])
            cols = np.concatenate([c for _, c in staged])
            need = int(rows.max()) + 1
            x = self._x
            if need > len(x):
                cap = max(need, 2 * len(x), 64)
                grown = np.zeros((cap, x.shape[1]), bool)
                grown[:len(x)] = x
                x = grown
            else:
                x = x.copy()
            x[rows, cols] = True
            self._x = x
        return self._x

    # --- read side ----------------------------------------------------------
    def matrix(self, view) -> msmr.FeatureMatrix:
        """The feature matrix of a published view — byte-identical to
        ``view.frame.to_features(feature_ids=self.feature_ids)`` (CPU
        tensors).

        Fused frames get the per-feature survival column mask from the
        view's own bucket-count table (see module docstring); everything
        else is a float32 cast of the captured presence rows."""
        fr = view.frame
        k = self.feature_ids
        n_patients = fr.n_patients
        ids = torch.from_numpy(k)
        if len(k) == 0 or n_patients == 0:
            return msmr.FeatureMatrix(
                torch.zeros((n_patients, len(k)), dtype=torch.float32),
                ids, torch.tensor(len(k)))
        out = np.zeros((n_patients, len(k)), np.float32)
        x = view.feature_x
        if x is not None and len(x):
            m = min(n_patients, len(x))
            out[:m] = x[:m]
        if fr.screen_mode == "fused":
            h = sparsity.hash_bucket(ids, fr._corpus.n_buckets_log2).numpy()
            col_keep = fr._corpus.counts()[h] >= fr.threshold
            out *= col_keep
        return msmr.FeatureMatrix(torch.from_numpy(out), ids,
                                  torch.sum(ids != SENTINEL))
