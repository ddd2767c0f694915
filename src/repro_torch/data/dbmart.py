"""The dbmart: MLHO-format clinical tables, padded patient-major arrays.

The paper's dbmart is a ``(patient_num, date, phenX)`` row table.  tSPM+
sorts it by (patient, date) so every patient is one contiguous chunk — the
precondition for its thread-per-patient mining.  On the device the
analogue is a *padded patient-major* layout: ``phenx[P, E]``,
``date[P, E]``, ``nevents[P]`` — each row is one patient's time-sorted
events, padded to E.  The (patient, date) sort happens once here, at
ingest (numpy mergesort ≙ the paper's stable ips4o pass).

The dbmart is host-side numpy; the session copies it to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.encoding import Vocab, encode_rows


@dataclasses.dataclass
class DBMart:
    """Padded patient-major numeric dbmart (host-side numpy)."""

    phenx: np.ndarray     # [P, E] int32 (padding: 0 beyond nevents; masked)
    date: np.ndarray      # [P, E] int32 days; non-decreasing within a row
    nevents: np.ndarray   # [P]    int32
    vocab: Vocab | None = None

    @property
    def n_patients(self) -> int:
        return self.phenx.shape[0]

    @property
    def max_events(self) -> int:
        return self.phenx.shape[1]

    @property
    def total_events(self) -> int:
        return int(self.nevents.sum())

    def slice_patients(self, start: int, stop: int, max_events: int | None = None) -> "DBMart":
        e = int(self.nevents[start:stop].max(initial=0)) if max_events is None else max_events
        e = max(e, 1)
        return DBMart(
            self.phenx[start:stop, :e], self.date[start:stop, :e],
            self.nevents[start:stop], self.vocab,
        )

    def valid_mask(self) -> np.ndarray:
        return np.arange(self.max_events)[None, :] < self.nevents[:, None]


def from_arrays(phenx, date, nevents, phenx_strings=None,
                patient_keys=None) -> DBMart:
    """A dbmart from existing padded arrays and, optionally, the vocab's two
    lookup lists — how a dbmart encoded elsewhere (for instance by the JAX
    package) is carried over unchanged."""
    vocab = (None if phenx_strings is None
             else Vocab(list(phenx_strings), list(patient_keys or [])))
    return DBMart(np.asarray(phenx, np.int32), np.asarray(date, np.int32),
                  np.asarray(nevents, np.int32), vocab)


def from_rows(
    patients, dates, phenx, vocab: Vocab | None = None, pad_multiple: int = 8
) -> DBMart:
    """Row table -> padded DBMart.  Sorts by (patient, date), stable.

    ``pad_multiple`` rounds E up to a tile-friendly width.
    """
    pid, date, xid, vocab = encode_rows(patients, dates, phenx, vocab)
    order = np.lexsort((np.arange(len(pid)), date, pid))  # stable (patient, date)
    pid, date, xid = pid[order], date[order], xid[order]

    n_pat = int(pid.max()) + 1 if len(pid) else 0
    counts = np.bincount(pid, minlength=n_pat).astype(np.int32)
    e_max = int(counts.max(initial=1))
    e_max = -(-e_max // pad_multiple) * pad_multiple

    phenx_arr = np.zeros((n_pat, e_max), np.int32)
    date_arr = np.zeros((n_pat, e_max), np.int32)
    starts = np.zeros(n_pat + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    cols = np.arange(len(pid)) - starts[pid]
    phenx_arr[pid, cols] = xid
    date_arr[pid, cols] = date
    # pad dates with the row's last date so padded durations are 0, not huge
    last = date_arr[np.arange(n_pat), np.maximum(counts - 1, 0)]
    pad = np.arange(e_max)[None, :] >= counts[:, None]
    date_arr = np.where(pad, last[:, None], date_arr)
    return DBMart(phenx_arr, date_arr, counts, vocab)


def first_occurrence_filter(db: DBMart) -> DBMart:
    """Keep only the first occurrence of each phenX per patient.

    The paper's comparison benchmark applies this (protocol of the AD study)
    to bound the sequence count for the original tSPM.  Vectorized: one
    stable sort of the valid events by (patient, phenX, position) marks
    each group's first event, and a per-row running count compacts the
    kept events to the left, padding dates with the row's last kept date.
    """
    P, E = db.phenx.shape
    pp, ii = np.nonzero(np.arange(E)[None, :] < db.nevents[:, None])
    xx = db.phenx[pp, ii]
    order = np.lexsort((ii, xx, pp))
    first = np.ones(len(order), bool)
    first[1:] = ((pp[order][1:] != pp[order][:-1])
                 | (xx[order][1:] != xx[order][:-1]))
    keep = np.zeros(len(order), bool)
    keep[order] = first
    kp, ki = pp[keep], ii[keep]              # still in (patient, position) order

    counts = np.bincount(kp, minlength=P)
    starts = np.zeros(P + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    cols = np.arange(len(kp)) - starts[kp]
    phenx = np.zeros_like(db.phenx)
    date = np.zeros_like(db.date)
    phenx[kp, cols] = db.phenx[kp, ki]
    date[kp, cols] = db.date[kp, ki]
    nevents = counts.astype(db.nevents.dtype)
    last = date[np.arange(P), np.maximum(counts - 1, 0)]
    pad = (np.arange(E)[None, :] >= counts[:, None]) & (counts[:, None] > 0)
    date = np.where(pad, last[:, None], date).astype(db.date.dtype)

    e_max = max(int(nevents.max(initial=1)), 1)
    e_max = -(-e_max // 8) * 8
    return DBMart(phenx[:, :e_max], date[:, :e_max], nevents, db.vocab)
