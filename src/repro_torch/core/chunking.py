"""Adaptive dbmart partitioning + file-based mining (the paper's two modes).

The R package "split[s] the dbmart in chunks with an adaptive size to fit
the available memory limitations", and the C++ library has a *file-based*
mode that spills per-patient sequence files.  Here the same two ideas govern
device memory:

  * ``plan_chunks`` — greedy patient ranges such that the mining working set
    ``P_chunk * E_chunk^2 * BYTES_PER_PAIR`` fits the byte budget;
    per-chunk ``E`` adapts to the longest patient in the chunk (padded to a
    tile multiple), so short-history chunks pack many more patients.
  * ``mine_chunked`` — in-memory mode: mine chunk by chunk on the device,
    merge on the host.
  * ``mine_fused`` — corpus-free counting pass, then a re-mine that keeps
    only the survivors of the hash screen.
  * ``mine_to_files`` / ``load_files`` / ``screen_files`` — file-based mode:
    spill each chunk's real rows to ``chunk_%05d.npz`` (``seq``, ``dur``,
    ``patient``) beside the merged ``bucket_counts.npy``, and stream them
    back.  The reference package writes and reads the same directory.

Each chunk is mined on ``device`` (the card unless the caller asks for the
CPU) and compacted to its real rows there, so padding never crosses to the
host.  Rows keep the order of the flattened mined layout, chunk after
chunk, so two engines that visit the same chunks give the same rows in the
same order.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable

import numpy as np
import torch

from repro_torch.core import mining, sparsity

# dense pair tile: 8B seq + 4B dur + 1B mask, x2 for sort scratch
BYTES_PER_PAIR = 26


@dataclasses.dataclass(frozen=True)
class Chunk:
    start: int
    stop: int
    max_events: int

    @property
    def n_patients(self) -> int:
        return self.stop - self.start


def plan_chunks(nevents: np.ndarray, budget_bytes: int,
                pad_multiple: int = 8, layout: str = "triangular") -> list[Chunk]:
    """Greedy adaptive partitioning under a working-set byte budget."""
    chunks: list[Chunk] = []
    P = len(nevents)
    factor = 0.5 if layout == "triangular" else 1.0
    i = 0
    while i < P:
        e = max(int(nevents[i]), 1)
        e = -(-e // pad_multiple) * pad_multiple
        j = i + 1
        while j < P:
            e2 = max(e, -(-max(int(nevents[j]), 1) // pad_multiple) * pad_multiple)
            cost = (j + 1 - i) * e2 * e2 * BYTES_PER_PAIR * factor
            if cost > budget_bytes and j > i:
                break
            e = e2
            j += 1
        if (j - i) * e * e * BYTES_PER_PAIR * factor > budget_bytes and j - i > 1:
            j -= 1
            e = max(1, -(-int(max(nevents[i:j], default=1)) // pad_multiple) * pad_multiple)
        chunks.append(Chunk(i, j, e))
        i = j
    return chunks


def _mine_chunk(db, ch: Chunk, device, codec, backend, fuse_duration,
                bucket_days) -> mining.Mined:
    sub = db.slice_patients(ch.start, ch.stop, ch.max_events)
    args = (torch.as_tensor(a, dtype=torch.int32).to(device)
            for a in (sub.phenx, sub.date, sub.nevents))
    return mining.mine(*args, codec=codec, fuse_duration=fuse_duration,
                       bucket_days=bucket_days, backend=backend)


def real_rows(mined: mining.Mined, patient_offset: int = 0):
    """The real (masked) rows of a mined chunk as flat (seq, dur, patient)
    tensors on its device, in ``mining.flatten`` order."""
    P = mined.seq.shape[0]
    T = mined.seq.numel() // max(P, 1)
    idx = torch.nonzero(mined.mask.reshape(-1)).squeeze(1)
    patient = torch.div(idx, max(T, 1), rounding_mode="floor") + patient_offset
    return (mined.seq.reshape(-1)[idx], mined.dur.reshape(-1)[idx],
            patient.to(torch.int32))


def _cat(parts: list, k: int, dtype) -> np.ndarray:
    return np.concatenate([p[k] for p in parts]) if parts else np.zeros(0, dtype)


def _host_counts(counts, n_buckets_log2: int) -> np.ndarray:
    if counts is None:
        return np.zeros(1 << n_buckets_log2, np.int32)
    return counts.cpu().numpy()


def mine_chunked(db, budget_bytes: int = 1 << 28, threshold: int | None = None,
                 codec: str = "bit", backend: str = "auto",
                 n_buckets_log2: int = 22, fuse_duration: bool = False,
                 bucket_days: int = 30, with_counts: bool = False,
                 device="cuda") -> dict:
    """In-memory chunked mining (+ optional global hash screen).

    Returns flat numpy arrays {seq, dur, patient} of the real rows of all
    chunks, concatenated, with an all-true 'mask' (each chunk is compacted
    on ``device``); plus 'keep' when screening and 'counts' (the merged
    bucket table) when screening or ``with_counts``.
    """
    chunks = plan_chunks(np.asarray(db.nevents), budget_bytes)
    parts = []
    counts = None
    for ch in chunks:
        mined = _mine_chunk(db, ch, device, codec, backend, fuse_duration,
                            bucket_days)
        if threshold is not None or with_counts:
            c = sparsity.local_bucket_counts(mined.seq, mined.mask, n_buckets_log2)
            counts = c if counts is None else sparsity.merge_bucket_counts(counts, c)
        parts.append(tuple(a.cpu().numpy() for a in real_rows(mined, ch.start)))
        del mined
    out = {"seq": _cat(parts, 0, np.int64), "dur": _cat(parts, 1, np.int32),
           "patient": _cat(parts, 2, np.int32)}
    del parts
    out["mask"] = np.ones(len(out["seq"]), bool)
    if threshold is not None or with_counts:
        out["counts"] = _host_counts(counts, n_buckets_log2)
    if threshold is not None:
        out["keep"] = sparsity.screen_hash_from_counts(
            out["seq"], out["mask"], out["counts"], threshold,
            n_buckets_log2).numpy()
    return out


def mine_fused(db, threshold: int, budget_bytes: int = 1 << 28,
               codec: str = "bit", backend: str = "auto",
               n_buckets_log2: int = 20, fuse_duration: bool = False,
               bucket_days: int = 30, device="cuda") -> dict:
    """Screen-then-materialize: corpus-free counting, survivors-only rows.

    Pass 1 builds the global [2^H] bucket table with the fused mine+screen
    kernel (``kernels/tspm_fused``) — no [P, n, n] corpus exists during the
    screen.  Pass 2 re-mines chunk by chunk under ``budget_bytes`` and
    keeps each chunk's survivors on the device, so the only pair
    allocations are one chunk slab at a time and the survivors themselves.
    Byte-identical to mine + hash screen (keeping is per id).

    Returns compacted numpy {seq, dur, patient} (every row real) plus the
    global 'counts' table.
    """
    from repro_torch.kernels.tspm_fused import ops as fused_ops

    args = (torch.as_tensor(a, dtype=torch.int32).to(device)
            for a in (db.phenx, db.date, db.nevents))
    counts = fused_ops.fused_bucket_counts(
        *args, codec=codec, fuse_duration=fuse_duration,
        bucket_days=bucket_days, n_buckets_log2=n_buckets_log2,
        backend=backend)
    parts = []
    for ch in plan_chunks(np.asarray(db.nevents), budget_bytes):
        mined = _mine_chunk(db, ch, device, codec, backend, fuse_duration,
                            bucket_days)
        seq, dur, pat = real_rows(mined, ch.start)
        del mined
        parts.append(sparsity.screen_survivors(
            seq, dur, pat, counts, threshold, n_buckets_log2,
            mask=torch.ones_like(seq, dtype=torch.bool)))
        del seq, dur, pat        # before the next chunk's slab is mined
    return {"seq": _cat(parts, 0, np.int64), "dur": _cat(parts, 1, np.int32),
            "patient": _cat(parts, 2, np.int32), "counts": counts.cpu().numpy()}


def mine_to_files(db, out_dir: str, budget_bytes: int = 1 << 28,
                  codec: str = "bit", backend: str = "auto",
                  n_buckets_log2: int = 22, fuse_duration: bool = False,
                  bucket_days: int = 30, device="cuda") -> list[str]:
    """File-based mode: one .npz per chunk + a merged bucket-count table."""
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(out_dir):   # stale spill from a previous cohort
        if name.startswith("chunk_") or name == "bucket_counts.npy":
            os.remove(os.path.join(out_dir, name))
    paths = []
    counts = None
    for k, ch in enumerate(plan_chunks(np.asarray(db.nevents), budget_bytes)):
        mined = _mine_chunk(db, ch, device, codec, backend, fuse_duration,
                            bucket_days)
        c = sparsity.local_bucket_counts(mined.seq, mined.mask, n_buckets_log2)
        counts = c if counts is None else sparsity.merge_bucket_counts(counts, c)
        seq, dur, pat = (a.cpu().numpy() for a in real_rows(mined, ch.start))
        del mined
        path = os.path.join(out_dir, f"chunk_{k:05d}.npz")
        np.savez(path, seq=seq, dur=dur, patient=pat)
        paths.append(path)
    np.save(os.path.join(out_dir, "bucket_counts.npy"),
            _host_counts(counts, n_buckets_log2))
    return paths


def _chunk_files(out_dir: str) -> list[str]:
    return [os.path.join(out_dir, name) for name in sorted(os.listdir(out_dir))
            if name.startswith("chunk_")]


def load_files(out_dir: str) -> dict:
    """Read a spill directory back unscreened: flat compacted {seq, dur,
    patient} arrays (every row real — spills drop padding) + the merged
    'counts' table.  The screening twin of this loader is
    :func:`screen_files`; the session's file engine uses this one so a
    threshold can still be applied (and re-applied) lazily."""
    counts = np.load(os.path.join(out_dir, "bucket_counts.npy"))
    parts = []
    for path in _chunk_files(out_dir):
        with np.load(path) as z:
            parts.append((z["seq"], z["dur"], z["patient"]))
    return {"seq": _cat(parts, 0, np.int64), "dur": _cat(parts, 1, np.int32),
            "patient": _cat(parts, 2, np.int32), "counts": counts}


def screen_files(out_dir: str, threshold: int,
                 n_buckets_log2: int = 22) -> Iterable[dict]:
    """Stream chunks back, applying the merged global count table."""
    counts = np.load(os.path.join(out_dir, "bucket_counts.npy"))
    for path in _chunk_files(out_dir):
        with np.load(path) as z:
            seq, dur, pat = z["seq"], z["dur"], z["patient"]
        keep = sparsity.screen_hash_from_counts(
            seq, np.ones(seq.shape, bool), counts, threshold,
            n_buckets_log2).numpy()
        yield {"seq": seq[keep], "dur": dur[keep], "patient": pat[keep]}
