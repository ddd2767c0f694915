"""Adaptive dbmart partitioning + file-based mining (the paper's two modes).

The R package "split[s] the dbmart in chunks with an adaptive size to fit
the available memory limitations", and the C++ library has a *file-based*
mode that spills per-patient sequence files.  Here the same two ideas govern
device memory:

  * ``plan_chunks`` — greedy patient ranges such that the mining working set
    ``P_chunk * E_chunk^2 * BYTES_PER_PAIR`` fits the byte budget;
    per-chunk ``E`` adapts to the longest patient in the chunk (padded to a
    tile multiple), so short-history chunks pack many more patients.  It
    is the reference's plan, and the CPU's.
  * ``plan_card_chunks`` — the card's plan: it prices what the card holds
    for one dense chunk (slab, tables, and the scratch of one piece of the
    slab, which every pass after the mine works through a piece at a
    time), so ``budget_bytes`` bounds the card's peak.
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
chunk, so the rows and their order do not depend on where the chunk
boundaries fall: the card's smaller chunks give the CPU's rows.
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

# --- the price of one chunk on the card -------------------------------------
# The card mines the dense [P, E, E] layout (factor 1.0), whatever the
# screen.  What it holds for one chunk, besides the [2^H] count tables:
#
#   * the slab the pair kernel writes: 8 B id + 4 B duration + 1 B mask
#     = 13 B a padded slot, and the chunk's event planes, 8 B an event slot
#     (phenx, date) + 4 B a patient (nevents);
#   * the scratch of one pass over one *piece* of the slab (a run of
#     patient rows; every pass after the mine works a piece at a time):
#     - hash counts, at the row sort (torch's segmented sort of int64 keys
#       by one full cub radix sort): the masked id copy 8 B, the sort's
#       values and indices 16 B, its two int2 (index, segment) buffers
#       16 B, cub's key output 8 B and cub's alternate key and value
#       buffers 16 B = 64 B;
#     - compaction (``real_rows``): at most half the slots are real
#       (i < j); a real row holds its int64 index 8 B, two int64 patient
#       temporaries 16 B, the int32 patient 4 B and the gathered id and
#       duration 12 B = 40 B, so 20 B a slot of the piece;
#     - the survivors' screen (``screen="fused"``): beside those 20 B of
#       rows, the hash's int64 temporaries 24 B, the table gather 4 B, the
#       keep flags 1 B, the kept index 8 B and the kept rows 16 B a real
#       row = 53 B, so 47 B a slot of the piece;
#     so 64 B a slot of the piece bounds every pass.  Measured on an H100
#     (card_probe.py scratch): the hash counts of 64 rows of 304^2 slots
#     took 64 B a slot + 7.00 MiB, the sort's 7 buffers each rounded up
#     (below); compaction 11.1 B and survivors 7.3 B a slot;
#   * the caching allocator's rounding (``alloc_over``), sized from the
#     chunk's own tensors in ``ChunkPlan.chunk_bytes``;
#   * the small tensors of each pass (cursors, flags, scalars).
CARD_SLAB_BYTES = 13
CARD_SCRATCH_BYTES = 64
CARD_SMALL_BYTES = 64 << 10     # 128 small tensors of 512 B
# piece-sized tensors live at once in the worst pass: the survivors'
# screen's 3 rows, 3 hash temporaries, table gather, keep flags, kept
# index and 3 kept rows (the row sort has 7), each at most 8 B a slot
CARD_PIECE_TENSORS = 12
# Share of the budget (after tables and small tensors) that one piece's
# scratch may take; the rest holds the slab.  At Table 2 and 4 GiB, shares
# 1/16-1/2 gave 7-12 chunks and device passes (mine, counts, compaction)
# of 0.48-0.58 s against fits of 5.6-8.9 s (card_probe.py share, H100):
# the split moves about 1% of the fit; a quarter keeps chunks near the
# fewest.
CARD_SCRATCH_SHARE = 0.25
# [2^H] int32 count tables alive at once: the merged table, a chunk's table,
# a block's histogram and the sum being formed
CARD_TABLES = 4

# PyTorch's caching allocator rounds a request of at most 1 MiB up to
# 512 B; a larger one is cut from a large block, which it hands out whole
# when what would be left is 1 MiB or less (its split rule), so the
# tensor may be charged up to 1 MiB above its size.
ALLOC_SMALL_MAX = 1 << 20
ALLOC_SMALL_ROUND = 512
ALLOC_LARGE_OVER = 1 << 20


def alloc_over(nbytes: int) -> int:
    """The most the caching allocator may charge above a tensor of
    ``nbytes``."""
    return ALLOC_LARGE_OVER if nbytes > ALLOC_SMALL_MAX else ALLOC_SMALL_ROUND


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


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """Chunks plus the piece size of the passes that follow each mine.

    ``piece_slots`` is the number of slab slots the hash counts and the
    compaction work on at a time (whole patient rows, at least one);
    ``None`` means the whole chunk, which is what the CPU does, as the
    reference does."""

    chunks: list[Chunk]
    piece_slots: int | None = None
    table_bytes: int = 0        # one [2^H] int32 count table

    def piece_rows(self, ch: Chunk) -> int:
        if self.piece_slots is None:
            return max(ch.n_patients, 1)
        return max(1, self.piece_slots // max(ch.max_events ** 2, 1))

    def chunk_bytes(self, ch: Chunk) -> int:
        """The card's reckoned peak for ``ch``: tables, small tensors, slab,
        event planes and one piece's scratch (see ``CARD_SCRATCH_BYTES``),
        each tensor with the allocator's rounding (``alloc_over``)."""
        n, e = ch.n_patients, ch.max_events
        slots, piece = n * e * e, min(self.piece_rows(ch), n) * e * e
        held = (CARD_TABLES * self.table_bytes + CARD_SMALL_BYTES
                + n * (e * e * CARD_SLAB_BYTES + 8 * e + 4)
                + piece * CARD_SCRATCH_BYTES)
        over = (sum(alloc_over(b * slots) for b in (8, 4, 1))
                + 2 * alloc_over(4 * n * e) + alloc_over(4 * n)
                + CARD_TABLES * alloc_over(self.table_bytes)
                + CARD_PIECE_TENSORS * alloc_over(8 * piece))
        return held + over


def plan_card_chunks(nevents: np.ndarray, budget_bytes: int,
                     n_buckets_log2: int, pad_multiple: int = 8) -> ChunkPlan:
    """Greedy patient chunks whose card peak fits ``budget_bytes``.

    The tables and the small tensors are reserved first; a quarter of what
    is left is the scratch of one piece (at most ``sparsity.BLOCK_ELEMENTS``
    slots); the rest holds the chunk's slab, its event planes and the
    allocator's rounding.  Every chunk's
    ``ChunkPlan.chunk_bytes`` is within the budget, except a chunk of a
    single patient whose own slab does not fit (a patient is never split).
    Rows stay in patient order, chunk after chunk, so the rows and their
    order do not depend on the plan."""
    nevents = np.asarray(nevents)
    table = 4 << n_buckets_log2
    spare = max(budget_bytes - CARD_TABLES * table - CARD_SMALL_BYTES, 0)
    piece_slots = int(min(sparsity.BLOCK_ELEMENTS,
                          max(1, spare * CARD_SCRATCH_SHARE // CARD_SCRATCH_BYTES)))
    plan = ChunkPlan([], piece_slots, table)

    def pad(n: int) -> int:
        return -(-max(int(n), 1) // pad_multiple) * pad_multiple

    P, i = len(nevents), 0
    while i < P:
        e, j = pad(nevents[i]), i + 1
        while j < P:
            e2 = max(e, pad(nevents[j]))
            if plan.chunk_bytes(Chunk(i, j + 1, e2)) > budget_bytes:
                break
            e, j = e2, j + 1
        plan.chunks.append(Chunk(i, j, e))
        i = j
    return plan


def plan_device_chunks(nevents: np.ndarray, budget_bytes: int, device,
                       n_buckets_log2: int) -> ChunkPlan:
    """The chunk plan of ``device``: the card's pricing for a CUDA device,
    ``plan_chunks`` (the reference's) otherwise."""
    if torch.device(device).type == "cuda":
        return plan_card_chunks(nevents, budget_bytes, n_buckets_log2)
    return ChunkPlan(plan_chunks(np.asarray(nevents), budget_bytes))


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


def _piece(mined: mining.Mined, s: int, rows: int) -> mining.Mined:
    return mining.Mined(*(a[s:s + rows] for a in mined))


def real_pieces(mined: mining.Mined, ch: Chunk, plan: ChunkPlan):
    """The real rows of a mined chunk, one (seq, dur, patient) triple on
    its device a piece of ``plan.piece_rows(ch)`` patient rows; the caller
    drops each piece before asking for the next."""
    rows = plan.piece_rows(ch)
    for s in range(0, ch.n_patients, rows):
        yield real_rows(_piece(mined, s, rows), ch.start + s)


def host_rows(mined: mining.Mined, ch: Chunk, plan: ChunkPlan):
    """:func:`real_pieces` copied to host numpy, each piece freed on the
    device before the next is compacted."""
    for piece in real_pieces(mined, ch, plan):
        out = tuple(a.cpu().numpy() for a in piece)
        del piece
        yield out


def _counts(mined: mining.Mined, ch: Chunk, plan: ChunkPlan, n_buckets_log2):
    block = (sparsity.BLOCK_ELEMENTS if plan.piece_slots is None
             else plan.piece_rows(ch) * ch.max_events ** 2)
    return sparsity.local_bucket_counts(mined.seq, mined.mask, n_buckets_log2,
                                        block_elements=block)


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
    plan = plan_device_chunks(db.nevents, budget_bytes, device, n_buckets_log2)
    parts = []
    counts = None
    for ch in plan.chunks:
        mined = _mine_chunk(db, ch, device, codec, backend, fuse_duration,
                            bucket_days)
        if threshold is not None or with_counts:
            c = _counts(mined, ch, plan, n_buckets_log2)
            counts = c if counts is None else sparsity.merge_bucket_counts(counts, c)
        parts.extend(host_rows(mined, ch, plan))
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
    plan = plan_device_chunks(db.nevents, budget_bytes, device, n_buckets_log2)
    for ch in plan.chunks:
        mined = _mine_chunk(db, ch, device, codec, backend, fuse_duration,
                            bucket_days)
        for seq, dur, pat in real_pieces(mined, ch, plan):
            parts.append(sparsity.screen_survivors(
                seq, dur, pat, counts, threshold, n_buckets_log2,
                mask=torch.ones_like(seq, dtype=torch.bool)))
            del seq, dur, pat    # before the next piece is compacted
        del mined
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
    plan = plan_device_chunks(db.nevents, budget_bytes, device, n_buckets_log2)
    for k, ch in enumerate(plan.chunks):
        mined = _mine_chunk(db, ch, device, codec, backend, fuse_duration,
                            bucket_days)
        c = _counts(mined, ch, plan, n_buckets_log2)
        counts = c if counts is None else sparsity.merge_bucket_counts(counts, c)
        pieces = list(host_rows(mined, ch, plan))
        del mined
        seq, dur, pat = (_cat(pieces, i, dt) for i, dt in
                         enumerate((np.int64, np.int32, np.int32)))
        del pieces
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
