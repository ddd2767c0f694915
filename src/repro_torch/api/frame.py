"""SequenceFrame: the façade's unified mining result.

Every engine (the port has the batch, chunked, file-based and streaming
ones; the reference also has a sharded one) lands in the same
place: a flat (seq, dur, patient) corpus in a *canonical order*
(lexicographic by sequence id, then patient, then duration), with padding
rows already dropped.  That canonicalization is what makes the conformance
guarantee byte-identical rather than merely set-equal: two engines that
mine the same pairs produce the same arrays, whatever order they touched
patients in.

Mask methods are **chainable and lazily composed**: each returns a new
frame sharing the corpus, with one more predicate appended; nothing is
evaluated until a terminal (``collect``, ``unique``, ``decode``,
``to_features``, ``arrays``, ``n_kept``) forces the composed keep mask.
Predicates see the keep mask accumulated so far, so order matters where it
should — ``.screen(5).transitive_ends_with(x)`` builds its end-set table
from screened sequences only.

The engine's tensors may lie on the card: the frame drops the masked
padding rows there and copies only the real rows to the host, where the
canonical order is a numpy ``lexsort`` (a total order, so its bytes do not
depend on the layout the rows were mined in).

Support is the paper's *distinct-patient* support, computed exactly from
the canonical corpus; ``screen`` applies it directly (mode 'sorted') or
via the engines' shared hash-bucket table (mode 'hash', one-sided error —
both modes are engine-invariant).  Duration-fused ids are first-class: the
frame knows ``fuse_duration`` and routes every unpack-based helper through
the fuse-aware path (core/queries), so ``starts_with`` on a fused corpus
reads phenX codes, not duration bits.
"""
from __future__ import annotations

import threading
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import msmr, queries, sparsity
from repro_torch.core.encoding import Vocab


def _host(x, dtype: torch.dtype, mask=None) -> np.ndarray:
    """A flat host numpy copy of ``x`` (a tensor on any device, or an
    array), keeping only the rows of ``mask`` — selected on ``x``'s own
    device, so padding never crosses to the host."""
    x = torch.as_tensor(x).reshape(-1)
    if mask is not None:
        x = x[torch.as_tensor(mask, device=x.device).reshape(-1)]
    return x.to(dtype).cpu().numpy()


def _t(a: np.ndarray) -> torch.Tensor:
    """Zero-copy CPU tensor view of a host array."""
    return torch.from_numpy(np.ascontiguousarray(a))


class Result(NamedTuple):
    """Kept rows in canonical order + their distinct-patient support."""

    seq: np.ndarray      # [K] int64
    dur: np.ndarray      # [K] int32
    patient: np.ndarray  # [K] int32
    support: np.ndarray  # [K] int32


class Decoded(NamedTuple):
    seq_id: int
    text: str
    support: int


class _Corpus:
    """Shared immutable canonical corpus + lazily-filled caches.

    Chained frames all point at one ``_Corpus``, so support and the hash
    table are computed at most once per mining run, not per mask method.
    Construction copies the engine's real rows to the host (the masked
    padding is dropped on the engine's device first) but defers the
    canonical lexsort until a mask or terminal first needs row access.
    """

    __slots__ = ("n_buckets_log2", "_raw", "_n_rows",
                 "_seq", "_dur", "_patient",
                 "_counts", "_support", "_pair_first",
                 "_prefix_cache", "_lock")

    #: forced-prefix masks kept per corpus before the cache resets — masks
    #: are [N] bools, so even the cap costs well under the corpus itself
    PREFIX_CACHE_MAX = 256

    def __init__(self, seq, dur, patient, mask, counts, n_buckets_log2):
        seq = _host(seq, torch.int64, mask)
        dur = _host(dur, torch.int32, mask)
        patient = _host(patient, torch.int32, mask)
        self._raw = (seq, dur, patient)
        self._n_rows = len(seq)
        self._seq = self._dur = self._patient = None
        self.n_buckets_log2 = n_buckets_log2
        self._counts = None if counts is None else _host(counts, torch.int32)
        self._support = None
        self._pair_first = None
        # keep masks memoized per op-chain prefix: chained frames share
        # their parents' op tuples structurally, so forcing a long chain
        # reuses every already-forced prefix instead of re-running it
        self._prefix_cache: dict[tuple, np.ndarray] = {}
        # several threads may force one corpus; double-checked in
        # _canonicalize so the hot path stays lock-free
        self._lock = threading.Lock()

    def _canonicalize_locked(self) -> None:
        seq, dur, patient = self._raw
        order = np.lexsort((dur, patient, seq))
        # _seq is the published-flag the lock-free fast path checks, so it
        # is assigned last; _raw stays readable for any reader already past
        # the check (it only flips to None after everything is in place)
        self._dur, self._patient = dur[order], patient[order]
        self._seq = seq[order]
        self._raw = None

    def _canonicalize(self) -> None:
        if self._seq is not None:
            return
        with self._lock:
            if self._seq is None:
                self._canonicalize_locked()

    @property
    def seq(self) -> np.ndarray:
        self._canonicalize()
        return self._seq

    @property
    def dur(self) -> np.ndarray:
        self._canonicalize()
        return self._dur

    @property
    def patient(self) -> np.ndarray:
        self._canonicalize()
        return self._patient

    def __len__(self) -> int:
        return self._n_rows

    def pair_first(self) -> np.ndarray:
        """First-occurrence flags of each distinct (seq, patient) pair —
        the per-patient dedup of the paper's support semantics."""
        if self._pair_first is None:
            if len(self.seq) == 0:
                self._pair_first = np.zeros(0, bool)
            else:
                new_seq = np.concatenate(
                    [[True], self.seq[1:] != self.seq[:-1]])
                self._pair_first = new_seq | np.concatenate(
                    [[True], self.patient[1:] != self.patient[:-1]])
        return self._pair_first

    def support(self) -> np.ndarray:
        """Exact distinct-patient support aligned to every corpus row."""
        if self._support is None:
            n = len(self.seq)
            if n == 0:
                self._support = np.zeros(0, np.int32)
            else:
                new_seq = np.concatenate(
                    [[True], self.seq[1:] != self.seq[:-1]])
                seg = np.cumsum(new_seq) - 1
                per_seq = np.bincount(
                    seg[self.pair_first()], minlength=seg[-1] + 1)
                self._support = per_seq[seg].astype(np.int32)
        return self._support

    def counts(self) -> np.ndarray:
        """Hash-bucket support table.  The batch engine hands over the table
        of its hash screen (``sparsity.local_bucket_counts``); frames built
        without one derive the same table here from the canonical corpus."""
        if self._counts is None:
            ids = self.seq[self.pair_first()]
            h = sparsity.hash_bucket(
                torch.from_numpy(ids), self.n_buckets_log2).numpy()
            counts = np.zeros(1 << self.n_buckets_log2, np.int32)
            np.add.at(counts, h, 1)
            self._counts = counts
        return self._counts


def _rank_by_support(ids: np.ndarray, sup: np.ndarray,
                     k: int | None = None) -> np.ndarray:
    """Indices of ``ids`` ordered most-supported first, ties on the smaller
    id — the one deterministic ranking behind ``top_k`` / ``decode`` /
    ``to_features``, so every engine picks the same set."""
    order = np.lexsort((ids, -sup))
    return order if k is None else order[:max(k, 0)]


_Op = tuple[str, Callable]


class SequenceFrame:
    """Chainable view over a mined corpus (see module docstring)."""

    def __init__(self, seq, dur, patient, mask=None, *, vocab: Vocab | None = None,
                 codec: str = "bit", fuse_duration: bool = False,
                 bucket_days: int = 30, n_patients: int | None = None,
                 counts=None, n_buckets_log2: int = 20,
                 screen_mode: str = "sorted", threshold: int | None = None,
                 _corpus: _Corpus | None = None, _ops: tuple[_Op, ...] = ()):
        self._corpus = _corpus if _corpus is not None else _Corpus(
            seq, dur, patient, mask, counts, n_buckets_log2)
        self.vocab = vocab
        self.codec = codec
        self.fuse_duration = fuse_duration
        self.bucket_days = bucket_days
        self._n_patients = int(n_patients) if n_patients is not None else None
        self.screen_mode = screen_mode
        self.threshold = threshold
        self._ops = _ops
        self._keep_cache: np.ndarray | None = None

    @property
    def n_patients(self) -> int:
        if self._n_patients is None:
            c = self._corpus
            self._n_patients = int(c.patient.max()) + 1 if len(c) else 0
        return self._n_patients

    # --- chaining machinery -------------------------------------------------
    def _chain(self, op: _Op) -> "SequenceFrame":
        return SequenceFrame(
            None, None, None, vocab=self.vocab, codec=self.codec,
            fuse_duration=self.fuse_duration, bucket_days=self.bucket_days,
            n_patients=self._n_patients,
            n_buckets_log2=self._corpus.n_buckets_log2,
            screen_mode=self.screen_mode, threshold=self.threshold,
            _corpus=self._corpus, _ops=self._ops + (op,))

    def keep_mask(self) -> np.ndarray:
        """Force the lazily-composed predicate chain; cached per frame,
        and memoized per op-chain *prefix* on the shared corpus: chained
        frames extend their parent's ``_ops`` tuple structurally, so
        ``f.screen()``, ``f.screen().starts_with(x)`` and
        ``f.screen().starts_with(x).top_k(k)`` force each op exactly once
        between them, whichever is evaluated first.  Masks in the cache
        are never mutated (every op composes with ``&`` into a new
        array), so sharing them across frames is safe."""
        if self._keep_cache is None:
            cache = self._corpus._prefix_cache
            n = len(self._ops)
            run_from, keep = 0, None
            for i in range(n, 0, -1):       # longest already-forced prefix
                keep = cache.get(self._ops[:i])
                if keep is not None:
                    run_from = i
                    break
            if keep is None:
                keep = np.ones(len(self._corpus), bool)
            for j in range(run_from, n):
                keep = self._ops[j][1](self, keep)
                if len(cache) >= self._corpus.PREFIX_CACHE_MAX:
                    cache.clear()
                cache[self._ops[:j + 1]] = keep
            self._keep_cache = keep
        return self._keep_cache

    def __repr__(self) -> str:
        ops = ".".join(name for name, _ in self._ops) or "(all)"
        pats = "?" if self._n_patients is None else self._n_patients
        return (f"SequenceFrame({len(self._corpus):,} rows, "
                f"{pats} patients, ops={ops})")

    def __len__(self) -> int:
        return len(self._corpus)

    # --- chainable masks ----------------------------------------------------
    def screen(self, threshold: int | None = None) -> "SequenceFrame":
        """Sparsity screen at distinct-patient ``threshold`` (default: the
        config's).  Mode 'sorted' uses exact support; 'hash' the engines'
        shared bucket table (one-sided: collisions only ever over-keep);
        'fused' frames hold corpus-free-screened survivors and re-screen
        against the same table (idempotent at the fit threshold, exact for
        any higher one)."""
        thr = self.threshold if threshold is None else threshold
        if thr is None:
            raise ValueError("no threshold: pass one or set MiningConfig.threshold")

        def op(fr: "SequenceFrame", keep: np.ndarray) -> np.ndarray:
            if fr.screen_mode in ("hash", "fused"):
                return sparsity.screen_hash_from_counts(
                    _t(fr._corpus.seq), _t(keep), _t(fr._corpus.counts()), thr,
                    fr._corpus.n_buckets_log2).numpy()
            return keep & (fr._corpus.support() >= thr)

        return self._chain((f"screen({thr})", op))

    def starts_with(self, phenx_id: int) -> "SequenceFrame":
        def op(fr, keep):
            return keep & queries.starts_with(
                _t(fr._corpus.seq), phenx_id, fr.codec,
                fused=fr.fuse_duration).numpy()
        return self._chain((f"starts_with({phenx_id})", op))

    def ends_with(self, phenx_id: int) -> "SequenceFrame":
        def op(fr, keep):
            return keep & queries.ends_with(
                _t(fr._corpus.seq), phenx_id, fr.codec,
                fused=fr.fuse_duration).numpy()
        return self._chain((f"ends_with({phenx_id})", op))

    def min_duration(self, days: int) -> "SequenceFrame":
        def op(fr, keep):
            return keep & queries.min_duration(_t(fr._corpus.dur), days).numpy()
        return self._chain((f"min_duration({days})", op))

    def transitive_ends_with(self, start_phenx_id: int) -> "SequenceFrame":
        """Rows whose end phenX ends any *currently-kept* sequence starting
        with ``start_phenx_id`` (the paper's combined helper; chain it after
        ``screen`` to restrict the table to supported sequences)."""
        def op(fr, keep):
            return keep & queries.transitive_ends_with(
                _t(fr._corpus.seq), _t(keep), start_phenx_id, fr.codec,
                fused=fr.fuse_duration).numpy()
        return self._chain((f"transitive_ends_with({start_phenx_id})", op))

    def top_k(self, k: int) -> "SequenceFrame":
        """Keep only the ``k`` most-supported distinct sequence ids among
        currently-kept rows (ties break on the smaller id — deterministic,
        so every engine picks the same set)."""
        def op(fr, keep):
            ids = fr._corpus.seq[keep]
            if len(ids) == 0:
                return keep
            sup = fr._corpus.support()[keep]
            u, idx = np.unique(ids, return_index=True)
            allowed = np.sort(u[_rank_by_support(u, sup[idx], k)])
            if len(allowed) == 0:
                return np.zeros_like(keep)
            pos = np.clip(np.searchsorted(allowed, fr._corpus.seq),
                          0, len(allowed) - 1)
            return keep & (allowed[pos] == fr._corpus.seq)
        return self._chain((f"top_k({k})", op))

    # --- terminals ----------------------------------------------------------
    @property
    def n_kept(self) -> int:
        return int(self.keep_mask().sum())

    def collect(self) -> Result:
        keep = self.keep_mask()
        c = self._corpus
        return Result(c.seq[keep], c.dur[keep], c.patient[keep],
                      c.support()[keep])

    def unique(self) -> tuple[np.ndarray, np.ndarray]:
        """(distinct kept ids sorted ascending, their supports)."""
        keep = self.keep_mask()
        ids = self._corpus.seq[keep]
        u, idx = np.unique(ids, return_index=True)
        return u, self._corpus.support()[keep][idx]

    def decode(self, limit: int | None = None) -> list[Decoded]:
        """Kept distinct sequences as human-readable strings, most-supported
        first (ties on the smaller id).  Needs a vocab on the frame."""
        if self.vocab is None:
            raise ValueError("frame has no vocab; build the session from a "
                             "DBMart with one to decode sequences")
        ids, sup = self.unique()
        order = _rank_by_support(ids, sup, limit)
        texts = self.vocab.decode_sequences(ids[order], self.codec,
                                            fused=self.fuse_duration)
        return [Decoded(int(ids[i]), text, int(sup[i]))
                for i, text in zip(order, texts)]

    def to_features(self, k: int | None = None,
                    feature_ids=None) -> msmr.FeatureMatrix:
        """Patient x sequence binary feature matrix (the MSMR front half):
        features are the kept distinct ids (optionally the ``k`` most
        supported), presence is computed over kept rows only."""
        if feature_ids is None:
            ids, sup = self.unique()
            if k is not None:
                ids = ids[np.sort(_rank_by_support(ids, sup, k))]
            feature_ids = ids
        feature_ids = np.asarray(feature_ids, np.int64).reshape(-1)
        if len(feature_ids) == 0 or self.n_patients == 0:
            return msmr.FeatureMatrix(
                torch.zeros((self.n_patients, len(feature_ids)),
                            dtype=torch.float32),
                _t(feature_ids), torch.tensor(len(feature_ids)))
        return msmr.feature_matrix(
            _t(self._corpus.seq), _t(self._corpus.patient),
            _t(self.keep_mask()), _t(feature_ids),
            n_patients=self.n_patients)

    def arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(seq, dur, patient, keep) over the full canonical corpus — the
        legacy hand-wired interface (core.postcovid et al. take these)."""
        c = self._corpus
        return c.seq, c.dur, c.patient, self.keep_mask()
