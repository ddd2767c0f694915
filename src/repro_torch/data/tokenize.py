"""Clinical event streams -> LM token corpora.

The bridge between the paper's mined world and the model zoo: each patient
becomes a document of interleaved phenX tokens and time-gap bucket tokens
(the tSPM+ duration dimension, kept in-band so the LM sees it), packed into
fixed-length training sequences.

Token map:  0 PAD | 1 BOS | 2 EOS | 3 SEP | 4..4+G gap buckets | G+4.. phenX
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.dbmart import DBMart

PAD, BOS, EOS, SEP = 0, 1, 2, 3
N_GAP_BUCKETS = 16
PHENX_OFFSET = 4 + N_GAP_BUCKETS


def gap_bucket(days: np.ndarray) -> np.ndarray:
    """log2-ish day-gap buckets: 0, 1, 2-3, 4-7, ... capped."""
    d = np.maximum(np.asarray(days, np.int64), 0)
    b = np.where(d == 0, 0, np.floor(np.log2(np.maximum(d, 1))).astype(np.int64) + 1)
    return np.minimum(b, N_GAP_BUCKETS - 1).astype(np.int32)


@dataclasses.dataclass
class Corpus:
    tokens: np.ndarray      # [n_seq, seq_len] int32
    loss_mask: np.ndarray   # [n_seq, seq_len] bool — False on PAD
    vocab_size: int


def patient_documents(db: DBMart) -> list[np.ndarray]:
    docs = []
    for p in range(db.n_patients):
        n = int(db.nevents[p])
        if n == 0:
            continue
        toks = [BOS, PHENX_OFFSET + int(db.phenx[p, 0])]
        for i in range(1, n):
            gap = int(db.date[p, i]) - int(db.date[p, i - 1])
            toks.append(4 + int(gap_bucket(gap)))
            toks.append(PHENX_OFFSET + int(db.phenx[p, i]))
        toks.append(EOS)
        docs.append(np.asarray(toks, np.int32))
    return docs


def pack_corpus(db: DBMart, seq_len: int, vocab_size: int | None = None) -> Corpus:
    """Greedy document packing into [n_seq, seq_len] with SEP boundaries."""
    docs = patient_documents(db)
    stream: list[np.ndarray] = []
    for d in docs:
        stream.append(d)
        stream.append(np.asarray([SEP], np.int32))
    flat = np.concatenate(stream) if stream else np.zeros(0, np.int32)
    n_seq = max(1, -(-len(flat) // seq_len))
    padded = np.full(n_seq * seq_len, PAD, np.int32)
    padded[: len(flat)] = flat
    tokens = padded.reshape(n_seq, seq_len)
    if vocab_size is None:
        vocab_size = PHENX_OFFSET + (db.vocab.n_phenx if db.vocab else int(db.phenx.max()) + 1)
    return Corpus(tokens, tokens != PAD, vocab_size)


def lm_batches(corpus: Corpus, batch_size: int, seed: int = 0):
    """Infinite shuffled batch iterator of (tokens, labels, mask).

    labels are next-token; last position predicts PAD and is masked out."""
    rng = np.random.default_rng(seed)
    n = corpus.tokens.shape[0]
    while True:
        idx = rng.integers(0, n, batch_size)
        t = corpus.tokens[idx]
        labels = np.concatenate([t[:, 1:], np.full((batch_size, 1), PAD, np.int32)], 1)
        mask = corpus.loss_mask[idx] & (labels != PAD)
        yield {"tokens": t, "labels": labels, "loss_mask": mask}
