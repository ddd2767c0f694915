"""Delta-of-timestamp + varint block codec for patient history blocks.

Clinical event streams are monotone timestamps over a small code
vocabulary — the shape vertical-list temporal-pattern representations
exploit — so a history ``(phenx, date)`` compresses hard under

  * **delta-of-timestamp**: dates are non-decreasing day integers, so
    consecutive differences are tiny (mostly 0-30) and varint-encode to
    one byte each where the raw plane spends four;
  * **zigzag varints**: LEB128 with the sign bit folded into bit 0, so
    the codec stays *exact for any int32 input* — unsorted dates,
    negative deltas, adversarial codes — not just the happy clinical
    shape.  Exact roundtrip is the invariant every tier above relies on
    (``decode_block(encode_block(p, d)) == (p, d)`` byte-for-byte);
  * an optional **small-vocab dictionary**: codes ranked by frequency map
    to dense indices (frequent code -> 1-byte varint); codes outside the
    dictionary escape to a side stream, so a dictionary built on one
    cohort slice never breaks encoding of the next.

Block layout (all varints LEB128, little-endian 7-bit groups)::

    u8 version | u8 flags | varint n
    varint len(date_stream)   | date_stream  (zigzag deltas, first from 0)
    varint len(code_stream)   | code_stream  (zigzag codes, or dict ranks)
    [flags&1] varint len(escape_stream) | escape_stream (zigzag raw codes)

Encoding and decoding are numpy-vectorized (byte matrices, no per-event
python loop), so the codec sustains disk-tier demotion and restore at
ingest rates, not pickle rates.
"""
from __future__ import annotations

import numpy as np

VERSION = 1
FLAG_DICT = 1

_SHIFTS = np.arange(5, dtype=np.uint64) * np.uint64(7)


def zigzag_encode(v: np.ndarray) -> np.ndarray:
    """int -> unsigned, small magnitudes (either sign) stay small."""
    v = np.asarray(v, np.int64)
    return ((v << 1) ^ (v >> 63)).astype(np.uint64)


def zigzag_decode(u: np.ndarray) -> np.ndarray:
    u = np.asarray(u, np.uint64)
    return ((u >> np.uint64(1)).astype(np.int64)
            ^ -(u & np.uint64(1)).astype(np.int64))


def varint_encode(values: np.ndarray) -> bytes:
    """LEB128-encode a uint array (each value < 2^35, enough for zigzagged
    int32) into one bytes blob; vectorized over a [n, 5] byte matrix."""
    v = np.asarray(values, np.uint64)
    if v.size == 0:
        return b""
    if v.size and int(v.max()) >> 35:
        raise ValueError("varint_encode: value exceeds 35-bit budget")
    groups = (v[:, None] >> _SHIFTS) & np.uint64(0x7F)
    groups = groups.astype(np.uint8)
    # bytes needed per value: index of the last non-zero 7-bit group
    used = np.maximum((groups != 0) * (np.arange(5) + 1), 1).max(axis=1)
    keep = np.arange(5)[None, :] < used[:, None]
    cont = np.arange(5)[None, :] < (used - 1)[:, None]   # continuation bit
    groups = np.where(cont, groups | 0x80, groups)
    return groups[keep].tobytes()


def varint_decode(buf, count: int) -> np.ndarray:
    """Decode ``count`` LEB128 varints from ``buf`` -> uint64 array."""
    if count == 0:
        return np.zeros(0, np.uint64)
    b = np.frombuffer(buf, np.uint8)
    ends = np.flatnonzero((b & 0x80) == 0)
    if len(ends) < count:
        raise ValueError("varint_decode: truncated stream")
    ends = ends[:count]
    starts = np.concatenate([[0], ends[:-1] + 1])
    if (ends - starts >= 5).any():
        raise ValueError("varint_decode: varint wider than 5 bytes")
    idx = starts[:, None] + np.arange(5)[None, :]
    valid = idx <= ends[:, None]
    groups = b[np.minimum(idx, len(b) - 1)].astype(np.uint64) & np.uint64(0x7F)
    return ((groups << _SHIFTS) * valid).sum(axis=1, dtype=np.uint64)


class CodeDictionary:
    """Frequency-ranked code -> dense-index map for the phenx stream.

    Built once per store (or per cohort) from observed code counts; a
    code outside the dictionary escapes to a side stream, so the map is
    an optimization, never a correctness dependency.  JSON-serializable
    (the blockstore index persists it next to the blocks).
    """

    def __init__(self, codes):
        self.codes = [int(c) for c in codes]          # rank -> code
        self.index = {c: i for i, c in enumerate(self.codes)}

    @classmethod
    def from_counts(cls, codes, counts, max_size: int = 4096
                    ) -> "CodeDictionary":
        order = np.argsort(np.asarray(counts))[::-1][:max_size]
        return cls(np.asarray(codes)[order])

    @classmethod
    def from_histories(cls, code_arrays, max_size: int = 4096
                       ) -> "CodeDictionary":
        flat = (np.concatenate([np.asarray(a).reshape(-1)
                                for a in code_arrays])
                if len(code_arrays) else np.zeros(0, np.int64))
        codes, counts = np.unique(flat, return_counts=True)
        return cls.from_counts(codes, counts, max_size)

    def to_json(self) -> list:
        return self.codes

    @classmethod
    def from_json(cls, obj) -> "CodeDictionary":
        return cls(obj)

    def __len__(self) -> int:
        return len(self.codes)

    def __eq__(self, other) -> bool:
        return isinstance(other, CodeDictionary) and self.codes == other.codes


def _rank_streams(phenx: np.ndarray, dictionary: CodeDictionary):
    """(rank stream, escape stream): rank r+1 for dictionary codes, 0 as
    the escape marker, escaped raw codes side-streamed in order."""
    ranks = np.asarray([dictionary.index.get(int(c), -1) for c in phenx],
                       np.int64)
    escaped = phenx[ranks < 0]
    return np.where(ranks >= 0, ranks + 1, 0).astype(np.uint64), escaped


def encode_block(phenx, date, dictionary: CodeDictionary | None = None
                 ) -> bytes:
    """Encode one patient history to a self-describing compressed block."""
    phenx = np.asarray(phenx, np.int64).reshape(-1)
    date = np.asarray(date, np.int64).reshape(-1)
    if len(phenx) != len(date):
        raise ValueError("phenx/date length mismatch")
    n = len(phenx)
    deltas = np.diff(date, prepend=0)
    date_stream = varint_encode(zigzag_encode(deltas))
    flags = 0
    parts = []
    if dictionary is not None and len(dictionary):
        flags |= FLAG_DICT
        ranks, escaped = _rank_streams(phenx, dictionary)
        code_stream = varint_encode(ranks)
        escape_stream = varint_encode(zigzag_encode(escaped))
        parts = [varint_encode([len(code_stream)]), code_stream,
                 varint_encode([len(escape_stream)]), escape_stream]
    else:
        code_stream = varint_encode(zigzag_encode(phenx))
        parts = [varint_encode([len(code_stream)]), code_stream]
    head = bytes([VERSION, flags]) + varint_encode([n]) \
        + varint_encode([len(date_stream)]) + date_stream
    return head + b"".join(parts)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def varint(self) -> int:
        out = shift = 0
        while True:
            if self.pos >= len(self.buf):
                raise ValueError("decode_block: truncated header")
            byte = self.buf[self.pos]
            self.pos += 1
            out |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return out
            shift += 7

    def take(self, n: int):
        out = self.buf[self.pos: self.pos + n]
        if len(out) != n:
            raise ValueError("decode_block: truncated stream")
        self.pos += n
        return out


def decode_block(blob, dictionary: CodeDictionary | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Exact inverse of :func:`encode_block` -> int32 ``(phenx, date)``."""
    r = _Reader(blob)
    version = r.buf[r.pos]
    r.pos += 1
    if version != VERSION:
        raise ValueError(f"unknown block version {version}")
    flags = r.buf[r.pos]
    r.pos += 1
    n = r.varint()
    deltas = zigzag_decode(varint_decode(r.take(r.varint()), n))
    date = np.cumsum(deltas, dtype=np.int64)
    if flags & FLAG_DICT:
        if dictionary is None:
            raise ValueError("block was dictionary-encoded; pass the "
                             "dictionary it was written with")
        ranks = varint_decode(r.take(r.varint()), n).astype(np.int64)
        n_escaped = int((ranks == 0).sum())
        escaped = zigzag_decode(
            varint_decode(r.take(r.varint()), n_escaped))
        lut = np.asarray(dictionary.codes + [0], np.int64)
        phenx = lut[np.where(ranks > 0, ranks - 1, len(dictionary))]
        phenx[ranks == 0] = escaped
    else:
        phenx = zigzag_decode(varint_decode(r.take(r.varint()), n))
    return phenx.astype(np.int32), date.astype(np.int32)


def raw_bytes(n_events: int) -> int:
    """Uncompressed host footprint of a history: two int32 planes."""
    return 8 * int(n_events)


# --- patient-key serialization ---------------------------------------------
# Checkpoints and the blockstore index are JSON; python dict keys there
# must round-trip *typed* (an int key decoded as str would silently fork a
# patient).  Keys are tagged s-expressions: int / str / tuples thereof.

def encode_key(key) -> list:
    if isinstance(key, (bool,)):   # bool is an int subclass; reject early
        raise TypeError("bool patient keys are not serializable")
    if isinstance(key, (int, np.integer)):
        return ["i", int(key)]
    if isinstance(key, str):
        return ["s", key]
    if isinstance(key, tuple):
        return ["t", [encode_key(k) for k in key]]
    raise TypeError(f"patient key {key!r} ({type(key).__name__}) is not "
                    "serializable; use int, str, or tuples thereof")


def decode_key(obj):
    tag, val = obj
    if tag == "i":
        return int(val)
    if tag == "s":
        return val
    if tag == "t":
        return tuple(decode_key(v) for v in val)
    raise ValueError(f"unknown key tag {tag!r}")
