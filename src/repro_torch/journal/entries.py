"""Typed journal entries: a self-describing binary framing.

One entry = one session event (or journal bookkeeping record), framed
as::

    uvarint(len(header))  header-json  [uvarint(len(part)) part]*

The header is canonical JSON (sorted keys, no whitespace) carrying the
entry kind, its scalar fields, and descriptors for the binary parts
that follow — named arrays (raw little-endian bytes + dtype/shape;
int64 corpus ids round-trip exactly where the 35-bit zigzag-varint
codec could not, and raw ``tobytes`` keeps delta entries off the
pure-python varint encoder, whose cost alone would blow the journaling
overhead budget) and named opaque blobs.  Canonical framing matters
more than compactness: the hash chain and the replay shadow comparison
both operate on entry *bytes*, so two encodings of the same logical
entry must be byte-identical.

Patient keys serialize through ``storage.codec.encode_key`` (tagged
s-expressions), the same typed round-trip checkpoints use.
"""
from __future__ import annotations

import hashlib
import json
import struct

import numpy as np

from repro_torch.storage import codec as codec_lib

#: journal format version (open-entry field; bump on framing changes)
FORMAT_VERSION = 1

#: chain genesis: the "previous hash" of the first entry
GENESIS = b"\x00" * 32

#: every entry kind, in a stable order
ENTRY_KINDS = ("open", "delta", "tick", "evict", "migrate", "rebalance",
               "checkpoint", "commit")

#: kinds the replay shadow stream must reproduce byte-for-byte; the
#: rest (open / rebalance / checkpoint) are session metadata — their
#: *effects* are already covered by the migrate/tick entries around them
REPLAYED_KINDS = frozenset({"delta", "tick", "evict", "migrate", "commit"})


def uvarint(n: int) -> bytes:
    """LEB128 length prefix (unsigned)."""
    if n < 0:
        raise ValueError("uvarint is unsigned")
    if n < 0x80:
        return bytes((n,))
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


class Reader:
    """Cursor over one entry (or segment) buffer."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def eof(self) -> bool:
        return self.pos >= len(self.buf)

    def uvarint(self) -> int:
        n = shift = 0
        while True:
            if self.pos >= len(self.buf):
                raise ValueError("truncated uvarint")
            b = self.buf[self.pos]
            self.pos += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated entry payload")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out


def encode_entry(kind: str, fields: dict | None = None,
                 arrays: dict | None = None,
                 blobs: dict | None = None) -> bytes:
    """Frame one entry (see module doc).  ``fields`` must be JSON-safe;
    binary parts are emitted in sorted-name order (canonical bytes)."""
    if kind not in ENTRY_KINDS:
        raise ValueError(f"unknown entry kind {kind!r}")
    arrays = arrays or {}
    blobs = blobs or {}
    hdr = {"k": kind, "f": fields or {}}
    parts: list[bytes] = []
    if arrays:
        hdr["a"] = []
        for name in sorted(arrays):
            arr = np.ascontiguousarray(arrays[name])
            hdr["a"].append([name, arr.dtype.str, list(arr.shape)])
            parts.append(arr.tobytes())
    if blobs:
        hdr["b"] = sorted(blobs)
        parts.extend(bytes(blobs[name]) for name in sorted(blobs))
    hj = json.dumps(hdr, sort_keys=True, separators=(",", ":")).encode()
    return b"".join([uvarint(len(hj)), hj]
                    + [uvarint(len(p)) + p for p in parts])


def decode_entry(buf: bytes) -> tuple[str, dict, dict, dict]:
    """Exact inverse of :func:`encode_entry` ->
    ``(kind, fields, arrays, blobs)``."""
    r = Reader(buf)
    hdr = json.loads(r.take(r.uvarint()))
    arrays: dict = {}
    for name, dtype, shape in hdr.get("a", []):
        raw = r.take(r.uvarint())
        arrays[name] = np.frombuffer(raw, dtype=np.dtype(dtype)) \
            .reshape(shape).copy()
    blobs = {name: r.take(r.uvarint()) for name in hdr.get("b", [])}
    if not r.eof():
        raise ValueError("trailing bytes after entry payload")
    return hdr["k"], hdr["f"], arrays, blobs


def entry_kind(buf: bytes) -> str:
    """Kind without decoding the payload."""
    r = Reader(buf)
    return json.loads(r.take(r.uvarint()))["k"]


def chain_hash(prev: bytes, entry: bytes) -> bytes:
    """``h_i = sha256(h_{i-1} || entry_bytes)`` — the append-only link."""
    return hashlib.sha256(prev + entry).digest()


# --- event payload helpers ---------------------------------------------------

def pack_state(state) -> tuple[dict, dict]:
    """A PatientState as (fields, arrays) — full fidelity, for external
    admits the replayer must reproduce from the journal alone."""
    return ({"key": codec_lib.encode_key(state.key)},
            {"phenx": np.asarray(state.phenx, np.int32),
             "date": np.asarray(state.date, np.int32),
             "seq_ids": np.asarray(state.seq_ids, np.int64),
             "corpus_seq": np.asarray(state.corpus_seq, np.int64),
             "corpus_dur": np.asarray(state.corpus_dur, np.int32)})


def unpack_state(fields: dict, arrays: dict):
    from repro_torch.stream.service import PatientState
    return PatientState(
        codec_lib.decode_key(fields["key"]),
        np.asarray(arrays["phenx"], np.int32),
        np.asarray(arrays["date"], np.int32),
        np.asarray(arrays["seq_ids"], np.int64),
        np.asarray(arrays["corpus_seq"], np.int64),
        np.asarray(arrays["corpus_dur"], np.int32))


def state_digest(state) -> str:
    """Content digest of a PatientState — internal migrations journal
    this instead of the full payload (replay re-derives the state; the
    digest pins that it re-derived the *same* state)."""
    h = hashlib.sha256()
    h.update(json.dumps(codec_lib.encode_key(state.key)).encode())
    for name, dt in (("phenx", np.int32), ("date", np.int32),
                     ("seq_ids", np.int64), ("corpus_seq", np.int64),
                     ("corpus_dur", np.int32)):
        h.update(np.ascontiguousarray(
            getattr(state, name), dtype=dt).tobytes())
    return h.digest()[:16].hex()


#: golden-ratio / murmur-style odd constants for the vectorized fold
_K1 = np.uint64(0x9E3779B97F4A7C15)
_K2 = np.uint64(0xC2B2AE3D27D4EB4F)


def _fold64(arr) -> int:
    """Value-sensitive 64-bit fold of one integer array in three
    vectorized passes (wrapping uint64 arithmetic is deterministic).
    The fold is multiset-shaped — any changed *value* flips it w.h.p.;
    order sensitivity is the merkle commitment's job."""
    x = np.ascontiguousarray(arr, dtype=np.int64).view(np.uint64)
    with np.errstate(over="ignore"):
        acc = np.add.reduce((x ^ _K1) * _K2) if x.size else np.uint64(0)
        return int(acc ^ (np.uint64(x.size) * _K1))


def wave_digest(keys, slot_idx, seq, dur) -> str:
    """Digest of one tick's mined delta feed — the tick entry pins it so
    a divergent replay is caught *at the tick*, not at the next merkle
    commitment.

    The arrays fold through :func:`_fold64` rather than sha256: the
    verifier recomputes this digest from the journal's *delta entries*
    (the ground truth), so a forged journal must be internally
    consistent to pass — and an internally-consistent forgery is caught
    by the sha256 merkle commitment at the window boundary, or by the
    against-live comparison.  Collision resistance therefore buys
    nothing at the tick level; sensitivity does, and the vectorized
    fold keeps per-tick journaling off the mining hot path."""
    h = hashlib.sha256()
    for k in keys:
        h.update(json.dumps(codec_lib.encode_key(k)).encode())
        h.update(b"\x00")
    h.update(struct.pack("<QQQ", _fold64(slot_idx), _fold64(seq),
                         _fold64(dur)))
    return h.digest()[:16].hex()
