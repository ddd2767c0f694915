"""Merkle commitments over live mining state.

A commit entry pins the whole session state at a tick boundary with a
handful of 32-byte roots: per-shard merkle roots over the mined corpus
and the sketch bucket table, plus digests of the router pins and the
global pid table.  Chunked leaves (64 KiB) keep the tree shape
deterministic and let a future fraud-proof protocol open a single chunk
instead of shipping the full table.

The corpus root combines three *per-array* roots (seq, dur, patient)
instead of hashing their concatenation: each array's byte stream is
append-only between commits, so a caller-held leaf cache makes the
commit cost O(new bytes), not O(corpus) — the difference between a
bounded audit tax and one that grows linearly with session age.  The
sketch table mutates in place every tick, so it is always rehashed
(it has a fixed size; the corpus does not).

Everything here is **mutation-free**: commitments read per-shard
snapshots (``StreamService.snapshot`` compacts the corpus log, which is
logically transparent) and never touch the sharded service's
whole-cohort paths — those flush pending migration admits, and a
*reader* advancing the migration schedule would make journaling itself
observable.  At commit time (inside a tick boundary) pending admits are
provably empty anyway — ``tick`` lands them before any wave — and the
commitment records the count to keep that assumption checked.
"""
from __future__ import annotations

import hashlib
import json

import numpy as np

from repro_torch.storage import codec as codec_lib

#: merkle leaf width over array bytes
CHUNK_BYTES = 1 << 16


def _leaf(data) -> bytes:
    # sha256 everywhere (chain, tree, digests): one primitive to audit,
    # and openssl's SHA-NI path is ~2x blake2b on commit-sized tables
    h = hashlib.sha256(b"\x00")
    h.update(data)
    return h.digest()


def _node(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(b"\x01" + left + right).digest()


def merkle_root(data, cache: list | None = None) -> bytes:
    """Root over 64 KiB chunks (odd nodes promote a level unchanged).

    ``data`` is any bytes-like (a zero-copy memoryview works).  With
    ``cache`` (a list the *caller* owns), leaf hashes of full chunks are
    reused and extended in place; the caller guarantees the cached
    prefix of ``data`` is unchanged since the leaves were computed —
    appends only.  The trailing partial chunk is always rehashed and
    never cached."""
    n_full = len(data) // CHUNK_BYTES
    if cache is None:
        cache = []
    elif len(cache) > n_full:
        del cache[n_full:]
    for i in range(len(cache), n_full):
        cache.append(_leaf(data[i * CHUNK_BYTES:(i + 1) * CHUNK_BYTES]))
    level = list(cache)
    tail = data[n_full * CHUNK_BYTES:]
    if len(tail) or not level:
        level.append(_leaf(tail))
    while len(level) > 1:
        nxt = [_node(level[i], level[i + 1])
               for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def _keys_digest(pairs) -> str:
    """Digest over an iterable of (encoded-key-json-able, int) pairs in
    iteration order (dict insertion order is state here: pid numbering
    and router pins are both order-sensitive)."""
    h = hashlib.sha256()
    for k, v in pairs:
        h.update(json.dumps(codec_lib.encode_key(k)).encode())
        h.update(int(v).to_bytes(8, "little", signed=True))
    return h.digest()[:16].hex()


def _array_root(arr, dtype, cache: list | None) -> bytes:
    a = np.ascontiguousarray(arr, dtype)
    return merkle_root(memoryview(a).cast("B"), cache)


def commitment(service, tick: int, caches: dict | None = None) -> dict:
    """The commit-entry fields for a (sharded or single-shard) service.

    ``caches`` maps ``(shard_index, array_name)`` to a leaf-hash list
    (see :func:`merkle_root`); the owner must drop it whenever a shard's
    corpus log can shrink or reorder — patient migration and rebalance
    are the only such paths, and the journal observes both events."""
    shards = getattr(service, "shards", None) or [service]

    def cache_for(i, name):
        return None if caches is None else caches.setdefault((i, name), [])

    corpus, sketch = [], []
    for i, svc in enumerate(shards):
        snap = svc.snapshot()
        corpus.append(_node(
            _node(_array_root(snap.seq, np.int64, cache_for(i, "seq")),
                  _array_root(snap.dur, np.int32, cache_for(i, "dur"))),
            _array_root(snap.patient, np.int32,
                        cache_for(i, "patient"))).hex())
        sketch.append(_array_root(snap.counts, np.int32, None).hex())
    if hasattr(service, "router"):
        router = _keys_digest(service.router.pinned.items())
        pids = _keys_digest(service.pids.items())
        pending = sum(len(p) for p in service._pending_admits)
    else:
        router = ""
        pids = _keys_digest(service.store.pids.items())
        pending = 0
    return {"tick": int(tick), "corpus": corpus, "sketch": sketch,
            "router": router, "pids": pids, "pending": pending}
