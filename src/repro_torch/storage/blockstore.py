"""CompressedBlockStore: encoded history blocks on disk + a JSON index.

The disk tier's substrate: one append-only segment file of
codec-encoded blocks plus a JSON index mapping patient key -> (offset,
byte size, crc32, event count, raw bytes).  Properties the tiers above
rely on:

  * **durability** — ``flush()`` writes the index atomically (tmp file +
    ``os.replace``), and a reopened store (``CompressedBlockStore(root)``
    on an existing directory) serves every flushed block; a crash between
    flushes loses index entries, never corrupts them;
  * **integrity** — ``get`` verifies the per-key crc32 recorded at
    ``put`` time, so a torn or bit-rotted block raises instead of
    silently decoding garbage;
  * **bounded garbage** — ``pop``/``discard`` only mark bytes dead; when
    dead bytes outgrow live bytes (and a floor), the segment compacts by
    rewriting live blocks to a fresh file (atomic replace), so a
    churning eviction workload cannot grow the segment unboundedly.

Insertion order is preserved across put/pop (``keys()`` yields it), which
is what the host tier's LRU demotion relies on.
"""
from __future__ import annotations

import json
import os
import tempfile
import zlib

import numpy as np

from repro_torch.storage import codec as codec_lib

INDEX_NAME = "index.json"
DATA_NAME = "blocks.dat"

#: compaction triggers when dead bytes exceed live bytes AND this floor
COMPACT_FLOOR_BYTES = 1 << 16


class CompressedBlockStore:
    """Disk-persisted compressed patient-history blocks (see module doc)."""

    def __init__(self, root: str | None = None,
                 dictionary: codec_lib.CodeDictionary | None = None,
                 auto_flush: bool = True):
        if root is None:
            # owned tmp dir: lives (and is reclaimed) with this object
            self._tmp = tempfile.TemporaryDirectory(prefix="tspm_blocks_")
            root = self._tmp.name
        self.root = root
        self.auto_flush = auto_flush
        os.makedirs(root, exist_ok=True)
        self._data_path = os.path.join(root, DATA_NAME)
        self._index_path = os.path.join(root, INDEX_NAME)
        # key -> [offset, nbytes, crc32, n_events, raw_bytes]
        self._index: dict = {}
        self.dead_bytes = 0
        self.dictionary = dictionary
        if os.path.exists(self._index_path):
            self._load_index()
        elif dictionary is None:
            self.dictionary = None
        self._fh = open(self._data_path, "a+b")

    # --- persistence --------------------------------------------------------
    def _load_index(self) -> None:
        with open(self._index_path) as f:
            idx = json.load(f)
        if idx.get("version") != 1:
            raise ValueError(f"unknown blockstore index version in "
                             f"{self._index_path}")
        stored_dict = idx.get("dictionary")
        if stored_dict is not None:
            loaded = codec_lib.CodeDictionary.from_json(stored_dict)
            if self.dictionary is not None and self.dictionary != loaded:
                raise ValueError("blockstore was written with a different "
                                 "code dictionary")
            self.dictionary = loaded
        self._index = {codec_lib.decode_key(k): list(v)
                       for k, v in idx["entries"]}
        self.dead_bytes = int(idx.get("dead_bytes", 0))

    def flush(self) -> None:
        """Atomically persist the index (blocks are already on disk; the
        data file is flushed first so every indexed offset is durable)."""
        self._fh.flush()
        os.fsync(self._fh.fileno())
        payload = {
            "version": 1,
            "dictionary": (self.dictionary.to_json()
                           if self.dictionary is not None else None),
            "dead_bytes": self.dead_bytes,
            "entries": [[codec_lib.encode_key(k), v]
                        for k, v in self._index.items()],
        }
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".index.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self._index_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def close(self) -> None:
        if self._fh is not None:
            self.flush()
            self._fh.close()
            self._fh = None

    # --- block API ----------------------------------------------------------
    def put(self, key, phenx, date) -> int:
        """Encode + append one history; returns the encoded byte size.
        Re-putting a key replaces it (the old block becomes dead bytes)."""
        blob = codec_lib.encode_block(phenx, date, self.dictionary)
        if key in self._index:
            # delete before re-insert: a re-put moves the key to the back of
            # the index, keeping insertion order a usable LRU for demotion
            self.dead_bytes += self._index.pop(key)[1]
        self._fh.seek(0, os.SEEK_END)
        offset = self._fh.tell()
        self._fh.write(blob)
        self._index[key] = [offset, len(blob), zlib.crc32(blob),
                            int(np.size(phenx)),
                            codec_lib.raw_bytes(np.size(phenx))]
        if self.auto_flush:
            self.flush()
        self._maybe_compact()
        return len(blob)

    def put_bytes(self, key, blob: bytes) -> int:
        """Append one opaque blob (no codec) under ``key``; same
        durability/crc/compaction guarantees as :meth:`put`.  The
        journal's hash-chained segments ride this: they are already
        self-describing byte streams, not patient histories.  Raw
        entries carry ``n_events = -1`` so :meth:`get` refuses to decode
        them as histories."""
        blob = bytes(blob)
        if key in self._index:
            self.dead_bytes += self._index.pop(key)[1]
        self._fh.seek(0, os.SEEK_END)
        offset = self._fh.tell()
        self._fh.write(blob)
        self._index[key] = [offset, len(blob), zlib.crc32(blob), -1,
                            len(blob)]
        if self.auto_flush:
            self.flush()
        self._maybe_compact()
        return len(blob)

    def get_bytes(self, key) -> bytes:
        """Fetch one raw blob (crc-verified); KeyError if absent,
        TypeError if the key holds an encoded history block."""
        if key not in self._index:
            raise KeyError(key)
        if self._index[key][3] != -1:
            raise TypeError(f"key {key!r} holds an encoded history block; "
                            "use get()")
        return self._read(key)

    def _read(self, key) -> bytes:
        offset, nbytes, crc, _, _ = self._index[key]
        self._fh.flush()
        self._fh.seek(offset)
        blob = self._fh.read(nbytes)
        if len(blob) != nbytes or zlib.crc32(blob) != crc:
            raise IOError(f"blockstore: checksum mismatch for key {key!r} "
                          f"(torn or corrupted block)")
        return blob

    def get(self, key) -> tuple[np.ndarray, np.ndarray]:
        """Decode one history (crc-verified); KeyError if absent."""
        if key not in self._index:
            raise KeyError(key)
        if self._index[key][3] == -1:
            raise TypeError(f"key {key!r} holds a raw blob; use get_bytes()")
        return codec_lib.decode_block(self._read(key), self.dictionary)

    def pop(self, key) -> tuple[np.ndarray, np.ndarray]:
        out = self.get(key)
        self.discard(key)
        return out

    def discard(self, key) -> None:
        entry = self._index.pop(key, None)
        if entry is not None:
            self.dead_bytes += entry[1]
            if self.auto_flush:
                self.flush()
            self._maybe_compact()

    # --- introspection ------------------------------------------------------
    def __contains__(self, key) -> bool:
        return key in self._index

    def __len__(self) -> int:
        return len(self._index)

    def keys(self):
        return list(self._index)

    def n_events(self, key) -> int:
        """Event count from the index alone — no block decode."""
        return self._index[key][3]

    def encoded_bytes(self, key) -> int:
        return self._index[key][1]

    @property
    def bytes_held(self) -> int:
        """Live encoded bytes (dead segment bytes excluded)."""
        return sum(v[1] for v in self._index.values())

    @property
    def raw_bytes_held(self) -> int:
        """What the live blocks would cost uncompressed on the host."""
        return sum(v[4] for v in self._index.values())

    def compression_ratio(self) -> float:
        enc = self.bytes_held
        return self.raw_bytes_held / enc if enc else 1.0

    # --- compaction ---------------------------------------------------------
    def _maybe_compact(self) -> None:
        if self.dead_bytes > max(self.bytes_held, COMPACT_FLOOR_BYTES):
            self.compact()

    def compact(self) -> None:
        """Rewrite live blocks to a fresh segment (atomic replace)."""
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".dat.tmp")
        new_index = {}
        try:
            with os.fdopen(fd, "wb") as out:
                for key, entry in self._index.items():
                    blob = self._read(key)
                    new_index[key] = [out.tell(), entry[1], entry[2],
                                      entry[3], entry[4]]
                    out.write(blob)
                out.flush()
                os.fsync(out.fileno())
            self._fh.close()
            os.replace(tmp, self._data_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            self._fh = open(self._data_path, "a+b")
            raise
        self._fh = open(self._data_path, "a+b")
        self._index = new_index
        self.dead_bytes = 0
        if self.auto_flush:
            self.flush()
