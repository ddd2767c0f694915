"""TickJournal: the append-only, hash-chained session journal.

A :class:`TickJournal` subscribes to a service's typed event stream
(``repro_torch.stream.events``) and appends one entry per event — submitted
deltas, completed ticks (with a digest of the tick's mined delta feed),
evictions/demotions, migrations (full patient state for external
admits, a content digest for internal moves the replayer re-derives),
rebalances, and checkpoints — each chained by
``h_i = sha256(h_{i-1} || entry)``.  Every ``commit_every`` ticks it
appends a merkle commitment over the corpus, sketch table, router pins
and pid table (:mod:`repro_torch.journal.merkle`) and flushes.

Segments ride the :class:`~repro_torch.storage.blockstore.CompressedBlockStore`
raw-blob API: each flush writes one crc-indexed segment blob
(``uvarint(count)`` then per entry ``uvarint(len) entry hash32``) under
an ordered key, with the store's atomic index giving the same
durability story as the disk residency tier.  ``root=None`` keeps the
journal in memory — the replay verifier runs one as the *shadow*
journal and compares its bytes against the recorded stream.

Re-attaching to an existing journal directory resumes the chain (the
open entry is only written once), so a checkpoint-restored session can
keep journaling into the same genesis-rooted log.
"""
from __future__ import annotations

import os

from repro_torch import obs as obs_lib
from repro_torch.journal import merkle
from repro_torch.journal.entries import FORMAT_VERSION, GENESIS, Reader, \
    chain_hash, encode_entry, entry_kind, pack_state, state_digest, \
    uvarint, wave_digest
from repro_torch.storage import codec as codec_lib
from repro_torch.storage.blockstore import CompressedBlockStore
from repro_torch.stream.events import CheckpointTaken, DeltaSubmitted, Evicted, \
    Migrated, Rebalanced, TickCompleted


def _seg_key(i: int) -> str:
    return f"jseg{i:08d}"


def parse_segment(blob: bytes) -> list[tuple[bytes, bytes]]:
    """One segment -> its [(entry_bytes, stored_hash)] list."""
    r = Reader(blob)
    n = r.uvarint()
    out = [(r.take(r.uvarint()), r.take(32)) for _ in range(n)]
    if not r.eof():
        raise ValueError("trailing bytes after segment entries")
    return out


def build_segment(entries: list[tuple[bytes, bytes]]) -> bytes:
    return b"".join([uvarint(len(entries))]
                    + [uvarint(len(e)) + e + h for e, h in entries])


class TornSegmentError(Exception):
    """A segment failed its crc or framing; carries everything readable
    before the tear so the verifier can name the tick."""

    def __init__(self, segment: str, entries_ok: list):
        super().__init__(f"journal segment {segment} is torn or corrupt")
        self.segment = segment
        self.entries_ok = entries_ok


def read_journal(root: str) -> list[tuple[bytes, bytes]]:
    """Every entry (with its stored chain hash) across all segments, in
    append order; raises :class:`TornSegmentError` on a bad segment."""
    store = CompressedBlockStore(root)
    try:
        out: list[tuple[bytes, bytes]] = []
        for key in sorted(k for k in store.keys()
                          if isinstance(k, str) and k.startswith("jseg")):
            try:
                out.extend(parse_segment(store.get_bytes(key)))
            except (IOError, ValueError, TypeError):
                raise TornSegmentError(key, out) from None
        return out
    finally:
        store.close()


def write_journal(root: str, entries: list[bytes]) -> None:
    """(Re)write a journal from raw entry bytes, re-deriving the chain —
    tooling for tests and repair, and the forge an *adversary* would
    use: a rewritten journal is internally consistent, so only replay
    (shadow-stream + commitment comparison) can catch it."""
    store = CompressedBlockStore(root)
    try:
        for key in list(store.keys()):
            if isinstance(key, str) and key.startswith("jseg"):
                store.discard(key)
        prev = GENESIS
        chained = []
        for e in entries:
            prev = chain_hash(prev, e)
            chained.append((e, prev))
        store.put_bytes(_seg_key(0), build_segment(chained))
    finally:
        store.close()


class TickJournal:
    """Writer (and tail reader) over one journal directory; see module
    docstring.  ``root=None`` -> in-memory (the verifier's shadow)."""

    def __init__(self, root: str | None = None, commit_every: int = 16,
                 telemetry=None):
        if commit_every < 1:
            raise ValueError("commit_every must be >= 1")
        self.root = root
        self.commit_every = commit_every
        self.obs = telemetry if telemetry is not None else obs_lib.NOOP
        self._store = (CompressedBlockStore(root)
                       if root is not None else None)
        #: in-memory mode keeps the full log; disk mode only the
        #: unflushed tail (segments are re-read on demand)
        self.log: list[tuple[bytes, bytes]] = []
        self._tail: list[tuple[bytes, bytes]] = []
        self._last_hash = GENESIS
        self._n_segments = 0
        self.n_entries = 0
        self.n_ticks = 0
        self.n_commits = 0
        #: merkle leaf caches keyed (shard, array) — valid while corpus
        #: logs only append; dropped on migration/rebalance (the only
        #: paths that shrink or reorder a shard's corpus)
        self._commit_caches: dict = {}
        m = self.obs.metrics
        self._m_entries = m.counter("journal.entries")
        self._m_commits = m.counter("journal.commits")
        self._m_bytes = m.counter("journal.bytes")
        if self._store is not None and len(self._store):
            for e, h in read_journal(root):
                self._account(entry_kind(e))
                self._last_hash = h
            self._n_segments = sum(
                1 for k in self._store.keys()
                if isinstance(k, str) and k.startswith("jseg"))

    def _account(self, kind: str) -> None:
        self.n_entries += 1
        if kind == "tick":
            self.n_ticks += 1
        elif kind == "commit":
            self.n_commits += 1

    # --- write side ---------------------------------------------------------
    def append(self, kind: str, fields: dict | None = None,
               arrays: dict | None = None,
               blobs: dict | None = None) -> bytes:
        entry = encode_entry(kind, fields, arrays, blobs)
        self._last_hash = chain_hash(self._last_hash, entry)
        rec = (entry, self._last_hash)
        if self._store is None:
            self.log.append(rec)
        else:
            self._tail.append(rec)
        self._account(kind)
        self._m_entries.inc()
        self._m_bytes.inc(len(entry))
        return entry

    def flush(self) -> None:
        """Seal the unflushed tail into one durable segment."""
        if self._store is None or not self._tail:
            return
        self._store.put_bytes(_seg_key(self._n_segments),
                              build_segment(self._tail))
        self._n_segments += 1
        self._tail = []

    def close(self) -> None:
        self.flush()
        if self._store is not None:
            self._store.close()
            self._store = None

    def entries(self) -> list[tuple[bytes, bytes]]:
        """The full (entry, hash) log, flushed segments included."""
        if self._store is None:
            return list(self.log)
        return read_journal(self.root) + list(self._tail)

    # --- event side ---------------------------------------------------------
    def attach(self, service, engine: str | None = None,
               config: dict | None = None) -> None:
        """Write the open entry (first attach only) and subscribe to the
        service's event stream.  The open entry freezes everything a
        replayer needs to rebuild the session: format version, engine,
        the full config dict, the commit cadence, and the router's
        initial pins (a pre-built balanced router is a runtime resource,
        not config)."""
        if self.n_entries == 0:
            router = getattr(service, "router", None)
            self.append("open", {
                "format": FORMAT_VERSION,
                "engine": engine or ("sharded" if hasattr(service, "shards")
                                     else "stream"),
                "commit_every": self.commit_every,
                "config": config or {},
                "router_pinned": [
                    [codec_lib.encode_key(k), int(s)]
                    for k, s in router.pinned.items()] if router else [],
            })
            self.flush()
        # isolate=False: a journal append failure must fail the tick —
        # an audit log that silently drops records is worse than no log
        service.subscribe(self.handle, isolate=False)

    def handle(self, ev) -> None:
        """One SessionEvent -> one (or two, at commit ticks) entries."""
        if isinstance(ev, DeltaSubmitted):
            # raw int32 arrays, not the varint codec: delta entries are
            # the journal's per-event hot path, and the pure-python
            # varint encoder alone costs more than the <5% overhead bar
            # (submit already normalized both arrays to int32)
            self.append("delta",
                        {"key": codec_lib.encode_key(ev.key),
                         "shard": ev.shard},
                        arrays={"dates": ev.dates, "phenx": ev.phenx})
        elif isinstance(ev, TickCompleted):
            self.append("tick", {
                "tick": int(ev.tick), "n": int(len(ev.seq)),
                "wave": wave_digest(ev.keys, ev.slot_idx, ev.seq, ev.dur)})
            if ev.tick % self.commit_every == 0:
                with self.obs.tracer.span("journal.commit", cat="host",
                                          tick=int(ev.tick)):
                    self.append("commit",
                                merkle.commitment(ev.service, ev.tick,
                                                  self._commit_caches))
                    self.flush()
                self._m_commits.inc()
        elif isinstance(ev, Evicted):
            self.append("evict", {
                "shard": ev.shard,
                "keys": [codec_lib.encode_key(k) for k in ev.keys],
                "demoted": [codec_lib.encode_key(k) for k in ev.demoted]})
        elif isinstance(ev, Migrated):
            self._commit_caches.clear()
            if ev.src is None:
                # external admit: the journal is the only place this
                # state exists, so it rides along in full
                fields, arrays = pack_state(ev.state)
                fields.update(src=None, dst=int(ev.dst),
                              digest=state_digest(ev.state))
                self.append("migrate", fields, arrays)
            else:
                self.append("migrate", {
                    "key": codec_lib.encode_key(ev.key),
                    "src": int(ev.src), "dst": int(ev.dst),
                    "digest": (state_digest(ev.state)
                               if ev.state is not None else None)})
        elif isinstance(ev, Rebalanced):
            self._commit_caches.clear()
            self.append("rebalance", {
                "moves": [[codec_lib.encode_key(k), int(a), int(b)]
                          for k, a, b in ev.moves]})
        elif isinstance(ev, CheckpointTaken):
            self.append("checkpoint", {"step": int(ev.step),
                                       "path": os.path.basename(ev.path)})
            self.flush()
