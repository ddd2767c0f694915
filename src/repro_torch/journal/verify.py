"""Journal verification: chain checks, byte-exact replay, fraud proofs.

Three layers, cheapest first:

  1. **structural** (:func:`verify_journal`) — segments parse (blockstore
     crc + framing), the hash chain holds, the journal opens with an
     open entry.  Catches torn storage and naive in-place tampering.
  2. **replay** (:func:`verify_replay`) — rebuild a fresh session from
     the open entry's config and re-apply every *command* entry (delta /
     tick / migrate).  A shadow in-memory :class:`TickJournal`
     subscribed to the replayed session re-derives the *effect* stream
     (evictions, tick wave digests, merkle commitments), which is
     compared byte-for-byte against the recorded one as replay
     progresses.  Catches semantic forgery — a re-chained journal whose
     entries are internally consistent but do not describe a run the
     engine would actually produce — and names the first divergent tick.
  3. **against a live session** (``MiningSession.verify``) — the
     replayed session's final corpus / sketch / router / pid state is
     compared with the live one, and a foreign journal is compared
     entry-by-entry with the session's own log to catch forks and
     truncations the replay alone cannot see.

Every failure is a typed :class:`FraudProof` carrying the first
divergent tick (1-based; ``tick=1`` means the journal diverges before
any tick completed) and the offending entry index.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.journal import entries as entries_lib
from repro_torch.journal.entries import GENESIS, REPLAYED_KINDS, chain_hash, \
    decode_entry, entry_kind
from repro_torch.journal.journal import TickJournal, TornSegmentError, read_journal
from repro_torch.storage import codec as codec_lib


# --- fraud proofs ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FraudProof:
    """A verifiable claim that a journal is wrong, pinned to the first
    divergent tick and entry index (``index=-1``: past the last entry)."""

    tick: int
    index: int
    reason: str

    def __str__(self) -> str:
        return (f"{type(self).__name__}(tick={self.tick}, "
                f"entry={self.index}): {self.reason}")


class TornSegment(FraudProof):
    """A segment blob failed its crc or framing — storage-level damage."""


class ChainBreak(FraudProof):
    """An entry's stored hash does not extend the chain — in-place edit,
    reorder, or splice without re-deriving the chain."""


class Divergence(FraudProof):
    """Replay of the journal's own commands produces a different event
    stream (or final state) than the journal records — the journal
    describes a run the engine would not perform."""


class CommitmentMismatch(FraudProof):
    """A merkle commitment does not match the state replay reaches at
    that tick — corpus/sketch/router tampering with a re-chained log."""


class Truncated(FraudProof):
    """The journal ends before the events its own commands imply (or
    before the live session's log does) — a rollback fork."""


@dataclasses.dataclass(frozen=True)
class VerifyResult:
    """Outcome of a verification pass: ``ok`` + the first
    :class:`FraudProof` (or None), plus journal shape counters."""

    ok: bool
    proof: FraudProof | None
    n_entries: int
    n_ticks: int
    n_commits: int

    def __bool__(self) -> bool:
        return self.ok

    def __str__(self) -> str:
        if self.ok:
            return (f"VerifyResult(ok: {self.n_entries} entries, "
                    f"{self.n_ticks} ticks, {self.n_commits} commitments)")
        return f"VerifyResult(FAILED: {self.proof})"


def _fail(res: VerifyResult, proof: FraudProof) -> VerifyResult:
    return dataclasses.replace(res, ok=False, proof=proof)


# --- layer 1: structural -----------------------------------------------------

def _kind(e: bytes) -> str:
    """Entry kind, tolerant of corrupt bytes (a tampered entry may not
    even decode as JSON — the chain check still localizes it)."""
    try:
        return entry_kind(e)
    except Exception:
        return "?"


def verify_journal(root: str) -> VerifyResult:
    """Structural check (see module doc, layer 1).  Never replays."""
    try:
        entries = read_journal(root)
    except TornSegmentError as err:
        kinds = [_kind(e) for e, _ in err.entries_ok]
        return VerifyResult(
            False,
            TornSegment(tick=kinds.count("tick") + 1,
                        index=len(err.entries_ok),
                        reason=f"segment {err.segment!r} failed its "
                               "checksum or framing"),
            len(err.entries_ok), kinds.count("tick"), kinds.count("commit"))
    kinds = [_kind(e) for e, _ in entries]
    res = VerifyResult(True, None, len(entries), kinds.count("tick"),
                       kinds.count("commit"))
    prev = GENESIS
    for i, (e, h) in enumerate(entries):
        if chain_hash(prev, e) != h:
            return _fail(res, ChainBreak(
                tick=kinds[:i].count("tick") + 1, index=i,
                reason="stored hash does not extend the chain "
                       "(edited, reordered, or spliced entry)"))
        prev = h
    if not entries or kinds[0] != "open":
        return _fail(res, Truncated(
            tick=1, index=0, reason="journal does not start with an "
                                    "open entry"))
    return res


# --- layer 2: replay ---------------------------------------------------------

def _build_session(open_fields: dict, mesh=None, vocab=None, device="cuda"):
    """A fresh MiningSession on ``device`` from an open entry: same config,
    forced engine, journaling/telemetry/profiler annotations/auto-rebalance
    off (rebalance *moves* are journaled as migrate entries and re-applied
    directly — letting the replayed service re-trigger them would double
    them), router rebuilt from the journaled initial pins.  The config is
    read with ``MiningConfig.from_dict`` (the reference's keys), so a
    journal of either package replays here."""
    from repro_torch.api.config import MiningConfig
    from repro_torch.api.session import MiningSession
    from repro_torch.stream.shard import ShardRouter
    cfg = dict(open_fields.get("config") or {})
    cfg.update(engine=open_fields["engine"], journal_dir=None,
               rebalance_every=None, busy_weighted_rebalance=False,
               telemetry=False, jax_annotations=False)
    config = MiningConfig.from_dict(cfg)
    router = None
    if open_fields["engine"] == "sharded":
        router = ShardRouter(config.n_shards, pinned={
            codec_lib.decode_key(k): int(s)
            for k, s in open_fields.get("router_pinned", [])})
    session = MiningSession(config, device=device, mesh=mesh, router=router,
                            vocab=vocab)
    session._ensure_service()
    return session


def _apply(svc, kind: str, fields: dict, arrays: dict, blobs: dict) -> None:
    """Re-apply one command entry to the replayed service.  Effect
    entries (evict / commit) and metadata (rebalance / checkpoint) are
    not applied — the service re-derives the effects itself."""
    if kind == "delta":
        svc.submit(codec_lib.decode_key(fields["key"]),
                   arrays["dates"], arrays["phenx"])
    elif kind == "tick":
        svc.tick()
    elif kind == "migrate":
        if fields.get("src") is None:
            state = entries_lib.unpack_state(fields, arrays)
            if hasattr(svc, "shards"):
                svc.admit_patient(state, dst=int(fields["dst"]))
            else:
                svc.admit_patient(state)
        else:
            svc.migrate(codec_lib.decode_key(fields["key"]),
                        int(fields["dst"]))


def _replay(entries: list, upto_tick: int | None = None, mesh=None,
            vocab=None, shadow: TickJournal | None = None, device="cuda"):
    """Core replay loop -> ``(session, proof_or_None)``.

    With a ``shadow`` journal the re-derived event stream is compared
    byte-for-byte against the recorded REPLAYED_KINDS entries as it
    grows.  The streams may transiently lead/lag each other inside one
    tick (the recorded evict/tick entries are read before the tick
    command is applied, the shadow's commit lands before the recorded
    one is read), so comparison only consumes the common prefix and the
    final drain settles the tails."""
    kinds = [entry_kind(e) for e, _ in entries]
    expected: list = []         # (entry index, entry bytes) to reproduce
    matched = 0                 # common prefix already compared
    session = None

    def mismatch(i: int) -> FraudProof:
        idx, want = expected[i]
        got = shadow.log[i][0]
        tick = kinds[:idx].count("tick") + 1
        a, b = entry_kind(want), entry_kind(got)
        if a == b == "commit":
            return CommitmentMismatch(
                tick=tick, index=idx,
                reason="recorded merkle commitment does not match the "
                       "state replay reaches at this tick")
        return Divergence(
            tick=tick, index=idx,
            reason=f"recorded {a!r} entry differs from the {b!r} entry "
                   "replay produces at this position")

    for idx, (e, _h) in enumerate(entries):
        kind, fields, arrays, blobs = decode_entry(e)
        if kind == "open":
            if session is not None:
                return session, Divergence(
                    tick=kinds[:idx].count("tick") + 1, index=idx,
                    reason="second open entry mid-journal")
            session = _build_session(fields, mesh=mesh, vocab=vocab,
                                     device=device)
            if shadow is not None:
                session.service.subscribe(shadow.handle, isolate=False)
            continue
        if session is None:
            return None, Truncated(
                tick=1, index=idx,
                reason=f"{kind!r} entry before any open entry")
        if kind == "tick" and upto_tick is not None \
                and int(fields["tick"]) > upto_tick:
            break
        if kind in REPLAYED_KINDS:
            expected.append((idx, e))
        _apply(session.service, kind, fields, arrays, blobs)
        if shadow is not None:
            while matched < min(len(expected), len(shadow.log)):
                if expected[matched][1] != shadow.log[matched][0]:
                    return session, mismatch(matched)
                matched += 1
    if shadow is not None:
        if len(shadow.log) > len(expected):
            k2 = [_kind(e) for _, e in expected]
            return session, Truncated(
                tick=k2.count("tick") + 1, index=-1,
                reason=f"replay produced {len(shadow.log) - len(expected)} "
                       "event(s) past the journal's end (rolled-back tail)")
        if len(expected) > len(shadow.log):
            idx = expected[len(shadow.log)][0]
            return session, Divergence(
                tick=kinds[:idx].count("tick") + 1, index=idx,
                reason="journal records events replay never produces")
    return session, None


def replay(root: str, upto_tick: int | None = None, *, device="cuda",
           mesh=None, vocab=None):
    """Reconstruct a fresh ``MiningSession`` from a journal directory by
    re-applying its command entries (optionally only through
    ``upto_tick``) — byte-identical to the recorded run's state at that
    point, on ``device`` (the card unless the caller asks for the CPU),
    whatever device wrote the journal.  No verification beyond what replay
    inherently does; use :func:`verify_replay` for the full shadow-stream
    check."""
    session, proof = _replay(read_journal(root), upto_tick=upto_tick,
                             mesh=mesh, vocab=vocab, device=device)
    if proof is not None:
        raise ValueError(f"journal at {root!r} is not replayable: {proof}")
    return session


def verify_replay(root: str, *, device="cuda", mesh=None, vocab=None):
    """Layers 1 + 2 -> ``(VerifyResult, replayed session or None)``; the
    replay runs on ``device``."""
    res = verify_journal(root)
    if not res.ok:
        return res, None
    entries = read_journal(root)
    open_fields = decode_entry(entries[0][0])[1]
    shadow = TickJournal(root=None,
                         commit_every=int(open_fields["commit_every"]))
    session, proof = _replay(entries, mesh=mesh, vocab=vocab, shadow=shadow,
                             device=device)
    if proof is not None:
        return _fail(res, proof), session
    return res, session


# --- layer 3: against a live session -----------------------------------------

def compare_journals(reference: list, candidate: list) -> FraudProof | None:
    """Entry-by-entry comparison of a candidate journal against the
    reference (a live session's own log): forks and rollbacks that an
    internally-consistent journal hides from replay alone."""
    kinds = [_kind(e) for e, _ in reference]
    for i in range(min(len(reference), len(candidate))):
        if reference[i][0] != candidate[i][0]:
            return Divergence(
                tick=kinds[:i].count("tick") + 1, index=i,
                reason="journal forks from the live session's log")
    if len(candidate) < len(reference):
        return Truncated(
            tick=kinds[:len(candidate)].count("tick") + 1,
            index=len(candidate),
            reason=f"journal ends {len(reference) - len(candidate)} "
                   "entr(ies) before the live session's log")
    if len(candidate) > len(reference):
        return Divergence(
            tick=kinds.count("tick") + 1, index=len(reference),
            reason="journal extends past the live session's log")
    return None


def state_divergence(live_svc, replayed_svc, n_ticks: int) \
        -> FraudProof | None:
    """Final-state comparison (snapshot level, so pending migration
    admits land on both sides): corpus, sketch table, router pins, pid
    table.  A difference here with a clean entry stream means the live
    session mutated outside its journal."""
    a, b = live_svc.snapshot(), replayed_svc.snapshot()
    for name in ("seq", "dur", "patient", "counts"):
        if not np.array_equal(np.asarray(getattr(a, name)),
                              np.asarray(getattr(b, name))):
            return Divergence(
                tick=n_ticks, index=-1,
                reason=f"live session's {name} differs from replay at "
                       "the journal's end")
    sharded = hasattr(live_svc, "shards")
    live_pids = live_svc.pids if sharded else live_svc.store.pids
    rep_pids = replayed_svc.pids if sharded else replayed_svc.store.pids
    if dict(live_pids) != dict(rep_pids):
        return Divergence(tick=n_ticks, index=-1,
                          reason="live session's pid table differs from "
                                 "replay at the journal's end")
    if sharded and dict(live_svc.router.pinned) \
            != dict(replayed_svc.router.pinned):
        return Divergence(tick=n_ticks, index=-1,
                          reason="live session's router pins differ from "
                                 "replay at the journal's end")
    return None
