"""Verifiable tick journal: hash-chained audit log + replay + fraud proofs.

Every mutation a mining session performs — submitted deltas, completed
ticks, evictions, migrations, rebalances, checkpoints — lands as one
typed entry in an append-only journal whose entries are chained by
``sha256(h_{i-1} || entry)`` and punctuated by merkle commitments over
the mined corpus, the support sketch, and the router state.  The
journal is *sufficient*: ``replay(journal_dir)`` reconstructs a fresh
session byte-identical to the recorded run, and ``verify_replay``
re-derives the whole effect stream through a shadow journal, producing
a typed :class:`~repro_torch.journal.verify.FraudProof` naming the first
divergent tick for any tampered, forked, or truncated log.

  * ``entries`` — typed entry framing, hash chain, state digests;
  * ``merkle``  — chunked merkle commitments over live session state;
  * ``journal`` — :class:`TickJournal`: the subscriber/writer (segments
    ride the storage blockstore) and the segment reader;
  * ``verify``  — structural checks, byte-exact replay, fraud proofs.

Façade: ``MiningConfig(journal_dir=...)`` attaches a journal to any
streaming session; ``MiningSession.verify()`` / ``.replay()`` wrap the
functions here.  The journal's work is host numpy and hashlib (event
payloads and snapshots are host arrays); a replay re-runs the recorded
ticks on the replaying session's device, the card unless the caller asks
for the CPU.  The framing is the reference package's, byte for byte, so
either package verifies and replays the other's journals.
"""
from repro_torch.journal import entries, merkle  # noqa: F401
from repro_torch.journal.entries import FORMAT_VERSION, GENESIS  # noqa: F401
from repro_torch.journal.journal import TickJournal, TornSegmentError, \
    read_journal, write_journal  # noqa: F401
from repro_torch.journal.verify import ChainBreak, CommitmentMismatch, \
    Divergence, FraudProof, TornSegment, Truncated, VerifyResult, \
    compare_journals, replay, state_divergence, verify_journal, \
    verify_replay  # noqa: F401
