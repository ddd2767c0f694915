"""MiningSession: config-driven dispatch over the execution engines.

``fit(dbmart)`` runs the planner (``plan()`` shows the decision; a
``MiningConfig.engine`` override forces it) and dispatches:

  * ``batch``   — one mine (core.mining) of the whole cohort on the
    session's device, the hash-screen bucket counts when ``screen='hash'``
    (core.sparsity), then a flatten;
  * ``chunked`` — adaptive patient chunks under ``budget_bytes``
    (core.chunking.mine_chunked);
  * ``files``   — chunk spill to .npz + merged bucket-count table
    (mine_to_files / load_files);
  * ``stream``  — the cohort replayed through a StreamService (the
    ``tspm_delta`` kernel on the card, one launch a tick);
  * ``sharded`` — replayed through a ShardedStreamService over
    ``n_shards`` (hash or LPT-balanced router; the shards on the
    session's device, or one per device of the mesh);

with ``screen='sorted'``, ``'hash'`` or ``'fused'`` (corpus-free counting,
then survivors only: core.chunking.mine_fused on the batch engines, the
sketch's survivors on the streaming ones).  ``submit(key, dates, phenx)``
/ ``tick()`` / ``run()`` feed the same session incrementally (engine
'stream' or 'sharded' by ``n_shards``); ``tick`` ingests one wave and
returns the live frame.  ``checkpoint`` / ``restore`` persist a live
streaming session (the reference's ``tspm-session-v1`` format: either
package restores the other's).  ``MiningConfig(telemetry=True)`` records
metrics and spans (``metrics()``, ``trace()``).
``MiningConfig(journal_dir=...)`` journals every event of a streaming
session into a hash-chained tick journal (``journal/``): ``journal()``,
``verify()`` and ``replay()`` read it.  ``serve()`` stands up the query
server (``serving/tspm``) over the session.  The result lands in a
:class:`~repro_torch.api.frame.SequenceFrame`.

The session runs on the card unless the caller asks for the CPU:
``device='cuda'`` is the default, and raises when no CUDA device is
visible.

Quickstart::

    from repro_torch.api import MiningConfig, MiningSession

    session = MiningSession(MiningConfig(threshold=5))   # on the card
    frame = session.fit(db)
    for d in frame.screen().top_k(8).decode():
        print(d.text, d.support)
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import obs as obs_lib
from repro_torch.api import planner
from repro_torch.api.config import MiningConfig, Plan
from repro_torch.api.frame import SequenceFrame
from repro_torch.core import chunking, mining, sparsity
from repro_torch.core.encoding import Vocab
from repro_torch.data.dbmart import DBMart
from repro_torch.journal.journal import TickJournal
from repro_torch.storage.state import pack_tree, unpack_tree
from repro_torch.stream.events import CheckpointTaken, EventTap
from repro_torch.stream.service import StreamService
from repro_torch.stream.shard import ShardedStreamService, ShardRouter
from repro_torch.training import checkpoint as ckpt_lib

SESSION_FORMAT = "tspm-session-v1"


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is visible; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return device


class MiningSession:
    """One mining session: a config, a device, a planner and a result frame.

    ``mesh`` (``launch.mesh.make_data_mesh``) and a pre-built ``router``
    are runtime resources of the sharded engine; ``vocab`` decodes frames
    when the dbmart has none.  Keyword overrides fork the config:
    ``MiningSession(threshold=5)`` ==
    ``MiningSession(MiningConfig(threshold=5))``.
    """

    def __init__(self, config: MiningConfig | None = None, *,
                 device="cuda", mesh=None, router: ShardRouter | None = None,
                 vocab: Vocab | None = None, **overrides):
        config = config if config is not None else MiningConfig()
        self.config = config.replace(**overrides) if overrides else config
        self.device = resolve_device(device)
        self.mesh = mesh
        self.router = router
        self.vocab = vocab
        self.telemetry = (obs_lib.Telemetry(
            profiler_annotations=self.config.profiler_annotations)
            if self.config.telemetry else obs_lib.NOOP)
        self.service: StreamService | ShardedStreamService | None = None
        self._journal = None      # TickJournal when config.journal_dir is set
        self.last_plan: Plan | None = None
        self.last_frame: SequenceFrame | None = None
        self.restore_extra: dict = {}   # user extras from the checkpoint
        #                                 this session was restored from

    # --- planning -----------------------------------------------------------
    def plan(self, db: DBMart | None = None) -> Plan:
        """The execution plan: for ``db`` if given, else the plan of the
        last ``fit`` / the live incremental session."""
        if db is not None:
            return planner.make_plan(self.config, db.nevents,
                                     device=self.device)
        if self.last_plan is not None:
            return self.last_plan
        return planner.make_plan(self.config, incremental=True,
                                 device=self.device)

    # --- batch input --------------------------------------------------------
    def fit(self, db: DBMart) -> SequenceFrame:
        """Mine a whole dbmart through the planned engine."""
        if self.service is not None:
            raise RuntimeError("session is already streaming (submit/tick); "
                               "use a fresh session for batch fit")
        plan = self.plan(db)
        self.last_plan = plan
        fit = getattr(self, f"_fit_{plan.engine}")
        with self.telemetry.tracer.span("session.fit", cat="host",
                                        engine=plan.engine):
            self.last_frame = fit(db)
        return self.last_frame

    def _frame(self, seq, dur, patient, mask=None, counts=None,
               vocab=None, n_patients=None) -> SequenceFrame:
        c = self.config
        return SequenceFrame(
            seq, dur, patient, mask, vocab=vocab or self.vocab,
            codec=c.codec, fuse_duration=c.fuse_duration,
            bucket_days=c.bucket_days, n_patients=n_patients, counts=counts,
            n_buckets_log2=c.n_buckets_log2, screen_mode=c.screen,
            threshold=c.threshold)

    def _chunk_kw(self) -> dict:
        c = self.config
        return dict(budget_bytes=c.budget_bytes or (1 << 28), codec=c.codec,
                    backend=c.backend, n_buckets_log2=c.n_buckets_log2,
                    fuse_duration=c.fuse_duration, bucket_days=c.bucket_days,
                    device=self.device)

    def _fit_fused(self, db: DBMart) -> SequenceFrame:
        """screen='fused': corpus-free counting pass, survivors-only
        materialization (chunking.mine_fused) — the only pair-allocating
        path is one re-mine chunk at a time plus the survivors."""
        out = chunking.mine_fused(db, threshold=self.config.threshold,
                                  **self._chunk_kw())
        return self._frame(out["seq"], out["dur"], out["patient"],
                           counts=out["counts"], vocab=db.vocab,
                           n_patients=db.n_patients)

    def _fit_batch(self, db: DBMart) -> SequenceFrame:
        c = self.config
        if c.screen == "fused":
            return self._fit_fused(db)

        def on_device(a):
            return torch.as_tensor(a, dtype=torch.int32).to(self.device)

        mined = mining.mine(on_device(db.phenx), on_device(db.date),
                            on_device(db.nevents), codec=c.codec,
                            fuse_duration=c.fuse_duration,
                            bucket_days=c.bucket_days, backend=c.backend)
        counts = (sparsity.local_bucket_counts(
            mined.seq, mined.mask, c.n_buckets_log2)
            if c.screen == "hash" else None)
        seq, dur, pat, msk = mining.flatten(mined)
        return self._frame(seq, dur, pat, msk, counts=counts,
                           vocab=db.vocab, n_patients=db.n_patients)

    def _fit_chunked(self, db: DBMart) -> SequenceFrame:
        if self.config.screen == "fused":
            return self._fit_fused(db)
        out = chunking.mine_chunked(db, with_counts=self.config.screen == "hash",
                                    **self._chunk_kw())
        # every row is real (chunks are compacted on the device): no mask
        return self._frame(out["seq"], out["dur"], out["patient"],
                           counts=out.get("counts"), vocab=db.vocab,
                           n_patients=db.n_patients)

    def _fit_files(self, db: DBMart) -> SequenceFrame:
        c = self.config
        if c.screen == "fused":
            # corpus-free screen first; only survivors ever hit the disk,
            # keeping the spill-directory contract (chunk .npz + merged
            # bucket_counts.npy) intact
            out = chunking.mine_fused(db, threshold=c.threshold,
                                      **self._chunk_kw())
            if c.spill_dir:
                os.makedirs(c.spill_dir, exist_ok=True)
                np.save(os.path.join(c.spill_dir, "bucket_counts.npy"),
                        out["counts"])
                np.savez(os.path.join(c.spill_dir, "chunk_00000.npz"),
                         seq=out["seq"], dur=out["dur"],
                         patient=out["patient"])
            return self._frame(out["seq"], out["dur"], out["patient"],
                               counts=out["counts"], vocab=db.vocab,
                               n_patients=db.n_patients)
        out_dir = c.spill_dir or tempfile.mkdtemp(prefix="tspm_spill_")
        try:
            chunking.mine_to_files(db, out_dir, **self._chunk_kw())
            out = chunking.load_files(out_dir)
        finally:
            if c.spill_dir is None:   # we made the dir; don't leak a corpus
                shutil.rmtree(out_dir, ignore_errors=True)
        return self._frame(out["seq"], out["dur"], out["patient"],
                           counts=out["counts"], vocab=db.vocab,
                           n_patients=db.n_patients)

    def _replay(self, db: DBMart, svc) -> None:
        for p in range(db.n_patients):
            n = int(db.nevents[p])
            if n:
                svc.submit(p, db.date[p, :n], db.phenx[p, :n])
        svc.run()

    def _fit_stream(self, db: DBMart) -> SequenceFrame:
        return self._fit_replayed(db, self._make_service(sharded=False))

    def _fit_sharded(self, db: DBMart) -> SequenceFrame:
        router = self.router
        if router is None and self.config.router == "balance":
            router = ShardRouter.balanced(
                list(range(db.n_patients)), np.asarray(db.nevents),
                self.config.n_shards)
        return self._fit_replayed(db, self._make_service(sharded=True,
                                                         router=router))

    def _fit_replayed(self, db: DBMart, svc) -> SequenceFrame:
        self._replay(db, svc)
        # the service ends with the fit, so its snapshot-time gauges (plane
        # and set widths, occupancy) are sampled now or never
        svc.sample_metrics()
        return self._snap_frame(svc, vocab=db.vocab, n_patients=db.n_patients)

    # --- incremental input --------------------------------------------------
    def submit(self, key, dates, phenx) -> None:
        """Queue one patient delta; ingest with ``tick()`` / ``run()``."""
        self._ensure_service().submit(key, dates, phenx)

    def tick(self) -> SequenceFrame:
        """Ingest one wave (every shard with queued work) and return the
        live frame over the updated corpus."""
        self._ensure_service().tick()
        return self.frame()

    def run(self) -> SequenceFrame:
        """Drain the queue, then return the live frame."""
        self._ensure_service().run()
        return self.frame()

    def frame(self) -> SequenceFrame:
        """The current result: the live streaming corpus, or the last
        ``fit`` result for a batch session."""
        if self.service is None:
            if self.last_frame is not None:
                return self.last_frame
            raise RuntimeError("nothing mined yet: fit() a dbmart or "
                               "submit() deltas first")
        return self._snap_frame(self.service, vocab=self.vocab)

    # --- serving ------------------------------------------------------------
    def serve(self, **kw):
        """Stand up a :class:`~repro_torch.serving.tspm.server.QueryServer`
        over this session — the read path.

        Live streaming sessions get a replica that re-publishes at every
        tick boundary (queries never block ``submit``/``tick`` and never
        see a half-applied tick); batch-fit sessions serve a static view
        of ``last_frame``.  Keywords forward to ``QueryServer``:
        ``batch_size``, ``cache_entries``, ``feature_ids`` (streams the
        per-patient feature matrix), ``auto_publish``.  Calling ``serve``
        on a fresh incremental session stands the service up first so the
        server can subscribe to tick boundaries.  Predicates are evaluated
        on the session's device."""
        from repro_torch.serving.tspm import QueryServer
        if self.service is None and self.last_frame is None:
            self._ensure_service()
        return QueryServer(self, **kw)

    def _ensure_service(self):
        if self.service is None:
            if self.last_frame is not None:
                raise RuntimeError(
                    "session already ran a batch fit; use a fresh session "
                    "for incremental submit/tick")
            plan = planner.make_plan(self.config, incremental=True,
                                     device=self.device)
            if plan.engine not in ("stream", "sharded"):
                raise ValueError(
                    f"engine {plan.engine!r} cannot ingest incrementally; "
                    "leave MiningConfig.engine unset or pick stream/sharded")
            self.last_plan = plan
            self.service = self._make_service(sharded=plan.engine == "sharded",
                                              router=self.router)
        return self.service

    def _make_service(self, sharded: bool, router: ShardRouter | None = None):
        """The stream service, or the sharded one (its shards on the
        session's device under ``'host'`` placement, one per device of
        the mesh under ``'devices'``), with a tick journal attached when
        ``journal_dir`` is set."""
        c = self.config
        kw = dict(tick_patients=c.tick_patients, codec=c.codec,
                  backend=c.backend, n_buckets_log2=c.n_buckets_log2,
                  budget_bytes=c.budget_bytes, fuse_duration=c.fuse_duration,
                  bucket_days=c.bucket_days, max_slot_events=c.max_slot_events,
                  disk_bytes=c.disk_bytes, disk_dir=c.disk_dir,
                  device=self.device,
                  telemetry=self.telemetry if self.telemetry.enabled else None)
        if not sharded:
            svc = StreamService(**kw)
        else:
            svc = ShardedStreamService(
                n_shards=c.n_shards, router=router, mesh=self.mesh,
                rebalance_every=c.rebalance_every,
                imbalance_threshold=c.imbalance_threshold, min_gain=c.min_gain,
                busy_weighted_rebalance=c.busy_weighted_rebalance,
                placement=planner.resolve_placement(c, self.device), **kw)
        if c.journal_dir is not None:
            # the config goes in the reference's keys, so either package
            # replays the journal
            self._journal = TickJournal(c.journal_dir,
                                        commit_every=c.journal_commit_every,
                                        telemetry=kw["telemetry"])
            self._journal.attach(svc, engine="sharded" if sharded else "stream",
                                 config=c.to_dict())
        return svc

    # --- checkpoint / resume ------------------------------------------------
    def checkpoint(self, ckpt_dir: str, step: int | None = None,
                   extra: dict | None = None) -> str:
        """Atomically capture the live streaming session to ``ckpt_dir``.

        Everything that makes continuation byte-identical goes in: store
        planes and residency tiers, sketch tables, queued deltas, the
        mined corpus, router pins, in-flight migration payloads, and tick
        counters — in the training checkpoint layout (``arrays.npz`` +
        ``manifest.json`` in a tmp dir, atomically renamed), the config in
        the reference's keys (``MiningConfig.to_dict``), so the reference
        restores it too.  ``step`` defaults to the service's tick count;
        ``extra`` is a JSON-able user dict surfaced as ``restore_extra``
        after :meth:`restore`.  Returns the checkpoint path."""
        if self.service is None:
            raise RuntimeError("nothing to checkpoint: only live streaming "
                               "sessions persist; submit()/tick() first "
                               "(batch fit results are already a frame)")
        with self.telemetry.tracer.span("checkpoint.save", cat="host"):
            sharded = isinstance(self.service, ShardedStreamService)
            state = self.service.state_dict()
            if step is None:
                step = int(state["tick_count"] if sharded
                           else state["n_ticks"])
            tree = {"format": SESSION_FORMAT,
                    "engine": "sharded" if sharded else "stream",
                    "config": self.config.to_dict(),
                    "state": state}
            json_tree, arrays = pack_tree(tree)
            path = ckpt_lib.save(ckpt_dir, step, arrays,
                                 extra={"session": json_tree,
                                        "user": extra or {}})
        if self.service.events.wants(CheckpointTaken):
            self.service.events.emit(
                CheckpointTaken(step=int(step), path=path))
        return path

    @classmethod
    def restore(cls, ckpt_dir: str, *, device="cuda", mesh=None,
                vocab: Vocab | None = None) -> "MiningSession":
        """Rebuild a streaming session from a :meth:`checkpoint` directory
        (or one specific ``step_*`` path inside it), written by this
        package or the reference, and continue exactly where it left off.
        Every tensor is rebuilt on ``device`` (the card unless the caller
        asks for the CPU), whatever device wrote the checkpoint.  Runtime
        resources (``mesh``, ``vocab``) are re-supplied by the caller, like
        the constructor."""
        path = ckpt_dir
        if not os.path.exists(os.path.join(path, "manifest.json")):
            found = ckpt_lib.latest(ckpt_dir)
            if found is None:
                raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
            path = found
        leaves, manifest = ckpt_lib.load(path)
        tree = unpack_tree(manifest["extra"]["session"], leaves)
        if tree.get("format") != SESSION_FORMAT:
            raise ValueError(f"{path!r} is not a session checkpoint "
                             f"(format {tree.get('format')!r})")
        config = MiningConfig.from_dict(tree["config"])
        session = cls(config, device=device, mesh=mesh, vocab=vocab)
        plan = planner.make_plan(config, incremental=True,
                                 device=session.device)
        with session.telemetry.tracer.span("checkpoint.restore", cat="host"):
            svc = session._make_service(sharded=tree["engine"] == "sharded")
            svc.load_state_dict(tree["state"])
            session.service = svc
            session.last_plan = plan
        session.restore_extra = manifest["extra"].get("user", {})
        return session

    def _snap_frame(self, svc, vocab=None, n_patients=None) -> SequenceFrame:
        snap = svc.snapshot()
        if isinstance(svc, ShardedStreamService):
            p2k = svc.pid_to_key()
        else:
            p2k = {pid: k for k, pid in svc.store.pids.items()}
        if p2k and all(isinstance(k, (int, np.integer)) for k in p2k.values()):
            # patient column = original integer keys, via a pid lut (pids
            # are dense admission-order ints, possibly with retired holes)
            lut = np.full(max(p2k) + 1, -1, np.int64)
            for pid, key in p2k.items():
                lut[pid] = key
            patient = lut[snap.patient].astype(np.int32)
        else:
            patient = snap.patient    # non-int keys: keep dense pids
        seq, dur = snap.seq, snap.dur
        if self.config.screen == "fused":
            # the sketch table already equals the batch bucket counts;
            # compact the snapshot to its hash-screen survivors (selected
            # on the session's device) so streaming frames match the fused
            # batch frames
            seq, dur, patient = sparsity.screen_survivors(
                *(torch.from_numpy(a).to(self.device) for a in (seq, dur, patient)),
                torch.from_numpy(snap.counts).to(self.device),
                self.config.threshold, self.config.n_buckets_log2)
        return self._frame(seq, dur, patient, counts=snap.counts,
                           vocab=vocab, n_patients=n_patients)

    # --- events / observability ---------------------------------------------
    def events(self, kinds=None, maxlen: int | None = 4096) -> EventTap:
        """A pull-side tap on the session's typed event stream
        (:mod:`repro_torch.stream.events`): iterate it to drain every
        ``SessionEvent`` emitted since the last drain.  ``kinds`` filters
        to an event class or tuple of them."""
        return EventTap(self._ensure_service(), kinds=kinds, maxlen=maxlen)

    def metrics(self) -> dict:
        """Flat snapshot of every telemetry metric (``name{labels}`` ->
        value, histograms as summary dicts).  Snapshot-time gauges are
        refreshed from the live service first.  Requires
        ``MiningConfig(telemetry=True)``."""
        if not self.telemetry.enabled:
            raise RuntimeError("telemetry is disabled; build the session "
                               "with MiningConfig(telemetry=True)")
        if self.service is not None:
            self.service.sample_metrics()
        return self.telemetry.metrics.snapshot()

    def trace(self):
        """The session's :class:`~repro_torch.obs.SpanTracer` (export with
        ``to_chrome_trace()`` / ``dump_chrome_trace(path)``).  Requires
        ``MiningConfig(telemetry=True)``."""
        if not self.telemetry.enabled:
            raise RuntimeError("telemetry is disabled; build the session "
                               "with MiningConfig(telemetry=True)")
        return self.telemetry.tracer

    def shard_load(self) -> list[float]:
        """Device-timed busy fraction per shard since the last poll
        (sharded engine only; see ShardedStreamService.shard_load)."""
        svc = self.service
        if not isinstance(svc, ShardedStreamService):
            raise RuntimeError("shard_load() needs a live sharded service")
        return svc.shard_load()

    # --- journal ------------------------------------------------------------
    def journal(self):
        """The live :class:`~repro_torch.journal.journal.TickJournal`, or
        None when the session was built without ``journal_dir``."""
        return self._journal

    def verify(self, journal_dir: str | None = None):
        """Verify a journal against this live session -> ``VerifyResult``.

        With no argument, verifies the session's own journal; pass a
        ``journal_dir`` to check a foreign copy (an auditor's, a claimed
        fork).  Three layers (see :mod:`repro_torch.journal.verify`):
        segment/chain structure, byte-exact replay on this session's
        device through a shadow journal (merkle commitments re-derived and
        compared), and — because a live session is present — an
        entry-by-entry fork check against the session's own log plus a
        final-state comparison.  Any failure carries a typed
        ``FraudProof`` naming the first divergent tick."""
        from repro_torch.journal import verify as jv
        own = self._journal
        if own is not None:
            own.flush()
        target = journal_dir if journal_dir is not None else \
            (own.root if own is not None else None)
        if target is None:
            raise RuntimeError("nothing to verify: the session has no "
                               "journal (set MiningConfig.journal_dir) and "
                               "no journal_dir was given")
        res, replayed = jv.verify_replay(target, device=self.device,
                                         mesh=self.mesh, vocab=self.vocab)
        if not res.ok:
            return res
        if own is not None and journal_dir is not None \
                and os.path.abspath(journal_dir) != os.path.abspath(own.root):
            proof = jv.compare_journals(own.entries(),
                                        jv.read_journal(journal_dir))
            if proof is not None:
                return dataclasses.replace(res, ok=False, proof=proof)
        if self.service is not None and replayed is not None:
            proof = jv.state_divergence(self.service, replayed.service,
                                        n_ticks=res.n_ticks)
            if proof is not None:
                return dataclasses.replace(res, ok=False, proof=proof)
        return res

    @classmethod
    def replay(cls, journal_dir: str, upto_tick: int | None = None, *,
               device="cuda", mesh=None,
               vocab: Vocab | None = None) -> "MiningSession":
        """Reconstruct a session on ``device`` (the card unless the caller
        asks for the CPU) from a journal of either package by re-applying
        its recorded commands — corpus, sketch table, and router pins are
        byte-identical to the recorded run's state (optionally only
        through ``upto_tick``).  Complements :meth:`restore`: a checkpoint
        is a state snapshot, the journal is the full audited history."""
        from repro_torch.journal import verify as jv
        return jv.replay(journal_dir, upto_tick=upto_tick, device=device,
                         mesh=mesh, vocab=vocab)
