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

with ``screen='sorted'``, ``'hash'`` or ``'fused'`` (corpus-free counting,
then survivors only: core.chunking.mine_fused on the batch engines, the
sketch's survivors on the stream).  ``submit(key, dates, phenx)`` /
``tick()`` / ``run()`` feed the same session incrementally (engine
'stream'); ``tick`` ingests one wave and returns the live frame.
``MiningConfig(telemetry=True)`` records metrics and spans
(``metrics()``, ``trace()``).  The planner refuses the sharded engine and
the journal with ``NotImplementedError``, and so do ``checkpoint``,
``restore``, ``journal``, ``verify``, ``replay``, ``serve`` and
``shard_load``, each naming its ROADMAP.md item.  The result lands in a
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
from repro_torch.stream.events import EventTap
from repro_torch.stream.service import StreamService


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

    ``vocab`` decodes frames when the dbmart has none.  Keyword overrides
    fork the config: ``MiningSession(threshold=5)`` ==
    ``MiningSession(MiningConfig(threshold=5))``.
    """

    def __init__(self, config: MiningConfig | None = None, *,
                 device="cuda", vocab: Vocab | None = None, **overrides):
        config = config if config is not None else MiningConfig()
        self.config = config.replace(**overrides) if overrides else config
        self.device = resolve_device(device)
        self.vocab = vocab
        self.telemetry = (obs_lib.Telemetry(
            profiler_annotations=self.config.profiler_annotations)
            if self.config.telemetry else obs_lib.NOOP)
        self.service: StreamService | None = None
        self.last_plan: Plan | None = None
        self.last_frame: SequenceFrame | None = None

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
        svc = self._make_service()
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
        """Ingest one wave and return the live frame over the updated
        corpus."""
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

    def _ensure_service(self) -> StreamService:
        if self.service is None:
            if self.last_frame is not None:
                raise RuntimeError(
                    "session already ran a batch fit; use a fresh session "
                    "for incremental submit/tick")
            plan = planner.make_plan(self.config, incremental=True,
                                     device=self.device)
            if plan.engine != "stream":
                raise ValueError(
                    f"engine {plan.engine!r} cannot ingest incrementally; "
                    "leave MiningConfig.engine unset or pick stream")
            self.last_plan = plan
            self.service = self._make_service()
        return self.service

    def _make_service(self) -> StreamService:
        c = self.config
        return StreamService(
            tick_patients=c.tick_patients, codec=c.codec, backend=c.backend,
            n_buckets_log2=c.n_buckets_log2, budget_bytes=c.budget_bytes,
            fuse_duration=c.fuse_duration, bucket_days=c.bucket_days,
            max_slot_events=c.max_slot_events, device=self.device,
            telemetry=self.telemetry if self.telemetry.enabled else None,
            disk_bytes=c.disk_bytes, disk_dir=c.disk_dir)

    def _snap_frame(self, svc: StreamService, vocab=None,
                    n_patients=None) -> SequenceFrame:
        snap = svc.snapshot()
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

    # --- not ported yet -----------------------------------------------------
    def checkpoint(self, ckpt_dir: str, step: int | None = None,
                   extra: dict | None = None) -> str:
        raise planner.not_ported("MiningSession.checkpoint", "checkpoint")

    @classmethod
    def restore(cls, ckpt_dir: str, **kw) -> "MiningSession":
        raise planner.not_ported("MiningSession.restore", "checkpoint")

    def journal(self):
        raise planner.not_ported("MiningSession.journal", "journal")

    def verify(self, journal_dir: str | None = None):
        raise planner.not_ported("MiningSession.verify", "journal")

    @classmethod
    def replay(cls, journal_dir: str, upto_tick: int | None = None, **kw):
        raise planner.not_ported("MiningSession.replay", "journal")

    def serve(self, **kw):
        raise planner.not_ported("MiningSession.serve", "serve")

    def shard_load(self) -> list[float]:
        raise planner.not_ported("MiningSession.shard_load", "sharded")
