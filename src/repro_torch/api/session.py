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

with ``screen='sorted'``, ``'hash'`` or ``'fused'`` (corpus-free counting,
then survivors only: core.chunking.mine_fused, on every engine).  The
planner refuses the streaming and sharded engines with
``NotImplementedError``.  The result lands in a
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

from repro_torch.api import planner
from repro_torch.api.config import MiningConfig, Plan
from repro_torch.api.frame import SequenceFrame
from repro_torch.core import chunking, mining, sparsity
from repro_torch.core.encoding import Vocab
from repro_torch.data.dbmart import DBMart


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
        self.last_plan: Plan | None = None
        self.last_frame: SequenceFrame | None = None

    # --- planning -----------------------------------------------------------
    def plan(self, db: DBMart | None = None) -> Plan:
        """The execution plan: for ``db`` if given, else the plan of the
        last ``fit`` (or the incremental plan, which is not ported)."""
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
        plan = self.plan(db)
        self.last_plan = plan
        self.last_frame = getattr(self, f"_fit_{plan.engine}")(db)
        return self.last_frame

    def frame(self) -> SequenceFrame:
        """The result of the last ``fit``."""
        if self.last_frame is None:
            raise RuntimeError("nothing mined yet: fit() a dbmart first")
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
