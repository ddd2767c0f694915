"""Residency tiers: one interface for every place a cold history can live.

The store's residency walk is device -> host -> disk; everything below
the device planes sits behind :class:`ResidencyTier` so the eviction /
restore / handoff paths are tier-agnostic policy, not special-cased
dicts.  A tier holds *withdrawn* histories in the host-spill format (1-D
int32 ``(phenx, date)`` arrays) keyed by patient key:

  * ``hold``     — take custody of a history (idempotent per key: a
    re-hold replaces);
  * ``restore``  — withdraw it (the promotion path; removes the entry);
  * ``peek``     — read without withdrawing (introspection, cost model);
  * ``drop``     — discard (patient extracted away);
  * ``keys()``   — insertion order, oldest first: the demotion walk pops
    from the front, so "least-recently-spilled" falls out of dict order
    with no extra clock.

:class:`HostTier` is the pre-refactor ``_spilled`` dict behind the
interface; :class:`DiskTier` persists blocks through
:class:`~repro_torch.storage.blockstore.CompressedBlockStore` and reports both
encoded (actual disk) and raw (host-equivalent) bytes, plus
encode/decode latency histograms and a compression-ratio gauge on the
``storage.*`` metric namespace.
"""
from __future__ import annotations

import time
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch import obs as obs_lib
from repro_torch.storage.blockstore import CompressedBlockStore


@runtime_checkable
class ResidencyTier(Protocol):
    """What the store's policy walk needs from any tier."""

    name: str

    def hold(self, key, phenx, date) -> None: ...

    def restore(self, key) -> tuple[np.ndarray, np.ndarray]: ...

    def peek(self, key) -> tuple[np.ndarray, np.ndarray]: ...

    def drop(self, key) -> None: ...

    def bytes_held(self) -> int: ...

    def event_counts(self) -> dict: ...

    def keys(self) -> list: ...

    def __contains__(self, key) -> bool: ...

    def __len__(self) -> int: ...


class HostTier:
    """Host-RAM spill tier: uncompressed 1-D history copies (the former
    ``PatientStore._spilled`` dict, now behind the tier interface)."""

    name = "host"

    def __init__(self, telemetry=None, labels: dict | None = None):
        self._held: dict = {}
        self._bytes = 0                    # incremental: hot-path friendly
        obs = telemetry if telemetry is not None else obs_lib.NOOP
        lbl = dict(labels or {}, tier=self.name)
        self._m_patients = obs.metrics.gauge("storage.tier_patients", **lbl)
        self._m_bytes = obs.metrics.gauge("storage.tier_bytes", **lbl)
        self._m_restores = obs.metrics.counter("storage.restores", **lbl)

    def hold(self, key, phenx, date) -> None:
        self.drop(key)                     # re-hold moves to the back
        entry = (np.asarray(phenx, np.int32).reshape(-1),
                 np.asarray(date, np.int32).reshape(-1))
        self._held[key] = entry
        self._bytes += entry[0].nbytes + entry[1].nbytes
        self._sample()

    def restore(self, key) -> tuple[np.ndarray, np.ndarray]:
        out = self._held.pop(key)
        self._bytes -= out[0].nbytes + out[1].nbytes
        self._m_restores.inc()
        self._sample()
        return out

    def peek(self, key) -> tuple[np.ndarray, np.ndarray]:
        return self._held[key]

    def drop(self, key) -> None:
        out = self._held.pop(key, None)
        if out is not None:
            self._bytes -= out[0].nbytes + out[1].nbytes
            self._sample()

    def bytes_held(self) -> int:
        return self._bytes

    def event_counts(self) -> dict:
        return {k: len(p) for k, (p, _) in self._held.items()}

    def keys(self) -> list:
        return list(self._held)

    def __contains__(self, key) -> bool:
        return key in self._held

    def __len__(self) -> int:
        return len(self._held)

    def _sample(self) -> None:
        self._m_patients.set(len(self._held))


class DiskTier:
    """Compressed on-disk tier over :class:`CompressedBlockStore`.

    ``hold`` pays one encode + append; ``restore`` one crc-checked read +
    decode.  The blockstore is opened lazily against ``root`` (an owned
    tmp dir when None) and left unflushed between checkpoints —
    durability is the checkpoint layer's contract, latency is this
    tier's."""

    name = "disk"

    def __init__(self, root: str | None = None, dictionary=None,
                 telemetry=None, labels: dict | None = None):
        self.store = CompressedBlockStore(root, dictionary=dictionary,
                                          auto_flush=False)
        obs = telemetry if telemetry is not None else obs_lib.NOOP
        lbl = dict(labels or {}, tier=self.name)
        self._m_patients = obs.metrics.gauge("storage.tier_patients", **lbl)
        self._m_bytes = obs.metrics.gauge("storage.tier_bytes", **lbl)
        self._m_raw = obs.metrics.gauge("storage.tier_raw_bytes", **lbl)
        self._m_ratio = obs.metrics.gauge("storage.compression_ratio", **lbl)
        self._m_restores = obs.metrics.counter("storage.restores", **lbl)
        self._m_enc = obs.metrics.histogram("storage.encode_s", **(labels or {}))
        self._m_dec = obs.metrics.histogram("storage.decode_s", **(labels or {}))

    @property
    def root(self) -> str:
        return self.store.root

    def hold(self, key, phenx, date) -> None:
        t0 = time.perf_counter()
        self.store.put(key, phenx, date)
        self._m_enc.observe(time.perf_counter() - t0)
        self._sample()

    def restore(self, key) -> tuple[np.ndarray, np.ndarray]:
        t0 = time.perf_counter()
        out = self.store.pop(key)
        self._m_dec.observe(time.perf_counter() - t0)
        self._m_restores.inc()
        self._sample()
        return out

    def peek(self, key) -> tuple[np.ndarray, np.ndarray]:
        return self.store.get(key)

    def drop(self, key) -> None:
        self.store.discard(key)
        self._sample()

    def flush(self) -> None:
        self.store.flush()

    def bytes_held(self) -> int:
        return self.store.bytes_held

    def event_counts(self) -> dict:
        return {k: self.store.n_events(k) for k in self.store.keys()}

    def keys(self) -> list:
        return self.store.keys()

    def __contains__(self, key) -> bool:
        return key in self.store

    def __len__(self) -> int:
        return len(self.store)

    def _sample(self) -> None:
        self._m_patients.set(len(self.store))
        self._m_bytes.set(self.store.bytes_held)
        self._m_raw.set(self.store.raw_bytes_held)
        self._m_ratio.set(self.store.compression_ratio())
