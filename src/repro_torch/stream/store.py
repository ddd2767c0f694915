"""Device-resident patient history store for streaming ingest.

The batch pipeline pads each cohort once (data/dbmart); a stream never
sees the whole cohort, so the store keeps *growable* padded planes

    phenx [P_cap, E_cap]   date [P_cap, E_cap]   (tensors on ``device``)
    nevents [P_cap]                              (host cursors)

with per-patient cursors (``nevents``) and a scatter-append.  Rows are
physical slots; patients get a stable dense ``pid`` on first admission
(admission order), so corpus and sketch state survive eviction.  The
cursors are host bookkeeping (like the LRU clocks): every position the
append and the delta slab need is known on the host before the launch,
so a tick never waits on the card to read them.

Capacity policy (the streaming analogue of core/chunking's adaptive
partitioning):

  * **regrowth** — event capacity rounds up to ``pad_multiple`` and
    doubles geometrically; row capacity doubles.
  * **eviction** — when a byte budget is set, the resident working set is
    replanned with ``chunking.plan_chunks`` over patients in
    most-recently-touched-first order; everything past the first chunk
    (the maximal recent prefix that fits the budget under the reference's
    ``BYTES_PER_PAIR`` cost model) is spilled to the host tier; when a
    disk budget is set, the oldest host spills demote further into the
    compressed disk tier (storage/tiers) under the same cost model.  The
    cost model is the reference's on every device, not the card's chunk
    price (``chunking.plan_card_chunks``), so eviction decisions, and with
    them the tier placement, equal the reference's on the CPU and the card.
    Re-admission restores the spilled history from whichever tier holds
    it, so delta mining is byte-budgeted but exact.
  * **handoff** — ``extract`` withdraws a patient entirely (shard
    migration), returning its history in the host-spill format;
    ``admit_state`` is the receiving end and lands the history in the
    spill slot, so a migrated-in patient restores lazily on first touch
    exactly like an evicted one.  Extracted pids are never reused.
  * **shrinking** — ``shrink_to_fit`` trims the event axis to the
    resident high-water mark and the row axis to the highest occupied
    row, but only when half (or less) of a plane axis is live.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs as obs_lib
from repro_torch.core import chunking
from repro_torch.core.encoding import as_tensor
from repro_torch.storage import tiers as tiers_lib
from repro_torch.storage.codec import decode_key, encode_key
from repro_torch.stream.counts import to_host


def _append_step(phenx, date, rows, n_old, new_phenx, new_date, n_new):
    """Scatter a [B, D] delta into the planes at the per-row cursors
    ``n_old``, in place.  Positions past the plane are dropped, as the
    reference's ``mode="drop"`` scatter drops them (``index_put_`` has no
    drop mode, so they are masked out first).  Every call records
    ``(P_cap, E_cap, B, D)`` in ``_append_step.shapes``."""
    B, D = new_phenx.shape
    E = phenx.shape[1]
    _append_step.shapes.add((phenx.shape[0], E, B, D))
    ar = torch.arange(D, dtype=torch.int64, device=phenx.device)[None, :]
    pos = n_old.to(torch.int64)[:, None] + ar
    keep = (ar < n_new.to(torch.int64)[:, None]) & (pos < E)
    r = rows.to(torch.int64)[:, None].expand(B, D)[keep]
    c = pos[keep]
    phenx.index_put_((r, c), new_phenx[keep])
    date.index_put_((r, c), new_date[keep])


_append_step.shapes = set()


class PatientStore:
    """Growable padded history planes with admission / eviction / regrowth.

    ``device`` holds the planes (the card unless the caller passes
    ``'cpu'``); every delta slab mined from them stays there.
    """

    def __init__(self, pad_multiple: int = 8, budget_bytes: int | None = None,
                 init_patients: int = 8, init_events: int = 8, device="cuda",
                 telemetry=None, labels: dict | None = None,
                 disk_bytes: int | None = None, disk_dir: str | None = None,
                 dictionary=None):
        self.pad_multiple = pad_multiple
        self.budget_bytes = budget_bytes
        self.disk_bytes = disk_bytes
        self.device = torch.device(device)
        self.obs = telemetry if telemetry is not None else obs_lib.NOOP
        lbl = labels or {}
        m = self.obs.metrics
        self._m_admits = m.counter("store.admits", **lbl)
        self._m_restores = m.counter("store.restores", **lbl)
        self._m_evictions = m.counter("store.evictions", **lbl)
        self._m_growths = m.counter("store.plane_growths", **lbl)
        self._m_shrinks = m.counter("store.plane_shrinks", **lbl)
        self._m_resident = m.gauge("store.resident_rows", **lbl)
        self._m_spilled = m.gauge("store.spilled_patients", **lbl)
        self._m_plane_bytes = m.gauge("store.plane_bytes", **lbl)
        self._m_occupancy = m.gauge("store.plane_occupancy", **lbl)
        self._m_resident_cost = m.gauge("store.resident_pair_bytes", **lbl)
        self._m_budget = m.gauge("store.budget_bytes", **lbl)
        self._m_demotions = m.counter("storage.demotions", **lbl)
        self.phenx = torch.zeros((init_patients, init_events), dtype=torch.int32,
                                 device=self.device)
        self.date = torch.zeros_like(self.phenx)
        self.nevents = np.zeros(init_patients, np.int32)
        self.rows: dict = {}          # patient key -> physical row
        self.pids: dict = {}          # patient key -> stable dense pid
        self.row_key: dict = {}       # physical row -> patient key
        self._free: list[int] = list(range(init_patients - 1, -1, -1))
        self._touch = np.zeros(init_patients, np.int64)
        self._clock = 0
        self._next_pid = 0            # pids are never reused after extract
        # residency walk below the device planes: host, then (optional) disk
        self.host = tiers_lib.HostTier(self.obs, lbl)
        self.disk = (tiers_lib.DiskTier(disk_dir, dictionary=dictionary,
                                        telemetry=self.obs, labels=lbl)
                     if disk_bytes is not None or disk_dir is not None
                     else None)
        self._tiers: list = ([self.host, self.disk]
                             if self.disk is not None else [self.host])

    # --- capacity -----------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self.phenx.shape[0]

    @property
    def max_events(self) -> int:
        return self.phenx.shape[1]

    @property
    def n_patients(self) -> int:
        """Distinct patients currently held (resident + spilled)."""
        return len(self.pids)

    @property
    def pid_capacity(self) -> int:
        """One past the largest pid ever assigned (pids outlive extraction,
        so tables indexed by pid must size by this, not ``n_patients``)."""
        return self._next_pid

    def _round(self, n: int) -> int:
        return -(-max(n, 1) // self.pad_multiple) * self.pad_multiple

    def _resize(self, rows: int, events: int) -> None:
        """Planes of ``rows`` x ``events`` keeping the overlapping block
        (new slots are zero)."""
        r, e = min(rows, self.n_rows), min(events, self.max_events)
        for name in ("phenx", "date"):
            old = getattr(self, name)
            new = torch.zeros((rows, events), dtype=torch.int32, device=self.device)
            new[:r, :e] = old[:r, :e]
            setattr(self, name, new)

    def ensure_event_capacity(self, min_events: int) -> None:
        need = self._round(min_events)
        if need <= self.max_events:
            return
        need = max(need, 2 * self.max_events)  # geometric: O(log) shapes
        self._resize(self.n_rows, need)
        self._m_growths.inc()

    def _ensure_rows(self, n_more: int) -> None:
        if len(self._free) >= n_more:
            return
        old = self.n_rows
        new_rows = max(old, self._round(n_more))
        self._resize(old + new_rows, self.max_events)
        self.nevents = np.pad(self.nevents, (0, new_rows))
        self._touch = np.pad(self._touch, (0, new_rows))
        self._free.extend(range(old + new_rows - 1, old - 1, -1))
        self._m_growths.inc()

    def _scatter(self, rows, n_old, new_phenx, new_date, n_new) -> None:
        """Append [B, D] deltas (host arrays or tensors) at host cursors."""
        dev = self.device
        _append_step(self.phenx, self.date,
                     torch.as_tensor(np.asarray(rows, np.int64)).to(dev),
                     torch.as_tensor(np.asarray(n_old, np.int32)).to(dev),
                     as_tensor(new_phenx, torch.int32).to(dev),
                     as_tensor(new_date, torch.int32).to(dev),
                     as_tensor(n_new, torch.int32).to(dev))

    # --- admission ----------------------------------------------------------
    def admit(self, keys) -> tuple[np.ndarray, np.ndarray]:
        """Rows (allocating / restoring as needed) + stable pids for keys.

        Keys must be distinct: cursors are read once per batch, so a
        repeated key would overwrite its own events (the service's wave
        admission defers repeats to the next tick)."""
        if len(set(keys)) != len(keys):
            raise ValueError("duplicate patient keys in one admit batch")
        missing = [k for k in keys if k not in self.rows]
        self._ensure_rows(len(missing))
        restored = []
        for k in missing:
            row = self._free.pop()
            self.rows[k] = row
            self.row_key[row] = k
            if k not in self.pids:
                self.pids[k] = self._next_pid
                self._next_pid += 1
            tier = self.tier_holding(k)
            if tier is not None:
                restored.append((row, *tier.restore(k)))
        if restored:
            d = max(len(ph) for _, ph, _ in restored)
            self.ensure_event_capacity(d)
            rows = np.asarray([r for r, _, _ in restored], np.int32)
            ph = np.zeros((len(restored), d), np.int32)
            dt = np.zeros((len(restored), d), np.int32)
            nn = np.zeros(len(restored), np.int32)
            for i, (_, p, t) in enumerate(restored):
                ph[i, : len(p)] = p
                dt[i, : len(p)] = t
                nn[i] = len(p)
            self._scatter(rows, self.nevents[rows], ph, dt, nn)
            self.nevents[rows] += nn
        self._clock += 1
        out_rows = np.asarray([self.rows[k] for k in keys], np.int32)
        self._touch[out_rows] = self._clock
        self._m_admits.inc(len(missing))
        self._m_restores.inc(len(restored))
        self._m_resident.set(len(self.rows))
        return out_rows, np.asarray([self.pids[k] for k in keys], np.int32)

    def append(self, rows, new_phenx, new_date, n_new) -> None:
        """Append padded [B, D] deltas at the cursors of ``rows`` (distinct)."""
        rows = np.asarray(rows, np.int32)
        if len(np.unique(rows)) != len(rows):
            raise ValueError("duplicate rows in one append batch")
        n_new = np.asarray(n_new, np.int32)
        n_old = self.nevents[rows]
        self.ensure_event_capacity(int((n_old + n_new).max(initial=1)))
        self._scatter(rows, n_old, new_phenx, new_date, n_new)
        self.nevents[rows] += n_new

    # --- eviction -----------------------------------------------------------
    def evict_over_budget(self) -> tuple[list, list]:
        """Spill least-recently-touched patients until the *mining working
        set* (pair-slab cost, the reference's BYTES_PER_PAIR model) fits
        the budget.

        Reuses ``chunking.plan_chunks``: patients ordered most-recent-first,
        the first planned chunk is the resident set, the tail spills.  The
        budget bounds resident mining cost, not raw plane allocation: the
        padded planes grow monotonically and at least one patient always
        stays resident.  Returns ``(evicted, demoted)`` key lists (device
        -> host spills and the host -> disk demotions they triggered) —
        the payload of the ``Evicted`` session event.
        """
        if self.budget_bytes is None or not self.rows:
            return [], []
        resident = np.asarray(sorted(self.rows.values()), np.int64)
        order = resident[np.argsort(-self._touch[resident], kind="stable")]
        nev = self.nevents[order]
        plan = chunking.plan_chunks(nev, self.budget_bytes,
                                    self.pad_multiple, layout="dense")
        victims = order[plan[0].stop:]
        if len(victims) == 0:
            return [], []
        # one gather + one device-to-host copy for the whole wave
        idx = torch.from_numpy(victims).to(self.device)
        ph = self.phenx[idx].cpu().numpy()
        dt = self.date[idx].cpu().numpy()
        nn = nev[plan[0].stop:]
        evicted = []
        for i, row in enumerate(victims):
            key = self.row_key.pop(int(row))
            n = int(nn[i])
            self.host.hold(key, ph[i, :n], dt[i, :n])
            del self.rows[key]
            self._free.append(int(row))
            evicted.append(key)
        self.nevents[victims] = 0
        demoted = self._demote_over_budget()
        self._m_evictions.inc(len(evicted))
        self._m_resident.set(len(self.rows))
        self._m_spilled.set(self.spilled_count)
        return evicted, demoted

    def _demote_over_budget(self) -> list:
        """Walk the host tier oldest-spill-first, demoting histories to the
        compressed disk tier until the host spill working set fits
        ``disk_bytes`` — the same n^2 * BYTES_PER_PAIR cost model as the
        device budget, applied one boundary down.  No disk tier (or no
        budget) means the host tier is unbounded.  Returns the demoted
        keys in demotion order."""
        if self.disk is None or self.disk_bytes is None:
            return []
        counts = self.host.event_counts()
        cost = sum(n * n for n in counts.values()) * chunking.BYTES_PER_PAIR
        demoted: list = []
        for key in self.host.keys():
            if cost <= self.disk_bytes:
                break
            ph, dt = self.host.peek(key)
            self.disk.hold(key, ph, dt)
            self.host.drop(key)
            cost -= counts[key] ** 2 * chunking.BYTES_PER_PAIR
            demoted.append(key)
        if demoted:
            self._m_demotions.inc(len(demoted))
        return demoted

    # --- migration handoff --------------------------------------------------
    def extract(self, key) -> tuple[int, np.ndarray, np.ndarray]:
        """Withdraw a patient entirely, returning ``(pid, phenx, date)``.

        The history comes back as 1-D host arrays — the spill format — so
        the receiving store's ``admit_state`` is exactly the spill-restore
        path.  The pid is retired, never reused; the freed row returns to
        the pool and ``shrink_to_fit`` reclaims plane capacity when the
        departing patient was a high-water mark.
        """
        if key not in self.pids:
            raise KeyError(key)
        if key in self.rows:
            row = self.rows.pop(key)
            del self.row_key[row]
            n = int(self.nevents[row])
            ph = self.phenx[row, :n].cpu().numpy().copy()
            dt = self.date[row, :n].cpu().numpy().copy()
            self.nevents[row] = 0
            self._free.append(row)
        else:
            ph, dt = self.tier_holding(key).restore(key)
        pid = self.pids.pop(key)
        self.shrink_to_fit()
        return pid, ph, dt

    def admit_state(self, key, phenx, date) -> int:
        """Admit a migrated-in patient with pre-existing history; returns
        its fresh pid.  The history lands in the host-spill slot and
        restores on first touch, reusing the eviction machinery verbatim
        (no plane growth until the patient is actually mined again)."""
        if key in self.pids:
            raise ValueError(f"key {key!r} already admitted")
        pid = self._next_pid
        self._next_pid += 1
        self.pids[key] = pid
        self.host.hold(key, phenx, date)
        self._demote_over_budget()
        return pid

    def shrink_to_fit(self) -> None:
        """Release plane capacity after departures.  True hysteresis on
        both axes: shrink fires only when <= half the axis is live, and
        releases at most one doubling step per call."""
        hwm_e = self._round(int(self.nevents.max(initial=1)))
        if 2 * hwm_e <= self.max_events:
            need_e = max(hwm_e, self._round(self.max_events // 2))
            self._resize(self.n_rows, need_e)
            self._m_shrinks.inc()
        top = max(self.rows.values(), default=-1)
        hwm_r = self._round(top + 1)
        if 2 * hwm_r <= self.n_rows:
            need_r = max(hwm_r, self._round(self.n_rows // 2))
            self._resize(need_r, self.max_events)
            self.nevents = self.nevents[:need_r]
            self._touch = self._touch[:need_r]
            self._free = [r for r in self._free if r < need_r]
            self._m_shrinks.inc()

    def sample_metrics(self) -> None:
        """Snapshot-time gauges: plane bytes/occupancy and the resident
        mining working set vs budget (the eviction signal), priced with
        the same BYTES_PER_PAIR model the evictor uses."""
        if not self.obs.enabled:
            return
        nev = self.nevents
        self._m_plane_bytes.set(
            int(self.phenx.numel() + self.date.numel() + nev.size) * 4)
        self._m_occupancy.set(
            float(nev.sum()) / max(self.n_rows * self.max_events, 1))
        self._m_resident_cost.set(
            int((nev.astype(np.int64) ** 2).sum()) * chunking.BYTES_PER_PAIR)
        self._m_budget.set(self.budget_bytes or 0)
        self._m_resident.set(len(self.rows))
        self._m_spilled.set(self.spilled_count)

    # --- introspection ------------------------------------------------------
    @property
    def spilled_count(self) -> int:
        """Patients held below the device planes (all tiers)."""
        return sum(len(t) for t in self._tiers)

    def tier_holding(self, key):
        """The residency tier currently holding ``key``, or None if the
        patient is device-resident (or unknown)."""
        for tier in self._tiers:
            if key in tier:
                return tier
        return None

    def tier_of(self, key) -> str | None:
        """'device' / 'host' / 'disk' for a held patient, None if unknown."""
        if key in self.rows:
            return "device"
        tier = self.tier_holding(key)
        return tier.name if tier is not None else None

    def held_keys(self) -> list:
        """Keys held below the device planes, promotion-order (host tier
        first, oldest spill first)."""
        return [k for tier in self._tiers for k in tier.keys()]

    def iter_held(self):
        """Yield ``(key, phenx, date)`` for every non-resident patient
        without promoting it (disk blocks are decoded, not withdrawn)."""
        for tier in self._tiers:
            for k in tier.keys():
                ph, dt = tier.peek(k)
                yield k, ph, dt

    def event_counts(self) -> dict:
        """Per-patient event counts across every tier — resident rows from
        the cursors, host copies by length, disk blocks from the index
        alone (no decode)."""
        counts = {k: int(self.nevents[r]) for k, r in self.rows.items()}
        for tier in self._tiers:
            counts.update(tier.event_counts())
        return counts

    def history(self, key) -> tuple[np.ndarray, np.ndarray]:
        """(phenx, date) events stored for a patient (resident or held)."""
        tier = self.tier_holding(key)
        if tier is not None:
            return tier.peek(key)
        row = self.rows[key]
        n = int(self.nevents[row])
        return (self.phenx[row, :n].cpu().numpy().copy(),
                self.date[row, :n].cpu().numpy().copy())

    # --- checkpoint ---------------------------------------------------------
    def state_dict(self) -> dict:
        """Full residency state as a pack_tree-able tree, in the
        reference's format: plane contents *and shapes*, row assignments,
        the free-list order, LRU clocks, pid watermark, and every held
        history with its tier, so a restored store resumes the exact
        residency walk."""
        held = []
        for tier in self._tiers:
            for k in tier.keys():
                ph, dt = tier.peek(k)
                held.append({"key": encode_key(k), "tier": tier.name,
                             "phenx": np.asarray(ph), "date": np.asarray(dt)})
        return {
            "phenx": to_host(self.phenx),
            "date": to_host(self.date),
            "nevents": self.nevents.copy(),
            "touch": self._touch.copy(),
            "clock": self._clock,
            "next_pid": self._next_pid,
            "rows": [[encode_key(k), int(r)] for k, r in self.rows.items()],
            "pids": [[encode_key(k), int(p)] for k, p in self.pids.items()],
            "free": [int(r) for r in self._free],
            "held": held,
        }

    def load_state_dict(self, state: dict) -> None:
        """Inverse of :meth:`state_dict` (tier budgets/config come from the
        constructor, not the state); takes the reference store's
        ``state_dict()`` too (its arrays turned to numpy)."""
        self.phenx = torch.from_numpy(np.array(state["phenx"], np.int32)).to(self.device)
        self.date = torch.from_numpy(np.array(state["date"], np.int32)).to(self.device)
        self.nevents = np.array(state["nevents"], np.int32)
        self._touch = np.asarray(state["touch"], np.int64).copy()
        self._clock = int(state["clock"])
        self._next_pid = int(state["next_pid"])
        self.rows = {decode_key(k): int(r) for k, r in state["rows"]}
        self.pids = {decode_key(k): int(p) for k, p in state["pids"]}
        self.row_key = {r: k for k, r in self.rows.items()}
        self._free = [int(r) for r in state["free"]]
        for tier in self._tiers:
            for k in tier.keys():
                tier.drop(k)
        for entry in state["held"]:
            key = decode_key(entry["key"])
            tier = (self.disk
                    if entry["tier"] == "disk" and self.disk is not None
                    else self.host)
            tier.hold(key, entry["phenx"], entry["date"])
        self._m_resident.set(len(self.rows))
        self._m_spilled.set(self.spilled_count)
