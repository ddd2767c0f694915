"""MiningConfig + Plan: the façade's declarative knobs and planner output.

The port accepts every knob of the reference's config, so a reference
config carries over with :meth:`MiningConfig.from_dict` (and back with
:meth:`MiningConfig.to_dict`, the keys that session checkpoints and the
tick journal's open entry store).

One frozen dataclass carries everything the four execution layers used to
take as scattered keyword arguments — encoding (codec, duration fusing),
screening (threshold, sorted vs hash), execution (backend, byte budgets),
and streaming/sharding (shard count, router, rebalance hysteresis).  A
config is plain data: runtime resources (a mesh, a pre-built router) are
passed to :class:`~repro_torch.api.session.MiningSession` instead.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.encoding import CODECS
from repro_torch.core.mining import BACKENDS

#: Engines the planner can select (and ``MiningConfig.engine`` can force):
#:   batch   — one in-memory mine of the whole cohort (core.mining)
#:   chunked — adaptive patient chunks under ``budget_bytes`` (core.chunking)
#:   files   — chunked with per-chunk .npz spill + merged count table
#:   stream  — incremental delta mining, one shard (stream.service)
#:   sharded — patient-sharded streaming over ``n_shards`` (stream.shard)
ENGINES = ("batch", "chunked", "files", "stream", "sharded")

#: Screen modes:
#:   sorted — the paper's exact sort/mark/re-sort screen
#:   hash   — one-sided hash-bucket screen over the materialized corpus
#:   fused  — corpus-free: hash-bucket counts come from the fused
#:            mine+screen kernel (kernels/tspm_fused) without ever writing
#:            the pair corpus; survivors are materialized afterwards
#:            (requires ``threshold``; same one-sided keep as 'hash')
SCREEN_MODES = ("sorted", "hash", "fused")

#: Shard state placement for the sharded engine:
#:   auto    — planner picks 'devices' when the host has at least one
#:             device per shard, else 'host'
#:   host    — every shard on the default device, shard-serial ticks
#:   devices — one device per shard (launch/mesh.shard_devices), ticks
#:             dispatched on every shard before any is collected, and
#:             migration handoffs admitted at the tick boundary (async)
PLACEMENTS = ("auto", "host", "devices")


@dataclasses.dataclass(frozen=True)
class MiningConfig:
    """Every mining knob in one place (see module docstring)."""

    # --- encoding ---------------------------------------------------------
    codec: str = "bit"              # 'bit' | 'paper' (encoding.pack)
    fuse_duration: bool = False     # fuse bucketed duration into the id
    bucket_days: int = 30           # duration bucket width (days)

    # --- screening --------------------------------------------------------
    threshold: int | None = None    # default support threshold for .screen()
    screen: str = "sorted"          # 'sorted' | 'hash' | 'fused' (see above)
    n_buckets_log2: int = 20        # hash-screen table size (2^H buckets)

    # --- execution --------------------------------------------------------
    # 'auto' takes the pair-generation kernel for CUDA input and the
    # triangular plain version otherwise (mining.resolve_backend).  It is
    # the default, unlike the reference's 'jnp', so that the default entry
    # point reaches the kernels on the card.
    backend: str = "auto"           # 'kernel' | 'torch' | 'auto' (mining.mine)
    budget_bytes: int | None = None  # mining working-set byte budget
    spill_bytes: int | None = None  # host corpus size that triggers file spill
    spill_dir: str | None = None    # where the file engine spills (tmp if None)
    disk_bytes: int | None = None   # host-spill budget: streaming evictions
    #                                 beyond it demote (oldest first) into the
    #                                 compressed disk tier, same pair-cost
    #                                 model as budget_bytes one boundary down
    #                                 (None = host tier unbounded, no disk)
    disk_dir: str | None = None     # disk-tier blockstore location (tmp if
    #                                 None; sharded engines use per-shard
    #                                 subdirectories)
    engine: str | None = None       # force one of ENGINES (None = planner)

    # --- streaming / sharding ---------------------------------------------
    tick_patients: int = 16         # patient slots per streaming tick
    max_slot_events: int = 512      # flood cap per slot (stream.service)
    n_shards: int = 1               # patient shards (>1 selects 'sharded')
    router: str = "hash"            # 'hash' | 'balance' (LPT, needs nevents)
    placement: str = "auto"         # shard state placement (PLACEMENTS)
    rebalance_every: int | None = None   # auto-rebalance period (ticks)
    imbalance_threshold: float = 1.5     # hot-shard trigger (x mean load)
    min_gain: float = 0.05               # migration hysteresis (x mean load)
    busy_weighted_rebalance: bool = False  # weight LPT by shard_load()

    # --- journaling ---------------------------------------------------------
    journal_dir: str | None = None  # hash-chained tick journal location
    #                                 (journal/); None = no journal.
    #                                 Streaming engines only: every delta,
    #                                 tick, eviction, migration, and
    #                                 rebalance is recorded, replayable
    #                                 byte-identically, and verifiable
    journal_commit_every: int = 16  # merkle commitment cadence (ticks)

    # --- observability ------------------------------------------------------
    telemetry: bool = False         # metrics registry + span tracer (obs/)
    profiler_annotations: bool = False  # mirror spans into torch.profiler
    #                                     traces (record_function)

    def __post_init__(self):
        if self.codec not in CODECS:
            raise ValueError(f"unknown codec {self.codec!r}; one of {CODECS}")
        if self.screen not in SCREEN_MODES:
            raise ValueError(
                f"unknown screen mode {self.screen!r}; one of {SCREEN_MODES}")
        if self.screen == "fused" and self.threshold is None:
            raise ValueError(
                "screen='fused' materializes survivors during fit, so it "
                "needs a threshold up front (set MiningConfig.threshold)")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; one of {BACKENDS}")
        if self.engine is not None and self.engine not in ENGINES:
            raise ValueError(
                f"unknown engine {self.engine!r}; one of {ENGINES}")
        if self.router not in ("hash", "balance"):
            raise ValueError(f"unknown router {self.router!r}")
        if self.placement not in PLACEMENTS:
            raise ValueError(
                f"unknown placement {self.placement!r}; one of {PLACEMENTS}")
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if self.journal_commit_every < 1:
            raise ValueError("journal_commit_every must be >= 1")

    def replace(self, **kw) -> "MiningConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "MiningConfig":
        """A config from ``dataclasses.asdict`` of this class or of the
        reference package's ``MiningConfig``.  The reference's backend
        'jnp' (its plain branch) becomes 'torch', and its
        ``jax_annotations`` becomes ``profiler_annotations``; an unknown
        key raises ``TypeError``."""
        d = dict(d)
        if d.get("backend") == "jnp":
            d["backend"] = "torch"
        if "jax_annotations" in d:
            d["profiler_annotations"] = d.pop("jax_annotations")
        return cls(**d)

    def to_dict(self) -> dict:
        """The inverse of :meth:`from_dict`: this config in the reference's
        keys (backend 'torch' as 'jnp', ``jax_annotations``), as a session
        checkpoint stores it so that either package restores it."""
        d = dataclasses.asdict(self)
        if d["backend"] == "torch":
            d["backend"] = "jnp"
        d["jax_annotations"] = d.pop("profiler_annotations")
        return d


def _fmt_bytes(n: int | None) -> str:
    if n is None:
        return "unbounded"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n} B"


@dataclasses.dataclass(frozen=True)
class Plan:
    """What the planner decided and why — print it, or override it by
    re-running with ``MiningConfig(engine=...)``."""

    engine: str
    reason: str
    working_set_bytes: int = 0
    budget_bytes: int | None = None
    disk_bytes: int | None = None
    corpus_bytes: int = 0
    n_chunks: int = 1
    n_shards: int = 1
    placement: str = "host"     # resolved (never 'auto'): shard placement
    incremental: bool = False
    corpus_free: bool = False   # screen='fused': no [P, n, n] corpus on
    #                             the screen pass, survivors-only alloc

    def __str__(self) -> str:
        lines = [
            f"MiningPlan(engine={self.engine})",
            f"  reason      : {self.reason}",
            f"  working set : {_fmt_bytes(self.working_set_bytes)}"
            f" (budget {_fmt_bytes(self.budget_bytes)})",
            f"  flat corpus : {_fmt_bytes(self.corpus_bytes)}",
        ]
        if self.corpus_free:
            lines.append("  screen      : corpus-free fused counting "
                         "(pairs allocated for survivors only)")
        if self.disk_bytes is not None:
            lines.append(f"  disk tier   : host spill over "
                         f"{_fmt_bytes(self.disk_bytes)} demotes to "
                         "compressed blocks")
        if self.n_chunks > 1:
            lines.append(f"  chunks      : {self.n_chunks}")
        if self.n_shards > 1:
            lines.append(f"  shards      : {self.n_shards}"
                         f" ({self.placement} placement)")
        if self.incremental:
            lines.append("  input       : incremental (submit/tick)")
        return "\n".join(lines)
