"""Typed query-plan IR: canonicalized, hashable mask chains.

A :class:`QueryPlan` is the serving-side mirror of a ``SequenceFrame``
op chain — the same screen / starts_with / ends_with / min_duration /
transitive_ends_with / top_k vocabulary, but as plain data: a tuple of
``(kind, arg)`` ops that can be hashed (the LRU cache key), batched
(the batched wave evaluator), and replayed against a frame (the
conformance oracle, :meth:`QueryPlan.apply`).

Canonicalization exploits the algebra of the ops.  The four *predicate*
ops (``VECTOR_OPS``) are pure per-row tests AND-ed into the keep mask —
``screen`` included: both the sorted-support and hash-bucket screens
compute their predicate from the corpus alone, never from the
accumulated keep — so within a run they commute and are idempotent.
``transitive_ends_with`` and ``top_k`` read the accumulated keep
(``BARRIER_OPS``), so they pin the runs around them in place.  Canonical
form sorts and dedups each predicate run between barriers, which makes
``.starts_with(x).min_duration(d)`` and ``.min_duration(d).starts_with(x)``
one cache entry and one batched program — provably the same mask.
"""
from __future__ import annotations

import dataclasses

#: keep-independent per-row predicates: vectorizable, commuting, idempotent
VECTOR_OPS = ("screen", "starts_with", "ends_with", "min_duration")
#: keep-dependent ops: evaluation order matters, evaluated per plan on host
BARRIER_OPS = ("transitive_ends_with", "top_k")

_KIND_RANK = {k: i for i, k in enumerate(VECTOR_OPS)}


def _sorted_run(run: list) -> list:
    """Canonical order of one commuting predicate run: dedup, then sort
    by (kind, arg) — any fixed total order works; this one is stable
    across processes (no hash randomization)."""
    return sorted(set(run), key=lambda op: (_KIND_RANK[op[0]], op[1]))


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """Immutable chainable plan builder (mirrors the SequenceFrame API).

        plan().screen(5).starts_with(x).top_k(8)

    ``screen()`` without a threshold defers to the serving session's
    config default (resolved by the server before canonicalization).
    """

    ops: tuple[tuple[str, int | None], ...] = ()

    def _with(self, kind: str, arg) -> "QueryPlan":
        return QueryPlan(self.ops + ((kind, arg),))

    # --- builders (one per frame mask method) ------------------------------
    def screen(self, threshold: int | None = None) -> "QueryPlan":
        return self._with(
            "screen", None if threshold is None else int(threshold))

    def starts_with(self, phenx_id: int) -> "QueryPlan":
        return self._with("starts_with", int(phenx_id))

    def ends_with(self, phenx_id: int) -> "QueryPlan":
        return self._with("ends_with", int(phenx_id))

    def min_duration(self, days: int) -> "QueryPlan":
        return self._with("min_duration", int(days))

    def transitive_ends_with(self, start_phenx_id: int) -> "QueryPlan":
        return self._with("transitive_ends_with", int(start_phenx_id))

    def top_k(self, k: int) -> "QueryPlan":
        return self._with("top_k", int(k))

    # --- resolution / canonical form ---------------------------------------
    def resolve(self, default_threshold: int | None = None) -> "QueryPlan":
        """Fill deferred screen thresholds with the session default."""
        if not any(kind == "screen" and arg is None for kind, arg in self.ops):
            return self
        if default_threshold is None:
            raise ValueError(
                "plan screens without a threshold and the session config "
                "has none; pass screen(threshold) or set "
                "MiningConfig.threshold")
        return QueryPlan(tuple(
            (kind, default_threshold if kind == "screen" and arg is None
             else arg)
            for kind, arg in self.ops))

    def canonical(self) -> tuple:
        """Hashable canonical op tuple (the result-cache key).  Requires a
        resolved plan (no deferred thresholds)."""
        out: list = []
        run: list = []
        for kind, arg in self.ops:
            if arg is None:
                raise ValueError("canonical() needs a resolved plan; "
                                 "call resolve(default_threshold) first")
            if kind in _KIND_RANK:
                run.append((kind, arg))
            else:
                out.extend(_sorted_run(run))
                run = []
                out.append((kind, arg))
        out.extend(_sorted_run(run))
        return tuple(out)

    def split_canonical(self) -> tuple[tuple, tuple]:
        """(vectorizable predicate prefix, host-evaluated suffix) of the
        canonical form — the suffix starts at the first barrier op."""
        canon = self.canonical()
        for i, (kind, _) in enumerate(canon):
            if kind in BARRIER_OPS:
                return canon[:i], canon[i:]
        return canon, ()

    # --- oracle -------------------------------------------------------------
    def apply(self, frame):
        """Replay the plan, in its *original* (un-canonicalized) order,
        through SequenceFrame chaining — the conformance oracle the
        batched evaluator is property-tested against."""
        for kind, arg in self.ops:
            frame = getattr(frame, kind)(arg)
        return frame

    def __str__(self) -> str:
        return ".".join(f"{k}({'?' if a is None else a})"
                        for k, a in self.ops) or "(all)"


def plan() -> QueryPlan:
    """Start an empty chain: ``plan().screen(5).starts_with(x)``."""
    return QueryPlan()
