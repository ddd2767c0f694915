"""Adaptive dbmart partitioning (the paper's chunked mode), planner half.

The R package "split[s] the dbmart in chunks with an adaptive size to fit
the available memory limitations".  ``plan_chunks`` computes greedy
patient ranges such that the mining working set
``P_chunk * E_chunk^2 * BYTES_PER_PAIR`` fits a byte budget; per-chunk ``E``
adapts to the longest patient in the chunk (padded to a tile multiple), so
short-history chunks pack many more patients.  The planner uses it to
count chunks; the chunked, file-based and fused engines that consume the
chunks are not ported yet (ROADMAP.md, port slice 8).
"""
from __future__ import annotations

import dataclasses

import numpy as np

# dense pair tile: 8B seq + 4B dur + 1B mask, x2 for sort scratch
BYTES_PER_PAIR = 26


@dataclasses.dataclass(frozen=True)
class Chunk:
    start: int
    stop: int
    max_events: int

    @property
    def n_patients(self) -> int:
        return self.stop - self.start


def plan_chunks(nevents: np.ndarray, budget_bytes: int,
                pad_multiple: int = 8, layout: str = "triangular") -> list[Chunk]:
    """Greedy adaptive partitioning under a working-set byte budget."""
    chunks: list[Chunk] = []
    P = len(nevents)
    factor = 0.5 if layout == "triangular" else 1.0
    i = 0
    while i < P:
        e = max(int(nevents[i]), 1)
        e = -(-e // pad_multiple) * pad_multiple
        j = i + 1
        while j < P:
            e2 = max(e, -(-max(int(nevents[j]), 1) // pad_multiple) * pad_multiple)
            cost = (j + 1 - i) * e2 * e2 * BYTES_PER_PAIR * factor
            if cost > budget_bytes and j > i:
                break
            e = e2
            j += 1
        if (j - i) * e * e * BYTES_PER_PAIR * factor > budget_bytes and j - i > 1:
            j -= 1
            e = max(1, -(-int(max(nevents[i:j], default=1)) // pad_multiple) * pad_multiple)
        chunks.append(Chunk(i, j, e))
        i = j
    return chunks
