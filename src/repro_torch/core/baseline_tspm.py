"""Faithful re-implementation of the ORIGINAL tSPM algorithm (the baseline).

The paper benchmarks tSPM+ against Estiri et al.'s original R implementation:
row-wise iteration, *string* sequence representations, and a dictionary-based
sparsity screen.  We reproduce that computational shape in pure Python/numpy
(no vectorization of the pair loop, string keys — deliberately slow) so the
comparison benchmark (paper Table 1) measures the same algorithmic gap, and
so tests have an independent oracle.  Its output equals the reference's
(``repro.core.baseline_tspm``), list for list.

Pseudocode (paper Fig. 1):
    sort(dbmart, by(patient_num, date))
    for all patient p:    for all phenx x in p:    for all y with y.date>=x.date:
        sparseSequences.add(createSequence(x, y))
    nonSparseSequences = sparsityScreen(sparseSequences)
"""
from __future__ import annotations

from collections import defaultdict

from repro_torch.data.dbmart import DBMart


def mine_strings(db: DBMart):
    """Original tSPM: list of (patient, 'start-end' string, duration)."""
    out = []
    vocab = db.vocab
    for p in range(db.n_patients):
        n = int(db.nevents[p])
        for i in range(n):
            xi = int(db.phenx[p, i])
            di = int(db.date[p, i])
            si = vocab.phenx_strings[xi] if vocab else str(xi)
            for j in range(i + 1, n):
                xj = int(db.phenx[p, j])
                sj = vocab.phenx_strings[xj] if vocab else str(xj)
                out.append((p, si + "-" + sj, int(db.date[p, j]) - di))
    return out


def sparsity_screen(rows, threshold: int):
    """Dictionary-based distinct-patient support screen on string rows."""
    patients = defaultdict(set)
    for p, s, _ in rows:
        patients[s].add(p)
    return [r for r in rows if len(patients[r[1]]) >= threshold]


def mine_and_screen(db: DBMart, threshold: int | None = None):
    rows = mine_strings(db)
    if threshold is not None:
        rows = sparsity_screen(rows, threshold)
    return rows
