"""Post-COVID-19 (WHO definition) identification from mined sequences.

The paper's second vignette: a symptom is a Post-COVID-19 (PCC) symptom for
a patient when it (a) occurs after a COVID-19 infection, (b) is ongoing for
at least two months, and (c) cannot be explained by a competing cause.
The vignette implements this purely on transitive sequences + durations:

  1. candidate sequences = sequences starting with covid whose end phenX is
     in the transitive end-set of covid (queries.transitive_ends_with);
  2. per patient, drop candidates that occur only once or whose duration
     spread (max - min over occurrences) is below ~2 months;
  3. exclusion by correlation: for each remaining candidate end-phenX, look
     at *other* sequences ending in it; if some start phenX c is tightly
     aligned with the symptom run (same duration spread as the covid
     sequence — the vectorized proxy for the vignette's pairwise
     correlation on (sequence, duration-bucket) tuples), proximate
     (min duration <= proximity_days) and itself a point event (rare),
     the candidate is explained away and removed for that patient.

Deviation note (DESIGN.md §9): the vignette computes Pearson correlations
per (sequence, end-duration-bucket) tuple; with perfectly aligned runs the
correlation is 1 exactly when the duration *spreads* coincide, so we use
|spread_c - spread_covid| <= align_tol_days as the vectorizable criterion,
plus the significance guard (occurrence-count and proximity), which keeps
the rule exact on point-cause explanations and avoids per-triple host loops.

Everything is dense [P, V, V] tables built by scatter from the flat mined
arrays — V is the (small) phenX vocabulary of the cohort or the
candidate-restricted subset.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import encoding
from repro_torch.core.encoding import as_tensor

_INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class PostCovidConfig:
    covid_id: int
    min_occurrences: int = 2        # rule: "occur only once" -> drop
    min_spread_days: int = 56       # WHO: ongoing for at least two months
    proximity_days: int = 30        # competing cause close to run start
    align_tol_days: int = 7         # spread-match tolerance (corr proxy)
    anchor_rate_min: float = 0.5    # cohort: cause anchors the run when
    anchor_support_min: int = 2     #   co-present (correlation+significance)
    assoc_ratio_min: float = 3.0    # cohort: run-rate ratio covid/non-covid
    assoc_support_min: int = 2      #   minimum run cases among covid patients


def pair_tables(seq, dur, patient, mask, n_patients: int, n_phenx: int,
                codec: str = "bit"):
    """Dense per-patient pair stats: count / dmin / dmax as [P, V, V]."""
    seq = as_tensor(seq, torch.int64).reshape(-1)
    dur = as_tensor(dur, torch.int32).reshape(-1)
    patient = as_tensor(patient, torch.int32).reshape(-1)
    mask = as_tensor(mask, torch.bool).reshape(-1)
    s, e = encoding.unpack(seq, codec)
    s = torch.where(mask, s, 0).to(torch.int64)
    e = torch.where(mask, e, 0).to(torch.int64)
    p = torch.where(mask, patient, 0).to(torch.int64)
    flat = (p * n_phenx + s) * n_phenx + e
    size, dev = n_patients * n_phenx * n_phenx, seq.device
    cnt = torch.zeros(size, dtype=torch.int32, device=dev)
    cnt.index_add_(0, flat, mask.to(torch.int32))
    dmin = torch.full((size,), _INT32_MAX, dtype=torch.int32, device=dev)
    dmin.scatter_reduce_(0, flat, torch.where(mask, dur, _INT32_MAX), "amin")
    dmax = torch.full((size,), -1, dtype=torch.int32, device=dev)
    dmax.scatter_reduce_(0, flat, torch.where(mask, dur, -1), "amax")
    # masked lanes scatter neutral elements (0 / +inf / -1) -> no pollution
    shape = (n_patients, n_phenx, n_phenx)
    return cnt.view(shape), dmin.view(shape), dmax.view(shape)


def occurrence_counts(phenx, nevents, n_patients: int, n_phenx: int):
    """[P, V] event occurrence counts from the padded dbmart."""
    phenx = as_tensor(phenx, torch.int32)
    P, E = phenx.shape
    valid = (torch.arange(E, dtype=torch.int32, device=phenx.device)[None, :]
             < as_tensor(nevents, torch.int32)[:, None])
    rows = torch.arange(P, dtype=torch.int64, device=phenx.device)[:, None]
    flat = (rows * n_phenx + torch.where(valid, phenx, 0)).reshape(-1)
    occ = torch.zeros(n_patients * n_phenx, dtype=torch.int32, device=phenx.device)
    occ.index_add_(0, flat, valid.reshape(-1).to(torch.int32))
    return occ.view(n_patients, n_phenx)


def identify(seq, dur, patient, mask, phenx, nevents, cfg: PostCovidConfig,
             n_patients: int, n_phenx: int, codec: str = "bit"):
    """Returns (pcc [P, V] bool, candidates [P, V] bool).

    Cohort rates are float64, as in the reference (64-bit division of
    integer counts)."""
    cnt, dmin, dmax = pair_tables(seq, dur, patient, mask, n_patients,
                                  n_phenx, codec)
    occ = occurrence_counts(phenx, nevents, n_patients, n_phenx)
    cv = cfg.covid_id
    spread = torch.where(cnt >= 1, dmax - dmin, -1)

    covid_cnt = cnt[:, cv, :]                      # [P, V]
    covid_spread = spread[:, cv, :]
    # a persisting run: >= min_occurrences spanning >= ~2 months after covid
    has_run = (covid_cnt >= cfg.min_occurrences) & \
              (covid_spread >= cfg.min_spread_days)
    # new onset: an s->covid sequence proves s occurred BEFORE the infection
    # (WHO: PCC symptoms are new after infection) — mined for free.
    new_onset = cnt[:, :, cv] == 0                 # [P, V]

    # cohort-level relevance (the vignette's correlation "significance",
    # MSMR-style): persisting *runs* of the code must be covid-associated,
    # which screens out background care codes (labs, visits) that form late
    # runs in covid and non-covid patients alike.  Run presence for any
    # patient comes free from the s->s diagonal of the pair tables: the
    # spread of a code against itself is its overall date spread.
    has_covid = occ[:, cv] >= 1                    # [P]
    present = occ >= 1                             # [P, V]
    self_spread = torch.diagonal(spread, dim1=1, dim2=2)   # [P, V]
    run_any = (occ >= cfg.min_occurrences) & \
              (self_spread >= cfg.min_spread_days)
    f64 = torch.float64
    n_cov = torch.clamp(torch.sum(has_covid), min=1).to(f64)
    n_non = torch.clamp(torch.sum(~has_covid), min=1).to(f64)
    runs_cov = torch.sum(run_any & has_covid[:, None], 0)
    rate_cov = runs_cov.to(f64) / n_cov
    rate_non = torch.sum(run_any & ~has_covid[:, None], 0).to(f64) / n_non
    covid_assoc = (rate_cov >= cfg.assoc_ratio_min
                   * torch.clamp(rate_non, min=1e-9)) \
        & (runs_cov >= cfg.assoc_support_min)      # [V]

    candidates = has_run & new_onset & covid_assoc[None, :]

    # exclusion by competing cause: c anchors the run locally (proximate,
    # same occurrence count and duration spread as the covid sequence — the
    # vectorized stand-in for corr == 1 on aligned duration series) ...
    aligned = (torch.abs(spread - covid_spread[:, None, :]) <= cfg.align_tol_days) \
        & (cnt == covid_cnt[:, None, :])
    proximate = (dmin >= 0) & (dmin <= cfg.proximity_days) & \
                (cnt >= cfg.min_occurrences)
    anchors = aligned & proximate                  # [P, Vc, Vs]
    V = cnt.shape[1]
    not_self = ~torch.eye(V, dtype=torch.bool, device=cnt.device)[None]  # c != s
    anchors &= not_self
    anchors[:, cv, :] = False                      # c != covid
    # ... and does so consistently across the cohort wherever c co-occurs
    # with an s-run (the "high correlation and significance" criterion):
    co_present = present[:, :, None] & has_run[:, None, :]   # [P, Vc, Vs]
    n_co = torch.sum(co_present, 0)                # [Vc, Vs]
    n_anchor = torch.sum(anchors & co_present, 0)
    cause_rate = n_anchor.to(f64) / torch.clamp(n_co, min=1).to(f64)
    significant = (cause_rate >= cfg.anchor_rate_min) & \
                  (n_co >= cfg.anchor_support_min)
    excluded = torch.any(anchors & significant[None], dim=1)  # [P, Vs]

    pcc = candidates & ~excluded
    pcc[:, cv] = False
    return pcc, candidates


def decode_symptoms(pcc, vocab) -> list[set[str]]:
    """[P, V] bool -> per-patient human-readable symptom sets (paper: back
    to fully human readable via the lookup tables)."""
    out = []
    pcc = np.asarray(pcc)
    for p in range(pcc.shape[0]):
        out.append({vocab.phenx_strings[int(v)] for v in np.nonzero(pcc[p])[0]})
    return out
