"""Synthetic Synthea-style COVID cohort generator (paper's example data).

A numpy copy of the reference package's generator: the same seed draws the
same rows in the same order, so both packages mine the same cohort.

The paper ships a modified Synthea COVID-19 synthetic dbmart with its
R-package.  We generate an equivalent cohort programmatically, with ground
truth for the Post-COVID-19 (WHO definition) vignette:

  * every patient gets background noise events (labs, encounters, chronic
    condition codes) spread over ~3 years;
  * a fraction get COVID-19 at a random date;
  * "long covid" patients get 1-4 persistent symptoms recurring from ~1-4
    months post-infection over >= 2 months (WHO: ongoing >= 2 months);
  * control covid patients get transient symptoms (single occurrence or a
    short burst) and/or symptoms explained by a competing cause (e.g. an
    influenza episode immediately preceding the symptom run).

Returned ground truth: per-patient long-covid label + the symptom set.
"""
from __future__ import annotations

import dataclasses

import numpy as np

COVID = "COVID-19"
SYMPTOMS = [
    "Fatigue", "Dyspnea", "Brain fog", "Chest pain", "Anosmia",
    "Headache", "Joint pain", "Cough",
]
COMPETING = ["Influenza", "Pneumonia", "Asthma exacerbation"]
CHRONIC = ["Hypertension", "Type 2 diabetes", "Hyperlipidemia", "CKD stage 2"]
NOISE = [f"Lab panel {i}" for i in range(18)] + [
    "Office visit", "Telehealth visit", "Vaccination", "BMI measurement",
    "Blood pressure check", "Lipid screen",
]


@dataclasses.dataclass
class CohortTruth:
    long_covid: np.ndarray          # [P] bool
    symptom_sets: list[set[str]]    # per patient, ground-truth PCC symptoms
    covid_date: np.ndarray          # [P] int32, -1 if never infected


def generate_cohort(
    n_patients: int = 256,
    avg_events: int = 60,
    covid_frac: float = 0.6,
    long_covid_frac: float = 0.4,
    seed: int = 0,
):
    """Returns (patients, dates, phenx, truth) row lists + ground truth."""
    rng = np.random.default_rng(seed)
    patients: list[int] = []
    dates: list[int] = []
    phenx: list[str] = []
    truth_label = np.zeros(n_patients, bool)
    truth_date = np.full(n_patients, -1, np.int32)
    symptom_sets: list[set[str]] = []

    def add(p: int, d: int, x: str) -> None:
        patients.append(p)
        dates.append(int(max(d, 0)))
        phenx.append(x)

    for p in range(n_patients):
        horizon = 1095  # ~3 years of history
        n_noise = max(4, int(rng.poisson(avg_events)))
        for _ in range(n_noise):
            add(p, rng.integers(0, horizon), NOISE[rng.integers(len(NOISE))])
        for c in CHRONIC:
            if rng.random() < 0.25:
                d0 = rng.integers(0, horizon // 2)
                for k in range(rng.integers(1, 4)):
                    add(p, d0 + k * rng.integers(60, 180), c)

        symptoms: set[str] = set()
        if rng.random() < covid_frac:
            cd = int(rng.integers(120, horizon - 400))
            truth_date[p] = cd
            add(p, cd, COVID)
            if rng.random() < 0.5:  # acute-phase symptoms (resolve quickly)
                for s in rng.choice(SYMPTOMS, rng.integers(1, 3), replace=False):
                    add(p, cd + rng.integers(2, 14), str(s))
            if rng.random() < long_covid_frac:
                truth_label[p] = True
                for s in rng.choice(SYMPTOMS, rng.integers(1, 5), replace=False):
                    s = str(s)
                    symptoms.add(s)
                    onset = cd + int(rng.integers(30, 120))
                    # recurring for >= 2 months (WHO: ongoing two months)
                    for k in range(3 + int(rng.integers(0, 4))):
                        add(p, onset + k * int(rng.integers(28, 46)), s)
            else:
                # competing-cause symptom runs (must be excluded by pipeline)
                if rng.random() < 0.6:
                    cause = str(COMPETING[rng.integers(len(COMPETING))])
                    d0 = int(truth_date[p]) + int(rng.integers(150, 350))
                    add(p, d0, cause)
                    s = str(SYMPTOMS[rng.integers(len(SYMPTOMS))])
                    for k in range(3):
                        add(p, d0 + 3 + k * 30, s)
        symptom_sets.append(symptoms)

    return patients, dates, phenx, CohortTruth(truth_label, symptom_sets, truth_date)


def generate_benchmark_rows(n_patients: int, avg_events: int, seed: int = 0,
                            n_codes: int = 4000):
    """Flat numeric row generator for throughput benchmarks (paper Table 1/2
    scale: 4 985 patients x ~471 events; 35 000 x ~318).  Pure numpy, fast.
    """
    rng = np.random.default_rng(seed)
    counts = np.maximum(rng.poisson(avg_events, n_patients), 2)
    total = int(counts.sum())
    pid = np.repeat(np.arange(n_patients, dtype=np.int32), counts)
    date = rng.integers(0, 2000, total, dtype=np.int32)
    # zipfian-ish code popularity, like real EHR code frequency
    ranks = np.arange(1, n_codes + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    xid = rng.choice(n_codes, total, p=probs).astype(np.int32)
    return pid, date, xid, counts
