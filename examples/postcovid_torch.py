"""Vignette 2 — identify Post-COVID-19 patients, on the PyTorch port.

    PYTHONPATH=src python examples/postcovid_torch.py               # the card
    PYTHONPATH=src python examples/postcovid_torch.py --device cpu

The twin of ``examples/postcovid.py`` on ``repro_torch``; it prints the
same lines.  ``MiningSession.fit`` mines the cohort on the device (any
engine — the planner picks); ``SequenceFrame.arrays()`` hands the
canonical flat corpus to the WHO-rule identifier (core.postcovid, on the
same device): a PCC symptom starts after infection, persists >= 2 months
(duration spread of covid->symptom sequences), is new-onset, and is not
explained by a competing cause.
"""
import argparse

import torch

from repro_torch.api import MiningConfig, MiningSession
from repro_torch.core import postcovid
from repro_torch.data import dbmart, synthea


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--patients", type=int, default=240)
    ap.add_argument("--avg-events", type=int, default=44)
    args = ap.parse_args(argv)
    pats, dates, phx, truth = synthea.generate_cohort(
        n_patients=args.patients, avg_events=args.avg_events, seed=7)
    db = dbmart.from_rows(pats, dates, phx)
    session = MiningSession(MiningConfig(), device=args.device)
    flat = session.fit(db).arrays()

    def on_device(a):
        return torch.from_numpy(a).to(session.device)

    cfg = postcovid.PostCovidConfig(
        covid_id=db.vocab.phenx_index[synthea.COVID])
    pcc, candidates = postcovid.identify(
        *map(on_device, flat), on_device(db.phenx), on_device(db.nevents),
        cfg, db.n_patients, db.vocab.n_phenx)
    pcc = pcc.cpu().numpy()
    pred = postcovid.decode_symptoms(pcc, db.vocab)

    n_pred = int(pcc.any(1).sum())
    print(f"cohort: {db.n_patients} patients | predicted PCC: {n_pred} | "
          f"ground truth: {int(truth.long_covid.sum())}")

    tp = fp = fn = 0
    for p in range(db.n_patients):
        t, pr = truth.symptom_sets[p], pred[p]
        tp += len(t & pr)
        fp += len(pr - t)
        fn += len(t - pr)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    print(f"symptom-level: precision={prec:.3f} recall={rec:.3f}")

    print("\nexample patients:")
    shown = 0
    for p in range(db.n_patients):
        if pred[p] and shown < 5:
            print(f"  patient {p}: {sorted(pred[p])} "
                  f"(truth: {sorted(truth.symptom_sets[p])})")
            shown += 1


if __name__ == "__main__":
    main()
