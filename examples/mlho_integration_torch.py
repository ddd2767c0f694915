"""Vignette 1 — tSPM+ inside an MLHO-style ML workflow, on the PyTorch port.

    PYTHONPATH=src python examples/mlho_integration_torch.py               # the card
    PYTHONPATH=src python examples/mlho_integration_torch.py --device cpu

The twin of ``examples/mlho_integration.py`` on ``repro_torch``: it prints
the same lines.  ``MiningSession.fit`` -> top-1000 sequences by support ->
``SequenceFrame.to_features`` (patient x sequence matrix) -> JMI
re-ranking (core.msmr) -> logistic regression (full-batch gradient
descent from zero weights, as the original's, on the device) ->
translate the most predictive sequences back to human-readable strings.
The task: predict long-COVID status from mined sequences.  The
train/test split draws from numpy's generator, as the original's does,
so both split the same patients.
"""
import argparse

import numpy as np
import torch

from repro_torch.api import MiningConfig, MiningSession
from repro_torch.core import msmr
from repro_torch.data import dbmart, synthea


def train_logreg(x, y, steps=400, lr=0.5):
    """Logistic regression with an L2 penalty of 1e-3, ``steps`` gradient
    steps of ``lr`` from zero weights (float32, on ``x``'s device)."""
    w = torch.zeros(x.shape[1], device=x.device, requires_grad=True)
    b = torch.zeros((), device=x.device, requires_grad=True)
    for _ in range(steps):
        z = x @ w + b
        loss = torch.mean(torch.logaddexp(torch.zeros_like(z), z) - y * z) \
            + 1e-3 * (w @ w)
        gw, gb = torch.autograd.grad(loss, (w, b))
        with torch.no_grad():
            w -= lr * gw
            b -= lr * gb
    return w.detach(), b.detach()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--patients", type=int, default=400)
    ap.add_argument("--avg-events", type=int, default=40)
    args = ap.parse_args(argv)
    pats, dates, phx, truth = synthea.generate_cohort(
        n_patients=args.patients, avg_events=args.avg_events, seed=11)
    db = dbmart.from_rows(pats, dates, phx)
    y = truth.long_covid.astype(np.float32)

    # mine + MSMR front half: one façade chain
    session = MiningSession(MiningConfig(), device=args.device)
    frame = session.fit(db)
    fm = frame.to_features(k=1000)
    x_all = fm.x.cpu().numpy()
    sel = msmr.select_jmi(x_all, y, k=32)
    x = torch.from_numpy(x_all[:, sel]).to(session.device)
    print(f"features: {fm.x.shape[1]} screened -> {x.shape[1]} after JMI")

    # train/test split + classifier
    rng = np.random.default_rng(0)
    idx = rng.permutation(db.n_patients)
    n_train = 4 * db.n_patients // 5        # the original's 320 of 400
    tr, te = idx[:n_train], idx[n_train:]
    y_dev = torch.from_numpy(y).to(session.device)
    w, b = train_logreg(x[tr], y_dev[tr])
    pred = torch.sigmoid(x[te] @ w + b).cpu().numpy()
    pos = pred[y[te] == 1]
    neg = pred[y[te] == 0]
    if len(pos) and len(neg):
        auc = (pos[:, None] > neg[None, :]).mean() + \
            0.5 * (pos[:, None] == neg[None, :]).mean()
    else:
        auc = float("nan")
    acc = ((pred > 0.5) == y[te]).mean()
    print(f"held-out: accuracy={acc:.3f} AUC={auc:.3f}")

    # translate the most predictive sequences back (paper: human readable)
    w_np = w.cpu().numpy()
    feats_np = fm.feature_ids.cpu().numpy()[sel]
    print("\nmost predictive transitive sequences:")
    for i in np.argsort(-np.abs(w_np))[:6]:
        print(f"  {db.vocab.decode_sequence(int(feats_np[i])):55s} "
              f"w={w_np[i]:+.2f}")
    return w_np, float(b)


if __name__ == "__main__":
    main()
