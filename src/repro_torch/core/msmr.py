"""MSMR-lite: Minimize-Sparsity-Maximize-Relevance feature selection.

The MLHO vignette pipes screened sequences through MSMR (Estiri et al.):
sparsity screening, then (joint) mutual information against the label to
keep the top-K most relevant sequences.  This module builds the
patient x sequence feature matrix from mined ids and ranks features by
mutual information, with an optional greedy JMI pass.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.encoding import SENTINEL, as_tensor


class FeatureMatrix(NamedTuple):
    x: torch.Tensor            # [P, K] float32 binary presence
    feature_ids: torch.Tensor  # [K] int64 sequence ids (sentinel padded)
    n_features: torch.Tensor   # scalar


def top_sequences(u_ids, u_support, k: int) -> torch.Tensor:
    """Top-k unique sequence ids by support (ties keep id order)."""
    u_ids = as_tensor(u_ids, torch.int64)
    u_support = as_tensor(u_support, torch.int32)
    order = torch.argsort(-torch.where(u_ids != SENTINEL, u_support, -1),
                          stable=True)
    return torch.sort(u_ids[order][:k]).values  # sorted for binary search


def feature_matrix(seq, patient, mask, feature_ids, n_patients: int) -> FeatureMatrix:
    """Binary presence matrix via binary search into sorted feature ids."""
    seq = as_tensor(seq, torch.int64).reshape(-1)
    patient = as_tensor(patient, torch.int32).reshape(-1)
    mask = as_tensor(mask, torch.bool).reshape(-1)
    feature_ids = as_tensor(feature_ids, torch.int64)
    k = feature_ids.shape[0]
    idx = torch.clamp(torch.searchsorted(feature_ids, seq), 0, k - 1)
    hit = (feature_ids[idx] == seq) & mask & (seq != SENTINEL)
    x = torch.zeros((n_patients, k), dtype=torch.float32, device=seq.device)
    x[patient[hit].to(torch.int64), idx[hit]] = 1.0
    return FeatureMatrix(x, feature_ids, torch.sum(feature_ids != SENTINEL))


def _mi_binary(x, y):
    """MI(feature; label) for binary feature columns x [P, K], labels y [P]."""
    y = y.to(torch.float32)[:, None]
    p = x.shape[0]
    eps = 1e-9
    p1 = x.mean(0)
    py = y.mean()
    p11 = (x * y).sum(0) / p
    mi = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for xv in (0, 1):
        for yv in (0, 1):
            if (xv, yv) == (1, 1):
                pxy = p11
            elif (xv, yv) == (1, 0):
                pxy = p1 - p11
            elif (xv, yv) == (0, 1):
                pxy = py - p11
            else:
                pxy = 1 - p1 - py + p11
            px = p1 if xv else 1 - p1
            pyv = py if yv else 1 - py
            mi += pxy * (torch.log(pxy + eps) - torch.log(px + eps)
                         - torch.log(pyv + eps))
    return mi


def mi_scores(x, y) -> torch.Tensor:
    return _mi_binary(as_tensor(x, torch.float32), torch.as_tensor(y))


def select_jmi(x, y, k: int) -> np.ndarray:
    """Greedy JMI: argmax_f sum_{s in S} I(f, s; y), seeded by max MI.

    Joint MI of a feature pair is computed on the 4-valued joint variable
    (2 bits).  Host-side numpy loop (k is small, e.g. 200)."""
    x = np.asarray(x) > 0.5
    y = np.asarray(y) > 0.5
    P, K = x.shape
    k = min(k, K)
    base = mi_scores(x, y).cpu().numpy()
    selected = [int(np.argmax(base))]
    scores = np.zeros(K)
    for _ in range(k - 1):
        s = x[:, selected[-1]]
        joint = x.astype(np.int8) * 2 + s[:, None]  # [P, K] in {0..3}
        for v in range(4):
            xv = joint == v
            pv = xv.mean(0)
            p1 = (xv & y[:, None]).mean(0)
            p0 = pv - p1
            py = y.mean()
            eps = 1e-12
            scores += p1 * (np.log(p1 + eps) - np.log(pv + eps) - np.log(py + eps))
            scores += p0 * (np.log(p0 + eps) - np.log(pv + eps) - np.log(1 - py + eps))
        masked = scores.copy()
        masked[selected] = -np.inf
        selected.append(int(np.argmax(masked)))
    return np.asarray(selected, np.int32)
