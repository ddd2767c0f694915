"""Checkpoint state trees: JSON structure + numpy leaves, split apart.

A session checkpoint is a nested python structure (dicts, lists,
scalars) whose leaves include numpy arrays — the services'
``state_dict()`` trees.  An on-disk layout of ``arrays.npz`` +
``manifest.json`` wants arrays and JSON separated, so:

  * :func:`pack_tree`   — walk the structure, pull every ndarray into a
    flat list, and leave an ``{"__ndarray__": i}`` placeholder behind;
  * :func:`unpack_tree` — the exact inverse (npz round-trips dtype and
    shape, so the reassembled tree is byte-identical).

Scalars must already be JSON-able; numpy scalar types are normalized to
python ints/floats so a manifest never depends on numpy repr.
"""
from __future__ import annotations

import numpy as np

_MARK = "__ndarray__"


def pack_tree(obj, arrays: list | None = None):
    """-> (json_obj, arrays): ndarrays replaced by indexed placeholders."""
    if arrays is None:
        arrays = []

    def walk(x):
        if isinstance(x, np.ndarray):
            arrays.append(x)
            return {_MARK: len(arrays) - 1}
        if isinstance(x, dict):
            if _MARK in x:
                raise ValueError(f"state tree dict uses reserved key {_MARK}")
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        if isinstance(x, (np.integer,)):
            return int(x)
        if isinstance(x, (np.floating,)):
            return float(x)
        if isinstance(x, (np.bool_,)):
            return bool(x)
        if x is None or isinstance(x, (bool, int, float, str)):
            return x
        raise TypeError(f"state tree leaf {x!r} ({type(x).__name__}) is "
                        "not JSON-serializable")

    return walk(obj), arrays


def unpack_tree(json_obj, arrays):
    """Inverse of :func:`pack_tree` (tuples come back as lists)."""

    def walk(x):
        if isinstance(x, dict):
            if set(x) == {_MARK}:
                return np.asarray(arrays[x[_MARK]])
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x

    return walk(json_obj)
