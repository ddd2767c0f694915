"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; the
reference runs on JAX's CPU backend, the port on CPU tensors.  Integer and
bool results must agree byte for byte, dtype and shape included.
"""
import numpy as np
import torch

from repro_torch.data import dbmart as t_dbmart


def to_numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(port, ref, what: str = "") -> None:
    """Byte equality of a port result and a reference result."""
    a, b = to_numpy(port), to_numpy(ref)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    assert a.tobytes() == b.tobytes(), f"{what}: bytes differ"


def port_db(db):
    """The reference DBMart carried across with ``from_arrays``."""
    v = db.vocab
    return t_dbmart.from_arrays(
        db.phenx, db.date, db.nevents,
        None if v is None else v.phenx_strings,
        None if v is None else v.patient_keys)
