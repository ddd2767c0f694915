"""Pair-generation kernel: the reference's Pallas kernel (interpret mode)
vs the port's wrapper on CPU tensors (its plain version).  The CUDA kernel
is held against that plain version in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from repro.kernels.tspm_pairgen import ops as j_ops
from repro_torch.kernels.tspm_pairgen import ops as t_ops
from tests.conftest import random_dbmart
from tests.torch_parity import assert_same


def _assert_mined(got, want, what=""):
    for g, w, name in zip(got, want, ("seq", "dur", "mask")):
        assert_same(g, w, f"{what} {name}")


@pytest.mark.parametrize("P,E", [(1, 8), (3, 16), (7, 129)])
def test_wrapper_matches_pallas_kernel(P, E):
    db = random_dbmart(np.random.default_rng(P * 1000 + E),
                       n_patients=P, max_events=E)
    before = t_ops.pairgen.launches
    got = t_ops.pairgen(torch.from_numpy(db.phenx), torch.from_numpy(db.date),
                        torch.from_numpy(db.nevents))
    want = j_ops.pairgen(db.phenx, db.date, db.nevents, interpret=True)
    _assert_mined(got, want, f"P={P} E={E}")
    assert t_ops.pairgen.launches == before  # a CPU tensor never launches


@pytest.mark.parametrize("codec", ["bit", "paper"])
@pytest.mark.parametrize("fuse", [False, True])
def test_wrapper_codecs_and_fusion(codec, fuse):
    db = random_dbmart(np.random.default_rng(5), n_patients=6, max_events=20)
    got = t_ops.pairgen(db.phenx, db.date, db.nevents, codec=codec,
                        fuse_duration=fuse, bucket_days=7)
    want = j_ops.pairgen(db.phenx, db.date, db.nevents, codec=codec,
                         fuse_duration=fuse, bucket_days=7, interpret=True)
    _assert_mined(got, want, f"{codec} fuse={fuse}")


def test_wrapper_rejects_other_devices():
    meta = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        t_ops.pairgen(meta, meta, torch.zeros(2, dtype=torch.int32, device="meta"))
