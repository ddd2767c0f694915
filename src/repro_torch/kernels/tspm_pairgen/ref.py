"""Plain PyTorch version of the pair-generation kernel (dense layout).

It is :func:`repro_torch.core.mining.mine_dense`, the dense-layout mining
reference: the kernel's output must equal it byte for byte, padding
included (``SENTINEL`` ids, zero durations, a false mask below the
diagonal and past ``nevents``).
"""
from __future__ import annotations

from repro_torch.core.mining import Mined, mine_dense


def pairgen_ref(phenx, date, nevents, codec: str = "bit",
                fuse_duration: bool = False, bucket_days: int = 30) -> Mined:
    return mine_dense(phenx, date, nevents, codec, fuse_duration, bucket_days)
