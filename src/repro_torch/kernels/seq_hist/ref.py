"""Plain PyTorch version of the histogram kernel: a scatter-add of the
masked bucket ids into an int32 table.  Ids outside ``[0, n_buckets)`` are
dropped, as the kernel drops them."""
from __future__ import annotations

import torch

from repro_torch.core.encoding import as_tensor


def hist_ref(h, mask, n_buckets: int) -> torch.Tensor:
    h = as_tensor(h, torch.int32).reshape(-1)
    m = as_tensor(mask, torch.bool).reshape(-1) & (h >= 0) & (h < n_buckets)
    out = torch.zeros(n_buckets, dtype=torch.int32, device=h.device)
    return out.scatter_add_(0, h.to(torch.int64) * m, m.to(torch.int32))
