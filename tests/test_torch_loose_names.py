"""The reference's last loose public names, on the CPU:
``core.sparsity.HASH_MULT`` and ``obs.jit_cache_size``."""
import numpy as np

import repro.obs as j_obs
from repro.core import sparsity as j_sparsity
from repro_torch import obs
from repro_torch.core import sparsity
from repro_torch.stream.service import StreamService


def test_hash_mult_is_the_references_and_the_hash_constant():
    assert sparsity.HASH_MULT == j_sparsity.HASH_MULT == 0x9E3779B97F4A7C15
    assert sparsity._HASH_K % (1 << 64) == sparsity.HASH_MULT
    assert np.int64(sparsity._HASH_K) == np.asarray(j_sparsity._HASH_K)


def test_jit_cache_size_reads_what_the_retrace_tracker_reads():
    """The reference's name counts the hot functions' shape
    specializations, as ``RetraceTracker`` does, before and after a
    stream runs new shapes."""
    assert obs.jit_cache_size.__name__ == "specialization_count"
    assert "jit_cache_size" in dir(j_obs) and "jit_cache_size" in dir(obs)
    fns = obs.default_hot_functions()
    tracker = obs.RetraceTracker(fns)
    before = obs.jit_cache_size(fns)
    assert before == obs.specialization_count(fns) == tracker.total()
    svc = StreamService(tick_patients=4, n_buckets_log2=12, device="cpu")
    rng = np.random.default_rng(3)
    for k in range(6):
        n = int(rng.integers(1, 5))
        svc.submit(k, np.arange(n, dtype=np.int32), rng.integers(0, 5, n).astype(np.int32))
    svc.run()
    after = obs.jit_cache_size(fns)
    assert after == obs.specialization_count(fns) == tracker.total()
    assert tracker.sample() == after - before
