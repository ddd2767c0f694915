"""Global execution flags for analysis passes.

UNROLL_SCANS: in the reference, every ``lax.scan`` of the model zoo fully
unrolls when it is True, because XLA's cost analysis counts a while-loop
body once whatever its trip count, and only unrolled HLO gives the FLOPs
its cost-model validation holds ``analysis/costmodel`` against.  The
port's loops over layers, chunks and time steps are Python loops that
run every step eagerly, and ``torch.utils.flop_counter.FlopCounterMode``
counts each op as it runs, so the flag changes no count and no result
here.  It is kept so that code and tests written against the reference's
flag (its cost-model tests set it) run unchanged; ``scan_unroll()`` is
read by nothing in the port.
"""
UNROLL_SCANS = False


def scan_unroll():
    return True if UNROLL_SCANS else 1
