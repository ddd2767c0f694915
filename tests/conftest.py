import inspect
import sys
import types

import numpy as np
import pytest

try:
    from hypothesis import HealthCheck, settings

    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:
    # Offline environments ship without hypothesis.  Install a minimal stub
    # so test modules still *import* (they do `from hypothesis import given,
    # strategies as st` at module top); @given-decorated tests skip, every
    # other test in those modules runs normally.
    HAVE_HYPOTHESIS = False

    class _Strategy:
        def __call__(self, *a, **k):
            return self

        def __getattr__(self, name):
            return self

    def _given(*given_args, **given_kwargs):
        def deco(fn):
            # Mirror hypothesis: positional strategies bind the RIGHTMOST
            # params, keyword strategies bind by name.  The skipper keeps
            # the remaining params visible so parametrize args and
            # fixtures on @given tests still collect and inject.
            sig = inspect.signature(fn)
            params = list(sig.parameters.values())
            bound = set(given_kwargs)
            if given_args:
                bound |= {p.name for p in params[-len(given_args):]}

            def skipper(*a, **k):
                pytest.skip("hypothesis not installed")

            skipper.__name__ = fn.__name__
            skipper.__doc__ = fn.__doc__
            skipper.__signature__ = sig.replace(
                parameters=[p for p in params if p.name not in bound])
            skipper.pytestmark = list(getattr(fn, "pytestmark", []))
            return skipper

        return deco

    class _Settings:
        def __init__(self, *a, **k):
            pass

        def __call__(self, fn):
            return fn

        @staticmethod
        def register_profile(*a, **k):
            pass

        @staticmethod
        def load_profile(*a, **k):
            pass

    def _identity_deco(*a, **k):
        return lambda fn: fn

    _hyp = types.ModuleType("hypothesis")
    _st = types.ModuleType("hypothesis.strategies")
    _st.__getattr__ = lambda name: _Strategy()
    _hyp.strategies = _st
    _hyp.given = _given
    _hyp.settings = _Settings
    _hyp.seed = _identity_deco
    _hyp.example = _identity_deco
    _hyp.assume = lambda *a, **k: True
    _hyp.HealthCheck = _Strategy()
    _hyp.__stub__ = True
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st

def pytest_configure(config):
    # chaos/property suites (deep sweeps, hypothesis schedules) are marked
    # slow so tier-1 can stay fast with `-m "not slow"`
    config.addinivalue_line(
        "markers", "slow: deep chaos/property sweeps; deselect with "
        '-m "not slow"')
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where none is visible")


if HAVE_HYPOTHESIS:
    settings.register_profile(
        "repro",
        deadline=None,
        max_examples=25,
        suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
    )
    settings.load_profile("repro")


@pytest.fixture(scope="session")
def small_cohort():
    from repro.data import dbmart, synthea

    pats, dates, phx, truth = synthea.generate_cohort(
        n_patients=48, avg_events=24, seed=5)
    return dbmart.from_rows(pats, dates, phx), truth


def brute_force_pairs(db):
    """Independent O(n^2) oracle: set of (patient, start, end, duration)."""
    out = []
    for p in range(db.n_patients):
        n = int(db.nevents[p])
        for i in range(n):
            for j in range(i + 1, n):
                out.append((p, int(db.phenx[p, i]), int(db.phenx[p, j]),
                            int(db.date[p, j]) - int(db.date[p, i])))
    return out


@pytest.fixture
def brute_force():
    return brute_force_pairs


def random_dbmart(rng: np.random.Generator, n_patients=None, max_events=None,
                  n_codes=None, date_range=400):
    """Random numeric dbmart for property tests."""
    from repro.data.dbmart import DBMart

    P = n_patients or int(rng.integers(1, 12))
    E = max_events or int(rng.integers(2, 24))
    V = n_codes or int(rng.integers(2, 30))
    nevents = rng.integers(0, E + 1, P).astype(np.int32)
    e_pad = -(-max(int(nevents.max(initial=1)), 1) // 8) * 8
    phenx = rng.integers(0, V, (P, e_pad)).astype(np.int32)
    date = np.sort(rng.integers(0, date_range, (P, e_pad)).astype(np.int32), axis=1)
    for p in range(P):
        n = int(nevents[p])
        if n < e_pad:
            date[p, n:] = date[p, n - 1] if n else 0
    return DBMart(phenx, date, nevents, None)
