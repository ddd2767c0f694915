"""The port's original-tSPM baseline and the example twins, on the CPU.

``core/baseline_tspm`` (string mining, the dictionary screen) must equal
the reference's list for list; ``examples/postcovid_torch.py`` must print
exactly what ``examples/postcovid.py`` prints on the same cohort,
``examples/quickstart_torch.py`` what ``examples/quickstart.py`` prints,
and ``examples/mlho_integration_torch.py`` what
``examples/mlho_integration.py`` prints, with its logistic regression's weights within ``LOGREG_TOL`` of
the original's (float32 gradient steps; the original has no test of its
own, so the tolerance is 1e-5).
"""
import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baseline_tspm as j_baseline
from repro.data import dbmart as j_dbmart
from repro.data import synthea as j_synthea
from repro_torch.core import baseline_tspm
from tests.conftest import random_dbmart
from tests.torch_parity import port_db

ROOT = Path(__file__).resolve().parents[1]
LOGREG_TOL = 1e-5


def load_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_baseline_equals_reference(seed):
    rng = np.random.default_rng(seed)
    dbs = [random_dbmart(rng, n_patients=8, max_events=12)]
    pats, dates, phx, _ = j_synthea.generate_cohort(n_patients=6, avg_events=9,
                                                    seed=seed)
    dbs.append(j_dbmart.from_rows(pats, dates, phx))    # with a vocab
    for db in dbs:
        got = baseline_tspm.mine_strings(port_db(db))
        assert got == j_baseline.mine_strings(db)
        for thr in (1, 2, 3):
            assert baseline_tspm.sparsity_screen(got, thr) == \
                j_baseline.sparsity_screen(got, thr)
            assert baseline_tspm.mine_and_screen(port_db(db), thr) == \
                j_baseline.mine_and_screen(db, thr)
        assert baseline_tspm.mine_and_screen(port_db(db)) == got


def test_postcovid_twin_prints_the_original(capsys):
    """At a small cohort (the original's generator, cut to 96 patients of
    ~30 events), the twin prints the original's lines byte for byte."""
    original = load_example("postcovid")
    cut = dict(n_patients=96, avg_events=30)
    original.synthea = types.SimpleNamespace(
        COVID=j_synthea.COVID,
        generate_cohort=lambda **kw: j_synthea.generate_cohort(**{**kw, **cut}))
    original.main()
    want = capsys.readouterr().out
    load_example("postcovid_torch").main(
        ["--device", "cpu", "--patients", "96", "--avg-events", "30"])
    got = capsys.readouterr().out
    assert "predicted PCC" in got and got == want


def test_mlho_twin_matches_the_original(capsys):
    original = load_example("mlho_integration")
    twin = load_example("mlho_integration_torch")
    rng = np.random.default_rng(5)
    x = (rng.random((64, 12)) < 0.3).astype(np.float32)
    y = (rng.random(64) < 0.4).astype(np.float32)
    w, b = original.train_logreg(jnp.asarray(x), jnp.asarray(y))
    tw, tb = twin.train_logreg(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(tw.numpy(), np.asarray(w), rtol=LOGREG_TOL,
                               atol=LOGREG_TOL)
    np.testing.assert_allclose(float(tb), float(b), rtol=LOGREG_TOL,
                               atol=LOGREG_TOL)
    original.main()
    want = capsys.readouterr().out
    twin.main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert "held-out" in got and got == want


def test_quickstart_twin_prints_the_original(capsys):
    """The quickstart twin on the CPU prints the original's lines, line
    for line (the plan's repr included: no line is exempt), through the
    batch fit, the fused screen, the checkpointed stream and the query
    server."""
    load_example("quickstart").main()
    want = capsys.readouterr().out
    load_example("quickstart_torch").main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert "served 3 queries" in got and "MiningPlan(engine=" in got
    assert got.splitlines() == want.splitlines()
