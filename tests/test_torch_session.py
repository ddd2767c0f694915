"""Port parity of the whole slice: MiningSession.fit (the batch, chunked,
files and stream engines under the sorted, hash and fused screens), the
incremental submit/tick/run frames, and every SequenceFrame terminal and
chained mask, plus core/msmr and core/postcovid, against the reference
package on the CPU."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import MiningConfig as JConfig
from repro.api import MiningSession as JSession
from repro.api import planner as j_planner
from repro.core import mining as j_mining
from repro.core import msmr as j_msmr
from repro.core import postcovid as j_postcovid
from repro.core import sparsity as j_sparsity
from repro.data import dbmart as j_dbmart
from repro.data import synthea as j_synthea
from repro_torch.api import MiningConfig, MiningSession
from repro_torch.api import planner as t_planner
from repro_torch.core import mining as t_mining
from repro_torch.core import msmr as t_msmr
from repro_torch.core import postcovid as t_postcovid
from repro_torch.data import dbmart as t_dbmart
from tests.conftest import random_dbmart
from tests.torch_parity import assert_same, port_db

ROOT = Path(__file__).resolve().parents[1]

# float tolerance of the MI scores: float32 log and division may differ in
# the last bits between XLA's and ATen's CPU kernels
MI_RTOL, MI_ATOL = 1e-5, 1e-7


@pytest.fixture(scope="module")
def cohort():
    pats, dates, phx, _ = j_synthea.generate_cohort(n_patients=28, avg_events=10,
                                                    seed=4)
    return j_dbmart.from_rows(pats, dates, phx)


def _chains(frame, covid, other):
    """Every chainable mask, alone and composed, keyed by name."""
    s = frame.screen()
    return {
        "all": frame, "screen": s, "screen2": frame.screen(2),
        "starts_with": frame.starts_with(covid), "ends_with": frame.ends_with(other),
        "min_duration": frame.min_duration(45),
        "transitive": s.transitive_ends_with(covid),
        "top_k": s.top_k(7),
        "chain": s.starts_with(covid).min_duration(20).top_k(3),
        "transitive_top": frame.transitive_ends_with(other).top_k(5),
    }


def _terminals(frame, covid, other) -> dict:
    """Every terminal of every chain, materialized as numpy / Python values.
    ``decode`` is compared in full on the small chains and on its 25 most
    supported ids elsewhere (the reference decodes one id at a time)."""
    out = {"len": len(frame)}
    for name, f in _chains(frame, covid, other).items():
        out[name, "n_kept"] = f.n_kept
        out[name, "collect"] = [np.asarray(a) for a in f.collect()]
        out[name, "unique"] = [np.asarray(a) for a in f.unique()]
        out[name, "arrays"] = [np.asarray(a) for a in f.arrays()]
        full = name in ("top_k", "chain", "transitive_top")
        out[name, "decode"] = f.decode(limit=None if full else 25)
    s = frame.screen()
    for k in (None, 4):
        fm = s.to_features(k=k)
        out["features", k] = [np.asarray(fm.x), np.asarray(fm.feature_ids),
                              int(fm.n_features)]
    return out


def _assert_terminals(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if isinstance(w, list) and w and isinstance(w[0], np.ndarray):
            for a, b in zip(g, w):
                assert_same(a, b, str(key))
        else:
            assert g == w, key


_REF = {}


def _ref_terminals(db, covid, other, **cfg) -> dict:
    """Reference session results, one fit per config for the module."""
    key = tuple(sorted(cfg.items()))
    if key not in _REF:
        _REF[key] = _terminals(JSession(JConfig(**cfg)).fit(db), covid, other)
    return _REF[key]


def _assert_result(got, want, what):
    for g, w, name in zip(got, want, ("seq", "dur", "patient", "support")):
        assert_same(g, w, f"{what} {name}")


def _assert_features(got, want, what):
    assert_same(got.x, want.x, f"{what} x")
    assert_same(got.feature_ids, want.feature_ids, f"{what} ids")
    assert int(got.n_features) == int(want.n_features)


@pytest.mark.parametrize("screen", ["sorted", "hash"])
@pytest.mark.parametrize("codec", ["bit", "paper"])
@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_session_matches_reference(cohort, screen, codec, fuse, backend):
    cfg = dict(threshold=3, screen=screen, codec=codec, fuse_duration=fuse,
               n_buckets_log2=10)
    v = cohort.vocab.phenx_index
    covid, other = v[j_synthea.COVID], v["Office visit"]
    want = _ref_terminals(cohort, covid, other, **cfg)
    jcfg = dataclasses.asdict(JConfig(**cfg))
    session = MiningSession(MiningConfig.from_dict({**jcfg, "backend": backend}),
                            device="cpu")
    got = _terminals(session.fit(port_db(cohort)), covid, other)
    assert session.plan().engine == "batch"
    _assert_terminals(got, want)


@pytest.mark.parametrize("case", range(3))
def test_session_random_dbmarts(case):
    db = random_dbmart(np.random.default_rng(40 + case), n_codes=6)
    for screen in ("sorted", "hash"):
        want = JSession(JConfig(threshold=2, screen=screen)).fit(db)
        for backend in ("kernel", "torch"):
            got = MiningSession(MiningConfig(threshold=2, screen=screen,
                                             backend=backend),
                                device="cpu").fit(port_db(db))
            _assert_result(got.screen().collect(), want.screen().collect(), screen)
            _assert_result(got.collect(), want.collect(), screen)


def test_session_empty_cohort():
    db = j_dbmart.DBMart(np.zeros((3, 8), np.int32), np.zeros((3, 8), np.int32),
                         np.zeros(3, np.int32))
    got = MiningSession(MiningConfig(threshold=1), device="cpu").fit(port_db(db))
    want = JSession(JConfig(threshold=1)).fit(db)
    _assert_result(got.screen().collect(), want.screen().collect(), "empty")
    assert got.to_features().x.shape == tuple(want.to_features().x.shape)


def test_session_first_occurrence_cohort():
    """The benchmark protocol's cohort (first-occurrence filter) mines to
    the same frame on both sides."""
    pid, date, xid, _ = j_synthea.generate_benchmark_rows(40, 50, seed=0)
    rows = (pid.tolist(), date.tolist(), [f"phx{v}" for v in xid.tolist()])
    db = j_dbmart.first_occurrence_filter(j_dbmart.from_rows(*rows))
    tdb = t_dbmart.first_occurrence_filter(t_dbmart.from_rows(*rows))
    want = JSession(JConfig(threshold=2, screen="hash")).fit(db)
    got = MiningSession(MiningConfig(threshold=2, screen="hash"),
                        device="cpu").fit(tdb)
    assert len(got) == int(t_mining.count_sequences(tdb.nevents))
    _assert_result(got.screen().collect(), want.screen().collect(), "hash")


def test_config_and_planner_plan_every_ported_option():
    assert MiningConfig().backend == "auto"
    assert MiningConfig.from_dict(dataclasses.asdict(JConfig())).backend == "torch"
    with pytest.raises(ValueError):
        MiningConfig(backend="jnp")
    with pytest.raises(TypeError):
        MiningConfig.from_dict({"no_such_knob": 1})
    nev = np.full(10, 40)
    ported = [dict(budget_bytes=1 << 10), dict(spill_bytes=10),
              dict(screen="fused", threshold=2), dict(engine="chunked"),
              dict(engine="stream"), dict(telemetry=True)]
    for kw in ported:                 # the reference's engine, on the CPU
        plan = t_planner.make_plan(MiningConfig(**kw), nev, device="cpu")
        assert plan.engine == j_planner.make_plan(JConfig(**kw), nev).engine, kw
        assert plan.corpus_free == (kw.get("screen") == "fused")
    # n_shards > 1 now plans the reference's engine and placement
    for kw in [dict(n_shards=2), dict(n_shards=4, placement="devices"),
               dict(n_shards=3, router="balance")]:
        for incremental in (False, True):
            plan = t_planner.make_plan(MiningConfig(**kw), nev, device="cpu",
                                       incremental=incremental)
            jplan = j_planner.make_plan(JConfig(**kw), nev, incremental=incremental)
            assert (plan.engine, plan.placement, plan.n_shards) == \
                (jplan.engine, jplan.placement, jplan.n_shards) == \
                ("sharded", jplan.placement, kw["n_shards"]), kw
    # one card has fewer devices than 4 shards: 'auto' gives 'host'
    assert t_planner.resolve_placement(MiningConfig(n_shards=4)) == "host"
    # the journal is ported: journal_dir plans the reference's engine
    for incremental in (False, True):
        plan = t_planner.make_plan(MiningConfig(journal_dir="journal"), nev,
                                   device="cpu", incremental=incremental)
        jplan = j_planner.make_plan(JConfig(journal_dir="journal"), nev,
                                    incremental=incremental)
        assert plan.engine == jplan.engine
    assert not hasattr(t_planner, "NOT_PORTED") and not hasattr(t_planner, "not_ported")
    plan = t_planner.make_plan(MiningConfig(budget_bytes=1 << 30), nev, device="cpu")
    jplan = j_planner.make_plan(JConfig(budget_bytes=1 << 30), nev)
    assert (plan.engine, plan.working_set_bytes, plan.corpus_bytes) == \
        (jplan.engine, jplan.working_set_bytes, jplan.corpus_bytes)
    # the planner's default device is the card, as the session's: 'auto'
    # then prices the kernel's dense layout, twice the triangular bytes
    dense = t_planner.make_plan(MiningConfig(budget_bytes=1 << 30), nev)
    assert dense.working_set_bytes == 2 * plan.working_set_bytes
    session = MiningSession(MiningConfig(), device="cpu")
    assert session.plan().engine == JSession(JConfig()).plan().engine == "stream"


def test_fused_plan_is_corpus_free():
    """Twin of the reference's test: under screen='fused' the working set
    is one patient block + the table, so a budget that forces chunking on
    the materializing path stays 'batch' on the fused one."""
    pats, dates, phx, _ = j_synthea.generate_cohort(n_patients=1024,
                                                    avg_events=16, seed=9)
    db = j_dbmart.from_rows(pats, dates, phx)
    budget = 1 << 24
    plans = {}
    for name, kw in (("dense", dict(screen="hash")),
                     ("fused", dict(threshold=3, screen="fused",
                                    n_buckets_log2=12))):
        plans[name] = MiningSession(MiningConfig(budget_bytes=budget, **kw),
                                    device="cpu").plan(port_db(db))
        jplan = JSession(JConfig(budget_bytes=budget, **kw)).plan(db)
        assert (plans[name].engine, plans[name].corpus_free) == \
            (jplan.engine, jplan.corpus_free), name
    dense, fused = plans["dense"], plans["fused"]
    assert dense.engine == "chunked" and not dense.corpus_free
    assert fused.engine == "batch" and fused.corpus_free
    assert fused.working_set_bytes < dense.working_set_bytes
    assert "corpus-free" in str(fused)


@pytest.fixture(scope="module")
def engine_cohort():
    pats, dates, phx, _ = j_synthea.generate_cohort(n_patients=32, avg_events=14,
                                                    seed=21)
    return j_dbmart.from_rows(pats, dates, phx)


_ENGINE_REF = {}


@pytest.mark.parametrize("screen", ["sorted", "hash", "fused"])
@pytest.mark.parametrize("engine", ["batch", "chunked", "files"])
def test_engines_match_reference(tmp_path, engine_cohort, engine, screen):
    """Every ported engine x screen: collect() and screen().collect()
    arrays byte-identical to the reference session's, with a budget that
    cuts the cohort into several chunks."""
    cfg = dict(engine=engine, screen=screen, threshold=3, n_buckets_log2=12,
               budget_bytes=48 << 10)
    key = (engine, screen)
    if key not in _ENGINE_REF:
        f = JSession(JConfig(**cfg)).fit(engine_cohort)
        _ENGINE_REF[key] = (f.collect(), f.screen().collect(), len(f))
    want_all, want_kept, want_len = _ENGINE_REF[key]
    if engine == "files":
        cfg["spill_dir"] = str(tmp_path / "spill")
    session = MiningSession(MiningConfig.from_dict(
        dataclasses.asdict(JConfig(**cfg))), device="cpu")
    frame = session.fit(port_db(engine_cohort))
    plan = session.plan()
    assert (plan.engine, plan.corpus_free) == (engine, screen == "fused")
    assert plan.n_chunks > 1
    assert len(frame) == want_len
    _assert_result(frame.collect(), want_all, f"{engine} {screen}")
    _assert_result(frame.screen().collect(), want_kept, f"{engine} {screen} kept")
    if engine == "files":
        names = sorted(os.listdir(cfg["spill_dir"]))
        assert "bucket_counts.npy" in names
        assert "chunk_00000.npz" in names


def test_fused_duration_engines_match_reference(engine_cohort):
    cfg = dict(screen="fused", threshold=2, n_buckets_log2=12,
               budget_bytes=48 << 10, fuse_duration=True)
    want = JSession(JConfig(**cfg)).fit(engine_cohort).screen().collect()
    for engine in ("batch", "chunked", "files"):
        got = MiningSession(MiningConfig(engine=engine, **cfg),
                            device="cpu").fit(port_db(engine_cohort))
        _assert_result(got.screen().collect(), want, engine)


def test_files_engine_cleans_tmp_spill(tmp_path, monkeypatch):
    import tempfile as tf

    monkeypatch.setattr(tf, "tempdir", str(tmp_path))
    db = port_db(random_dbmart(np.random.default_rng(5), n_patients=6,
                               max_events=10))
    MiningSession(MiningConfig(engine="files", threshold=1), device="cpu").fit(db)
    assert not [d for d in os.listdir(tmp_path) if d.startswith("tspm_spill_")]
    keep = tmp_path / "keep"
    MiningSession(MiningConfig(engine="files", threshold=1, spill_dir=str(keep)),
                  device="cpu").fit(db)
    assert (keep / "bucket_counts.npy").exists()


@pytest.mark.parametrize("screen", ["sorted", "hash", "fused"])
def test_stream_engine_matches_reference(engine_cohort, screen):
    """engine='stream' fit: collect() and screen().collect() arrays
    byte-identical to the reference session's, under eviction."""
    cfg = dict(engine="stream", screen=screen, threshold=3, n_buckets_log2=12,
               tick_patients=5, budget_bytes=48 << 10)
    want = JSession(JConfig(**cfg)).fit(engine_cohort)
    session = MiningSession(MiningConfig.from_dict(
        dataclasses.asdict(JConfig(**cfg))), device="cpu")
    got = session.fit(port_db(engine_cohort))
    assert session.plan().engine == "stream"
    assert session.service is None   # a fit keeps no live service
    _assert_result(got.collect(), want.collect(), screen)
    _assert_result(got.screen().collect(), want.screen().collect(), screen)
    assert got.screen().decode(limit=10) == want.screen().decode(limit=10)


@pytest.mark.parametrize("screen", ["hash", "fused"])
def test_incremental_frames_match_reference(engine_cohort, screen):
    """submit/tick/run on both sessions: every live frame equals the
    reference's, and the finished stream equals the batch fit."""
    cfg = dict(threshold=2, screen=screen, n_buckets_log2=10, tick_patients=6)
    js = JSession(JConfig(**cfg), vocab=engine_cohort.vocab)
    ts = MiningSession(MiningConfig(**cfg), device="cpu",
                       vocab=port_db(engine_cohort).vocab)
    db = engine_cohort
    for lo_frac, hi_frac in ((0.0, 0.5), (0.5, 1.0)):
        for p in range(db.n_patients):
            n = int(db.nevents[p])
            lo, hi = int(n * lo_frac), int(n * hi_frac)
            if hi > lo:
                for s in (js, ts):
                    s.submit(p, db.date[p, lo:hi], db.phenx[p, lo:hi])
        got, want = ts.tick(), js.tick()
        _assert_result(got.collect(), want.collect(), "tick")
        got, want = ts.run(), js.run()
        _assert_result(got.screen().collect(), want.screen().collect(), "run")
    assert ts.plan().incremental and ts.plan().engine == "stream"
    taps = ts.events(), js.events()
    ts.submit(0, [10**6], [1])
    js.submit(0, [10**6], [1])
    assert [type(e).__name__ for e in taps[0]] == ["DeltaSubmitted"] == \
        [type(e).__name__ for e in taps[1]]
    with pytest.raises(RuntimeError, match="already streaming"):
        ts.fit(port_db(db))
    batch = MiningSession(MiningConfig(**cfg), device="cpu").fit(port_db(db))
    _assert_result(ts.frame().collect(), batch.collect(), "stream == batch")


def test_journal_verify_replay_and_serve_match_reference(tmp_path):
    """The journal and query serving are ported:
    ``journal``, ``verify``, ``replay`` and ``serve`` give the reference's
    results; the sharded engine, checkpoint/restore and shard_load work
    as before."""
    from repro.serving.tspm import plan as j_plan
    from repro_torch.serving.tspm import plan

    s = MiningSession(MiningConfig(), device="cpu")
    assert s.journal() is None
    with pytest.raises(RuntimeError, match="nothing to verify"):
        s.verify()
    cfg = dict(tick_patients=2, threshold=1, screen="hash",
               journal_dir=str(tmp_path / "j"), journal_commit_every=1)
    sessions = []
    for cls, kw in ((JSession, {}), (MiningSession, {"device": "cpu"})):
        config = JConfig(**cfg) if cls is JSession else \
            MiningConfig(**cfg, backend="torch")
        js = cls(config, **kw)
        js.submit(0, [1, 2, 9], [3, 4, 6])
        js.submit(1, [5, 8], [4, 3])
        js.run()
        res = js.verify()
        assert res.ok, str(res)
        sessions.append((js, str(res), js.journal().n_entries))
        if cls is JSession:
            js.journal().close()
            for p in (tmp_path / "j").iterdir():
                p.unlink()
    (ref, ref_res, ref_n), (port, port_res, port_n) = sessions
    assert (port_res, port_n) == (ref_res, ref_n)
    replayed = MiningSession.replay(cfg["journal_dir"], device="cpu")
    jreplayed = JSession.replay(cfg["journal_dir"])
    for name in ("seq", "dur", "patient", "counts"):
        assert_same(getattr(replayed.service.snapshot(), name),
                    getattr(jreplayed.service.snapshot(), name), name)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MiningSession.replay(cfg["journal_dir"])
    keep = port.serve().query(plan().screen(2)).keep
    assert_same(keep, ref.serve().query(j_plan().screen(2)).keep)
    sharded = MiningSession(MiningConfig(n_shards=2), device="cpu")
    sharded.submit(0, [1, 2], [3, 4])
    assert sharded.plan().engine == "sharded" and len(sharded.run()) == 1
    assert len(sharded.shard_load()) == 2
    with pytest.raises(RuntimeError, match="sharded"):
        s.shard_load()


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MiningSession(MiningConfig(), device="cuda")
    with pytest.raises(RuntimeError):
        MiningSession(MiningConfig())   # the card is the default


def test_feature_matrix_and_mi_scores():
    db = random_dbmart(np.random.default_rng(2), n_patients=20, max_events=12)
    jm = j_mining.flatten(j_mining.mine_triangular(db.phenx, db.date, db.nevents))
    seq, dur, pat, msk = (np.array(a) for a in jm)
    _, _, _, u_key, u_sup, _ = j_sparsity.support_counts(seq, pat, msk)
    u_key, u_sup = np.array(u_key), np.array(u_sup)
    feats = t_msmr.top_sequences(u_key, u_sup, k=16)
    assert_same(feats, j_msmr.top_sequences(u_key, u_sup, k=16), "top")
    got = t_msmr.feature_matrix(seq, pat, msk, feats, n_patients=20)
    want = j_msmr.feature_matrix(seq, pat, msk, np.array(feats), n_patients=20)
    _assert_features(got, want, "feature_matrix")

    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 400)
    x = rng.integers(0, 2, (400, 8)).astype(np.float32)
    x[:, 3] = y
    x[:, 5] = np.where(rng.random(400) < 0.8, y, 1 - y)
    np.testing.assert_allclose(t_msmr.mi_scores(x, y).numpy(),
                               np.asarray(j_msmr.mi_scores(x, y)),
                               rtol=MI_RTOL, atol=MI_ATOL)
    x[:, 1] = y
    assert_same(t_msmr.select_jmi(x, y, k=4), j_msmr.select_jmi(x, y, k=4), "jmi")


@pytest.mark.parametrize("seed", [3, 13])
def test_postcovid_identify(seed):
    pats, dates, phx, _ = j_synthea.generate_cohort(n_patients=60, avg_events=20,
                                                    seed=seed)
    db = j_dbmart.from_rows(pats, dates, phx)
    cfg = dict(covid_id=db.vocab.phenx_index[j_synthea.COVID])
    jflat = j_mining.flatten(j_mining.mine(db.phenx, db.date, db.nevents,
                                           backend="jnp"))
    tflat = t_mining.flatten(t_mining.mine(db.phenx, db.date, db.nevents))
    want = j_postcovid.identify(*jflat, db.phenx, db.nevents,
                                j_postcovid.PostCovidConfig(**cfg),
                                db.n_patients, db.vocab.n_phenx)
    got = t_postcovid.identify(*tflat, db.phenx, db.nevents,
                               t_postcovid.PostCovidConfig(**cfg),
                               db.n_patients, db.vocab.n_phenx)
    for g, w, name in zip(got, want, ("pcc", "candidates")):
        assert_same(g, w, name)
    assert (t_postcovid.decode_symptoms(got[0], db.vocab)
            == j_postcovid.decode_symptoms(want[0], db.vocab))
    assert np.asarray(got[0]).any()


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)", re.M)


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys, repro_torch.api, repro_torch.core.msmr, "
            "repro_torch.core.postcovid, repro_torch.core.queries, "
            "repro_torch.core.chunking, repro_torch.analysis.roofline, "
            "repro_torch.kernels.tspm_fused.ops, repro_torch.kernels._build, "
            "repro_torch.kernels.tspm_delta.ops, repro_torch.obs, "
            "repro_torch.storage, repro_torch.stream, repro_torch.models, "
            "repro_torch.models.model, repro_torch.models.convert, "
            "repro_torch.serving, repro_torch.serving.engine, "
            "repro_torch.launch.serve, repro_torch.kernels.flash_attention.ops, "
            "repro_torch.data.tokenize, repro_torch.configs, "
            "repro_torch.launch.stream, repro_torch.launch.mesh, "
            "repro_torch.training.checkpoint, repro_torch.data.pipeline, "
            "repro_torch.distributed.sharding, repro_torch.core.baseline_tspm; "
            "[repro_torch.configs.get_config(a) for a in repro_torch.configs.ARCHS]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "assert not bad, bad")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT,
                   timeout=120)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if _IMPORT.search(f.read_text())]
    assert not offenders, offenders


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA the chip script exits non-zero and prints no result;
    alone in a directory (without the package) it fails too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_bytes((ROOT / "chip_smoke.py").read_bytes())
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("router", ["hash", "balance"])
@pytest.mark.parametrize("screen", ["hash", "fused"])
def test_sharded_fit_matches_reference(engine_cohort, router, screen):
    """engine='sharded' fit (the balanced router built from the cohort's
    event counts, auto-rebalancing on): collect() and screen().collect()
    byte-identical to the reference session's and to the batch engine."""
    cfg = dict(n_shards=3, router=router, screen=screen, threshold=2,
               n_buckets_log2=10, tick_patients=4, rebalance_every=2,
               imbalance_threshold=1.1)
    want = JSession(JConfig(**cfg)).fit(engine_cohort)
    session = MiningSession(MiningConfig(**cfg), device="cpu")
    got = session.fit(port_db(engine_cohort))
    assert session.plan().engine == "sharded" and session.plan().placement == "host"
    _assert_result(got.collect(), want.collect(), "sharded")
    _assert_result(got.screen().collect(), want.screen().collect(), "screened")
    batch = MiningSession(MiningConfig(screen=screen, threshold=2,
                                       n_buckets_log2=10), device="cpu")
    _assert_result(got.collect(), batch.fit(port_db(engine_cohort)).collect(),
                   "sharded == batch")


def test_incremental_sharded_and_guards():
    """Twin of tests/test_api.py::test_incremental_sharded_and_guards."""
    sess = MiningSession(MiningConfig(n_shards=3, tick_patients=2,
                                      n_buckets_log2=10), device="cpu")
    sess.submit("a", [1, 2], [3, 4])
    sess.submit("b", [1], [5])
    frame = sess.run()
    assert sess.plan().engine == "sharded"
    assert len(frame) == 1               # only patient 'a' mined one pair
    with pytest.raises(RuntimeError):
        sess.fit(port_db(random_dbmart(np.random.default_rng(0))))
    with pytest.raises(ValueError):
        MiningSession(MiningConfig(engine="batch"), device="cpu").submit("a", [1], [2])


def test_shard_load_fractions():
    """Twin of tests/test_obs.py::test_shard_load_fractions, through the
    session: busy fractions in [0, 1], something ran, the window resets."""
    rng = np.random.default_rng(4)
    db = port_db(random_dbmart(rng, n_patients=8, max_events=10))
    sess = MiningSession(MiningConfig(n_shards=2, tick_patients=3,
                                      n_buckets_log2=10), device="cpu")
    for p in range(db.n_patients):
        n = int(db.nevents[p])
        if n:
            sess.submit(p, db.date[p, :n], db.phenx[p, :n])
    sess.run()
    fracs = sess.shard_load()
    assert len(fracs) == 2 and all(0.0 <= f <= 1.0 for f in fracs)
    assert any(f > 0.0 for f in fracs)
    assert all(f < 0.5 for f in sess.shard_load())
