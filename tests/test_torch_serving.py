"""The port's LM serving engine against the reference's.

Weights come from the reference's init and cross with
``models.convert.from_jax_params``.  Greedy ``ServeEngine.run`` on both
sides, over 4 requests of mixed prompt lengths in 2 waves with an EOS
stop, must give each request the same tokens.  A token may differ only
where the reference's top-1/top-2 logit margin is under 1e-4 (a near
tie); the test then reports it and holds the logits, teacher-forced on
the reference's tokens, within 2e-5.  Temperature and top-k sampling draw
from a ``torch.Generator`` and cannot match ``jax.random`` bit for bit,
so only their properties are checked.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as j_model
from repro.serving import engine as j_engine
from repro.serving import sampling as j_sampling
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.models import model as model_lib
from repro_torch.serving import engine, sampling

NEAR_TIE = 1e-4


def _pair(arch, seed=0):
    jcfg = j_get_config(arch, reduced=True)
    jm = j_model.build(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(seed))
    cfg = get_config(arch, reduced=True)
    port = convert.from_jax_params(cfg, jax.tree.map(np.asarray, params))
    return cfg, jm, params, model_lib.build(cfg), port


def _requests(cfg, seed=0):
    """4 requests, prompt lengths 6, 9, 6, 9: two waves of batch 2."""
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(4, cfg.vocab_size, n).astype(np.int32), new)
            for rid, (n, new) in enumerate([(6, 10), (9, 12), (6, 7), (9, 12)])]


def _serve(eng, requests, cls):
    for rid, prompt, new in requests:
        eng.submit(cls(rid, prompt, max_new_tokens=new))
    return eng.run()


def _teacher_forced(apply, params, prompt, tokens, as_array):
    """Next-token logits after prompt + tokens[:t], for every t."""
    seq = np.concatenate([prompt, tokens[:-1]])[None].astype(np.int32)
    logits, _ = apply(params, {"tokens": as_array(seq)}, mode="train")
    return np.asarray(logits[0, len(prompt) - 1:], np.float32)


def _assert_same_or_near_tie(cfg, jm, params, mdl, port, prompt, got, want, rid):
    if len(got) == len(want) and (got == want).all():
        return
    n = min(len(got), len(want))
    t = int(np.argmax(got[:n] != want[:n])) if (got[:n] != want[:n]).any() else n
    ref = _teacher_forced(jm.apply, params, prompt, want, jnp.asarray)
    top2 = np.sort(ref[t])[-2:]
    margin = float(top2[1] - top2[0])
    print(f"request {rid}: token {t} differs (reference margin {margin:.3g})")
    assert margin < NEAR_TIE, f"request {rid}: token {t} differs at margin {margin}"
    port_logits = _teacher_forced(mdl.apply, port, prompt, want,
                                  lambda a: torch.from_numpy(a))
    np.testing.assert_allclose(port_logits, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch", ["tspm-mlho", "gemma2-2b"])
def test_greedy_engine_matches_reference(arch):
    cfg, jm, params, mdl, port = _pair(arch)
    requests = _requests(cfg)
    # the EOS id: request 1's fourth greedy token, so the stop and trim
    # rules run (a slot stops early, another runs to its budget)
    probe = _serve(j_engine.ServeEngine(jm, params, batch_size=2, max_len=32,
                                        eos_id=-1), requests, j_engine.Request)
    eos = int(probe[1][3])
    want = _serve(j_engine.ServeEngine(jm, params, batch_size=2, max_len=32,
                                       eos_id=eos), requests, j_engine.Request)
    eng = engine.ServeEngine(mdl, port, batch_size=2, max_len=32, eos_id=eos,
                             device="cpu")
    got = _serve(eng, requests, engine.Request)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    assert len(want[1]) <= 4 and want[1][-1] == eos
    for rid, prompt, _ in requests:
        assert got[rid].dtype == np.int32
        _assert_same_or_near_tie(cfg, jm, params, mdl, port, prompt, got[rid],
                                 np.asarray(want[rid]), rid)


def test_waves_are_length_bucketed_as_in_the_reference():
    """Wave 1 takes the first prompt length; the deferred request goes
    back behind the queue, so wave 2 is [3, 1], in both packages."""
    cfg, jm, params, mdl, port = _pair("tspm-mlho")
    engines = [(j_engine.ServeEngine(jm, params, batch_size=2, max_len=32),
                j_engine.Request),
               (engine.ServeEngine(mdl, port, batch_size=2, max_len=32, device="cpu"),
                engine.Request)]
    waves = []
    for eng, cls in engines:
        for rid, prompt, new in _requests(cfg):
            eng.submit(cls(rid, prompt, new))
        waves.append([[r.rid for r in eng._next_wave()] for _ in range(2)])
        assert eng.queue.empty()
    assert waves[0] == waves[1] == [[0, 2], [3, 1]]


def test_greedy_takes_the_first_maximal_index():
    logits = np.array([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0],
                       [-1.0, -2.0, -1.0, -3.0]], np.float32)
    got = sampling.sample(torch.from_numpy(logits))
    want = j_sampling.sample(jnp.asarray(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_temperature_and_top_k_properties():
    rng = np.random.default_rng(0)
    row = rng.standard_normal(50).astype(np.float32)
    row[7] = -1e30                                   # no support
    logits = torch.from_numpy(np.tile(row, (4000, 1)))
    g = torch.Generator("cpu").manual_seed(1)
    draws = sampling.sample(logits, g, temperature=1.0).numpy()
    assert draws.dtype == np.int32 and 7 not in draws
    assert len(np.unique(draws)) > 10
    top = set(np.argsort(row)[-3:].tolist())
    cut = sampling.sample(logits, g, temperature=0.7, top_k=3).numpy()
    assert set(np.unique(cut).tolist()) == top
    # the frequencies follow softmax(logits / T) over the top 3
    p = np.exp(row[sorted(top)] / 0.7)
    p /= p.sum()
    freq = np.array([(cut == i).mean() for i in sorted(top)])
    assert np.abs(freq - p).max() < 0.04
    a = sampling.sample(logits[:64], torch.Generator("cpu").manual_seed(5), 1.0, 10)
    b = sampling.sample(logits[:64], torch.Generator("cpu").manual_seed(5), 1.0, 10)
    assert torch.equal(a, b)


def test_temperature_engine_is_deterministic_under_one_generator():
    cfg = get_config("tspm-mlho", reduced=True)
    mdl = model_lib.build(cfg)
    params = mdl.init(device="cpu")
    outs = []
    for _ in range(2):
        eng = engine.ServeEngine(mdl, params, batch_size=2, max_len=32,
                                 temperature=0.9, device="cpu")
        for rid, prompt, new in _requests(cfg):
            eng.submit(engine.Request(rid, prompt, new))
        outs.append(eng.run(torch.Generator("cpu").manual_seed(11)))
    for rid in outs[0]:
        np.testing.assert_array_equal(outs[0][rid], outs[1][rid])
        assert ((0 <= outs[0][rid]) & (outs[0][rid] < cfg.vocab_size)).all()


def test_launcher_runs_on_the_cpu(capsys):
    results = serve.main(["--arch", "tspm-mlho", "--reduced", "--device", "cpu"])
    assert sorted(results) == list(range(8))
    assert all(len(v) <= 24 for v in results.values())
    assert "served 8 requests" in capsys.readouterr().out
    # the queries workload serves --queries queries, as the reference's
    # does; its waves and latencies depend on thread timing
    argv = ["--workload", "queries", "--patients", "24", "--queries", "48",
            "--clients", "8"]
    st = serve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert st["queries"] == 48 and 0 < st["waves"] <= 48
    assert "served 48 queries" in out and "cache hit ratio=" in out
    assert re.search(r"latency p50=[0-9.]+ms p99=[0-9.]+ms", out), out
    from repro.launch import serve as j_serve
    j_st = j_serve.main(argv)
    j_out = capsys.readouterr().out
    assert j_st["queries"] == st["queries"]
    served = r"serving ([0-9,]+) mined rows at tick (\d+)"
    assert re.search(served, out).groups() == re.search(served, j_out).groups()


def test_engine_and_launcher_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    cfg = get_config("tspm-mlho", reduced=True)
    mdl = model_lib.build(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.ServeEngine(mdl, mdl.init(device="cpu"), batch_size=2, max_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "tspm-mlho", "--reduced"])
