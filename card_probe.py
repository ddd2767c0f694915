"""Measurements of the PyTorch/CUDA port on one NVIDIA GPU that the smoke
test (``chip_smoke.py``) does not take.

Run from the root of a checkout, with one visible CUDA device:

    python3 card_probe.py [idle] [share] [price] [scratch] [flex] [psplit] [tf32] [count]
                          [logits] [bwd] [lse] [widths] [step] [steptrace] [moe]

(all when none is named; ``lse``, ``widths`` and ``step`` only with
``CARD_PROBE_BASE`` set).
Each prints one JSON line:

  idle   the device's idle share on the streaming path at the paper's
         Table 1 cohort: a ``torch.profiler`` trace (CUDA activity only) of
         the stream fit and of the 8-wave replay, the union of the device's
         kernel, copy and memset intervals against the host wall of the run,
         with device seconds by category and the ten longest kernels;
  share  the split of a chunk's card budget between the slab and the scratch
         of one piece (``chunking.CARD_SCRATCH_SHARE``) at the Table 2
         cohort and a 4 GiB budget: chunks, piece launches, peak device
         memory, the device passes of every chunk (mine, hash counts,
         compaction, ended by a synchronize) and the whole ``fit``;
  price  each chunked fit's peak device memory against the priciest
         chunk's price (``ChunkPlan.chunk_bytes``) and the budget, at several
         budgets, with each pass's peak over that chunk run alone;
  scratch the device bytes each pass of a chunk takes beyond what it is
         given, at pieces of 1 to 64 Table 1 patient rows: the mine (per
         slot of the chunk), the hash counts, the compaction and the
         survivors' screen (per slot of the piece), with a line fitted
         through them (bytes = fixed + per_slot * slots);
  flex   the library yardstick of ``flash_attention``'s wgmma route:
         ``torch.nn.attention.flex_attention``, compiled once, with a
         ``score_mod`` for gemma2-2b's tanh softcap and a causal (local:
         and windowed) block mask, first held against ``attention_ref``
         (max |diff|, elements beyond the smoke's bfloat16 limit and beyond
         the reference test's 2e-2 + 2e-2 |want|), then timed at both
         gemma2-2b layer shapes in turns with the kernel (kernel, flex,
         flex, kernel); the port never calls it;
  psplit the wgmma route's P in bfloat16 hi + lo (what it ships) against P
         in bfloat16 alone (the probe entry ``flash_attention_wgmma_p_bf16``),
         in turns, at phase 3b's window-4,096 case and both gemma2-2b layer
         shapes: ms, max |diff| and elements beyond the smoke's bfloat16
         limit;
  tf32   where the tf32x3 route's time goes at tspm-mlho's prefill shape
         (q [8,12,896,64], k/v [8,4,896,64], float32, causal): the route,
         the ffma route and the route with P V as P_hi V_hi alone (the probe
         entry ``flash_attention_tf32x3_pv_hi``: the value product's lo
         terms taken out), timed in turns (a, b, c, c, b, a), each with max
         |diff| and the elements beyond the smoke's float32 limit; the device
         time of the route's pre-pass and main kernel, and of the variant's,
         from a ``torch.profiler`` trace; and the card's name and power
         limit;
  count  the partitioned counting kernels (``csrc/bucket_count.cuh``)
         and the kernels before the partitioned design (global atomics),
         timed in turns (new, old, old, new) at a Table 1 fit block
         (``seq_hist``, H = 20) and at Table 2's cohort (``tspm_fused``,
         H = 20), all tables equal, with each kernel's device time from a
         ``torch.profiler`` trace; and ``seq_hist``'s partitioned route
         against its global route (the old kernel) on the block's leading
         2^18..2^26 ids, whole calls in turns: the crossover behind
         ``ops.GLOBAL_MAX_ELEMENTS``;
  logits what phase 9's logit check (the card's first tspm-mlho wave
         against the CPU's, ``smoke.LM_LOGIT_TOL``) reads and what moves
         it: at three seeded weight sets, ``smoke.logit_diff`` of the card
         against the CPU in float32 (the smoke's reference), in float64 (the
         model's float32 tensors and upcasts made float64), and, at the
         first set, one CPU thread and the AVX2 code paths of MKL and ATen;
         each CPU run in float32 against float64; and whether the card's
         wave repeats bit for bit, alone and beside a thread that keeps
         matmuls running on another stream.  The CPU runs are subprocesses
         of this script (``--logits-worker``) that read the weights it saved;
  lse    what the forward's log-sum-exp costs serving: the wgmma route at
         both gemma2-2b layer shapes and the tf32x3 route at tspm-mlho's
         prefill shape, each launched with a null log-sum-exp pointer (as
         serving launches it), with the pointer (as training does) and as
         the checkout at ``$CARD_PROBE_BASE`` builds it (its
         ``flash_attention.cu``, compiled with the port's flags into
         ``build/probes/``; a source whose entries take no log-sum-exp,
         such as the commit before the pointer), timed in turns (base,
         null, pointer, pointer, null, base), with ``o`` of the three
         compared byte for byte;
  widths the forward at the widths served before D 160, in turns with
         the checkout at ``$CARD_PROBE_BASE``'s build of
         ``flash_attention.cu`` (its entries take the log-sum-exp pointer,
         as this one's do; built with the port's flags into
         ``build/probes/``): the wgmma route at gemma2-2b's global layer
         (D 256), deepseek-moe-16b's and pixtral-12b's prefill shapes (D
         128), the tf32x3 route at tspm-mlho's (D 64), each launched as
         serving launches it (null log-sum-exp pointer), in turns (base,
         this, this, base), with ``o`` compared byte for byte; and this
         build alone at zamba2-2.7b's (D 160);
  bwd    each kernel's device time of ``flash_attention_bwd`` at
         tspm-mlho's and gemma2-2b's training layers (the smoke's
         ``BWD_MODEL_SHAPES``), from a ``torch.profiler`` trace taken first
         in a fresh process (late in the smoke a trace keeps few events);
  step   gemma2-2b's training step (the smoke's phase 10 (c): 3 steps at
         full width under remat) run by this checkout and by the one at
         ``$CARD_PROBE_BASE``, each in its own process, in turns (base,
         this, this, base), each checkout's kernels built beforehand;
  steptrace where that step's time goes: two warm steps, then one under
         a ``torch.profiler`` trace (CUDA activity): the step's host wall,
         the device's busy time (the union of its kernel, copy and memset
         intervals) and idle share, and device ms by kernel family
         (attention forward and backward, matmuls, the rest);
  moe    where deepseek-moe-16b's serving time goes at full size: a warm
         prefill wave (4 x 512 tokens) and a warm decode step (batch 4),
         each traced like ``steptrace`` (device ms by family: attention,
         matmuls, sorts and searches, gathers and scatters, the rest), and
         the expert product alone (one ``torch.bmm`` at the decode's and
         the prefill's capacity) against its bound.

``psplit`` and ``tf32`` build ``csrc/flash_attention.cu`` once more with
``-DFLASH_PROBES`` into ``build/probes/``, and ``count`` builds
``seq_hist.cu`` and ``tspm_fused.cu`` with ``-DCOUNT_PROBES``: the
measurement variants live only in those libraries, never in the ones the
port loads.

The last line is ``nvidia-smi``'s name and power limit of the card.
"""
from __future__ import annotations

import ctypes
import functools
import json
import os
import sys
import tempfile
import time

import numpy as np

import chip_smoke as smoke

SHARES = (0.25, 0.5, 0.125, 0.0625)     # visited forward, then backward
PRICE_BUDGETS = (64 << 20, 128 << 20, 512 << 20, 1 << 30, 4 << 30)
LOGIT_SEEDS = (("cuda", 0), ("cuda", 1), ("cpu", 0))   # generator device, seed
# the CPU runs of probe_logits: environment of each subprocess
LOGIT_CPU_RUNS = {"float32": {}, "float64": {},
                  "one_thread": {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"},
                  "avx2": {"MKL_ENABLE_INSTRUCTIONS": "AVX2", "ATEN_CPU_CAPABILITY": "avx2"}}


def union_us(spans: list) -> float:
    busy, end = 0.0, -np.inf
    for a, b in sorted(spans):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def profiled_stream(torch, db, waves):
    """One stream run through the entry points under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import MiningConfig, MiningSession

    session = MiningSession(MiningConfig(engine="stream", threshold=smoke.THRESHOLD,
                                         screen="hash"), device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame = session.fit(db) if waves is None else \
            smoke.replay_waves(db, session, waves)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = len(frame)
    del frame, session
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        dev = smoke.device_intervals(path)
    busy = union_us(dev["spans"]) / 1e6
    top = sorted(dev["by_kernel"].items(), key=lambda kv: -kv[1])[:10]
    return {"wall_s": wall, "rows": rows, "device_events": len(dev["spans"]),
            "device_busy_s": busy,
            "idle_share": (1.0 - busy / wall) if dev["spans"] else None,
            "device_s_by_category": {k: v / 1e6 for k, v in dev["by_cat"].items()},
            "top_kernels_s": [[k, v / 1e6] for k, v in top]}


def probe_idle(torch) -> dict:
    db = smoke.make_cohort()
    out = {"fit": profiled_stream(torch, db, None)}
    torch.cuda.empty_cache()
    out["replay"] = profiled_stream(torch, db, smoke.STREAM_WAVES)
    torch.cuda.empty_cache()
    return out


def device_passes(torch, db, plan, H: int) -> float:
    """Seconds of every chunk's mine, hash counts and compaction on the
    card, without the copy to the host, ended by a synchronize."""
    from repro_torch.core import chunking

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ch in plan.chunks:
        mined = chunking._mine_chunk(db, ch, "cuda", "bit", "auto", False, 30)
        chunking._counts(mined, ch, plan, H)
        for piece in chunking.real_pieces(mined, ch, plan):
            del piece
        del mined
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def probe_share(torch) -> dict:
    from repro_torch.core import chunking

    db = smoke.make_cohort(smoke.TABLE2_PATIENTS, smoke.TABLE2_EVENTS)
    H, budget = smoke.H_DEFAULT, smoke.BUDGET_BYTES
    default = chunking.CARD_SCRATCH_SHARE
    out = {}
    try:
        for share in SHARES + SHARES[::-1]:
            chunking.CARD_SCRATCH_SHARE = share
            plan = chunking.plan_card_chunks(db.nevents, budget, H)
            r = out.setdefault(str(share), {"chunks": len(plan.chunks),
                                            "piece_slots": plan.piece_slots,
                                            "passes_s": [], "fit_s": []})
            r["passes_s"].append(device_passes(torch, db, plan, H))
            if len(r["fit_s"]) == 0:
                fit = smoke.fit_engine(torch, db, "cuda", engine="chunked", screen="hash",
                                       threshold=smoke.THRESHOLD, budget_bytes=budget)
                r["fit_s"].append(fit["fit_s"])
                r.update(launches=fit["launches"],
                         peak_device_bytes=fit["peak_device_bytes"])
                del fit
            torch.cuda.empty_cache()
    finally:
        chunking.CARD_SCRATCH_SHARE = default
    return out


def chunk_passes(torch, db, plan, H: int) -> dict:
    """Peak device bytes of each pass over the priciest chunk of ``plan``,
    above an empty cache holding one merged [2^H] table, in the order
    ``chunking.mine_chunked`` and ``mine_fused`` run them."""
    from repro_torch.core import chunking, sparsity

    ch = max(plan.chunks, key=plan.chunk_bytes)
    e = ch.max_events
    torch.cuda.empty_cache()
    merged = torch.zeros(1 << H, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    peaks = {}

    def run(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
        return out

    mined = run("mine", lambda: chunking._mine_chunk(db, ch, "cuda", "bit", "auto",
                                                     False, 30))
    held = torch.cuda.memory_allocated() - base
    c = run("counts", lambda: chunking._counts(mined, ch, plan, H))
    merged = sparsity.merge_bucket_counts(merged, c)
    del c

    def compaction():
        for part in chunking.host_rows(mined, ch, plan):
            del part

    def survivors():
        for seq, dur, pat in chunking.real_pieces(mined, ch, plan):
            sparsity.screen_survivors(seq, dur, pat, merged, smoke.THRESHOLD, H,
                                      mask=torch.ones_like(seq, dtype=torch.bool))
            del seq, dur, pat

    run("compaction", compaction)
    run("survivors", survivors)
    del mined, merged
    torch.cuda.empty_cache()
    return {"patients": ch.n_patients, "E": e, "piece_rows": plan.piece_rows(ch),
            "slab_and_planes_bytes": held,
            "slab_and_planes_price": ch.n_patients * (e * e * chunking.CARD_SLAB_BYTES
                                                      + 8 * e + 4),
            "piece_scratch_price": plan.piece_rows(ch) * e * e
            * chunking.CARD_SCRATCH_BYTES,
            "chunk_price": plan.chunk_bytes(ch), "peaks": peaks}


def probe_price(torch) -> dict:
    from repro_torch.core import chunking

    out = {}
    db = smoke.make_cohort()
    for budget in PRICE_BUDGETS:
        plan = chunking.plan_card_chunks(db.nevents, budget, smoke.H_DEFAULT)
        priced = max(plan.chunk_bytes(ch) for ch in plan.chunks)
        out[f"{budget >> 20}MiB/passes"] = chunk_passes(torch, db, plan, smoke.H_DEFAULT)
        for screen in ("hash", "fused"):
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            fit = smoke.fit_engine(torch, db, "cuda", engine="chunked", screen=screen,
                                   threshold=smoke.THRESHOLD, budget_bytes=budget)
            peak = fit["peak_device_bytes"] - base
            out[f"{budget >> 20}MiB/{screen}"] = {
                "chunks": len(plan.chunks), "peak_bytes": peak,
                "priced_bytes": priced,
                "under_price": priced - peak, "under_budget": budget - peak,
                "fit_s": fit["fit_s"]}
            del fit
    return out


def peak_over(torch, fn):
    """(result, device bytes ``fn`` allocated above what was live before)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def probe_scratch(torch) -> dict:
    from repro_torch.core import chunking, sparsity

    db = smoke.make_cohort()
    H, rows = 10, (1, 4, 16, 64)       # [2^10] tables: 4 KiB, out of the way
    ch = chunking.Chunk(0, max(rows), int(db.max_events))
    T = ch.max_events ** 2
    torch.cuda.empty_cache()
    mined, mine_b = peak_over(torch, lambda: chunking._mine_chunk(
        db, ch, "cuda", "bit", "auto", False, 30))
    counts = sparsity.local_bucket_counts(mined.seq, mined.mask, H)
    out = {"E": ch.max_events, "mine_bytes_per_chunk_slot": mine_b / (ch.n_patients * T),
           "pieces": {}}
    for r in rows:
        piece = chunking._piece(mined, 0, r)
        _, counts_b = peak_over(torch, lambda: sparsity.local_bucket_counts(
            piece.seq, piece.mask, H, block_elements=r * T))
        real, compact_b = peak_over(torch, lambda: chunking.real_rows(piece))
        _, surv_b = peak_over(torch, lambda: sparsity.screen_survivors(
            *real, counts, smoke.THRESHOLD, H,
            mask=torch.ones_like(real[0], dtype=torch.bool)))
        out["pieces"][r] = {"slots": r * T, "real_rows": int(real[0].numel()),
                            "counts_bytes": counts_b, "compaction_bytes": compact_b,
                            "survivors_bytes": surv_b}
        del real, piece
    slots = np.array([v["slots"] for v in out["pieces"].values()], float)
    for k in ("counts_bytes", "compaction_bytes", "survivors_bytes"):
        b = np.array([v[k] for v in out["pieces"].values()], float)
        per_slot, fixed = np.polyfit(slots, b, 1)
        out[k.replace("_bytes", "_fit")] = {"per_slot": per_slot, "fixed": fixed}
    del mined, counts
    torch.cuda.empty_cache()
    return out


def gemma_layers(torch, dev):
    """q [2, 8, 8192, 256], k/v [2, 4, 8192, 256] bfloat16 (seeded), and
    gemma2-2b's (name, window, softcap) of a local and a global layer."""
    from repro_torch.configs import get_config

    cfg = get_config("gemma2-2b")
    gen = torch.Generator(dev).manual_seed(smoke.SEED)
    B, S = smoke.GEMMA_REQUESTS, smoke.GEMMA_PROMPT_LEN
    q, k, v = (torch.randn(B, H, S, cfg.hd, generator=gen, device=dev).to(torch.bfloat16)
               for H in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    layers = (("local", cfg.sliding_window, cfg.attn_softcap),
              ("global", None, cfg.attn_softcap))
    return (q, k, v), layers


def bf16_diff(torch, got, want) -> dict:
    """max |diff| and the elements beyond the smoke's bfloat16 limit and
    beyond the reference test's 2e-2 + 2e-2 |want|."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    return {"max_diff": d.max().item(),
            "beyond_limit": (d > smoke.flash_limit(w, "bfloat16")).sum().item(),
            "beyond_2e-2": (d > 2e-2 + 2e-2 * w.abs()).sum().item()}


def probe_flex(torch) -> dict:
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    from repro_torch.kernels.flash_attention import ops, ref

    dev = torch.device("cuda", 0)
    (q, k, v), layers = gemma_layers(torch, dev)
    flex = torch.compile(flex_attention)
    out = {"shape": f"q {list(q.shape)} k {list(k.shape)} bfloat16"}
    for name, window, cap in layers:
        def score_mod(score, b, h, qi, kj, cap=cap):
            return cap * torch.tanh(score / cap)

        def mask_mod(b, h, qi, kj, window=window):
            visible = qi >= kj
            return visible & (qi - kj < window) if window is not None else visible

        S = q.shape[2]
        mask = create_block_mask(mask_mod, None, None, S, S, device=dev)
        kw = dict(causal=True, window=window, softcap=cap)
        kern = torch.empty_like(q)
        calls = {"kernel_ms": lambda: ops._launch(q, k, v, kern, **kw),
                 "flex_ms": lambda: flex(q, k, v, score_mod=score_mod, block_mask=mask,
                                         enable_gqa=True)}
        t0 = time.perf_counter()
        got = calls["flex_ms"]()
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        want = ref.attention_ref(q, k, v, **kw)
        reading = bf16_diff(torch, got, want)
        del got, want
        smoke.require(reading["beyond_2e-2"] == 0,
                      f"flex_attention computes another function at {name}: {reading}")
        out[name] = {"window": window, "softcap": cap, "first_call_s": compile_s,
                     "flex": reading, **smoke.in_turns(torch, calls)}
        torch.cuda.empty_cache()
    return out


@functools.cache
def probe_entries() -> dict:
    """The measurement variants of ``flash_attention.cu`` (``FLASH_PROBES``),
    built with the port's flags into a library of their own, by the route
    whose arguments each takes."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    dll = _build.load_probe("flash_attention", "FLASH_PROBES")
    out = {}
    for route, name in (("wgmma", "flash_attention_wgmma_p_bf16"),
                        ("tf32x3", "flash_attention_tf32x3_pv_hi")):
        fn = getattr(dll, name)
        fn.argtypes, fn.restype = ops.ENTRIES[route][1], ctypes.c_int
        out[route] = fn
    return out


def probe_launch(torch, q, k, v, out, **kw) -> None:
    """The probe variant of the route that takes ``q``: as ``ops._launch``."""
    from repro_torch.kernels.flash_attention import ops

    route = ops.route(q.dtype, q.shape[3])
    ptrs, mask = ops.entry_args(q, k, v, out, **kw)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "tf32x3":
        scratch = torch.empty(ops.tf32x3_scratch_elems(k.shape), dtype=torch.float32,
                              device=q.device)
        rc = probe_entries()[route](*ptrs, scratch.data_ptr(), *mask, stream)
    else:
        rc = probe_entries()[route](*ptrs, *mask, stream)
    if rc != 0:
        raise RuntimeError(f"probe variant of {route}: CUDA error {rc}")


def probe_psplit(torch) -> dict:
    from repro_torch.kernels.flash_attention import ops, ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    q3, k3, v3 = (torch.randn(1, H, 8192, 64, generator=gen, device=dev).to(torch.bfloat16)
                  for H in (2, 1, 1))
    gemma, layers = gemma_layers(torch, dev)
    cases = [("3b_window_4096", (q3, k3, v3), dict(causal=True, window=4096, softcap=None))]
    cases += [(f"gemma2_{name}", gemma, dict(causal=True, window=window, softcap=cap))
              for name, window, cap in layers]
    out = {}
    for name, (q, k, v), kw in cases:
        want = ref.attention_ref(q, k, v, **kw)
        outs = {p: torch.empty_like(q) for p in (2, 1)}
        calls = {"p_terms_2_ms": lambda: ops._launch(q, k, v, outs[2], **kw),
                 "p_terms_1_ms": lambda: probe_launch(torch, q, k, v, outs[1], **kw)}
        out[name] = {"shape": f"q {list(q.shape)} k {list(k.shape)} {kw}",
                     **smoke.in_turns(torch, calls)}
        out[name].update({f"p_terms_{p}": bf16_diff(torch, outs[p], want) for p in (2, 1)})
        del want, outs
        torch.cuda.empty_cache()
    return out


def probe_tf32(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops, ref

    dev = torch.device("cuda", 0)
    cfg = get_config("tspm-mlho")
    gen = torch.Generator(dev).manual_seed(1)
    B, S = smoke.LM_BATCH, smoke.LM_PROMPT_LEN
    q, k, v = (torch.randn(B, H, S, cfg.hd, generator=gen, device=dev)
               for H in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    kw = dict(causal=True, window=None, softcap=None)
    outs = {n: torch.empty_like(q) for n in ("tf32x3", "ffma", "tf32x3_pv_hi_only")}
    calls = {"tf32x3": lambda: ops._launch(q, k, v, outs["tf32x3"], **kw),
             "ffma": lambda: ops._launch(q, k, v, outs["ffma"], force_route="ffma", **kw),
             "tf32x3_pv_hi_only": lambda: probe_launch(torch, q, k, v,
                                                       outs["tf32x3_pv_hi_only"], **kw)}
    out = {"card": smoke.smi(), "shape": f"q {list(q.shape)} k {list(k.shape)} float32 causal",
           **{f"{n}_ms": t for n, t in smoke.in_turns(torch, calls, 20).items()},
           "device_ms": {n: smoke.kernel_device_ms(torch, calls[n], 20)
                         for n in ("tf32x3", "tf32x3_pv_hi_only")}}
    want = ref.attention_ref(q, k, v, **kw)
    for n in outs:
        d = (outs[n] - want).abs()
        out[n] = {"max_diff": d.max().item(),
                  "beyond_limit": (d > smoke.flash_limit(want, "float32")).sum().item()}
    return out


@functools.cache
def base_entries(with_lse: bool = False) -> dict:
    """The forward's wgmma and tf32x3 entries as ``$CARD_PROBE_BASE``'s
    ``flash_attention.cu`` has them (with or without the log-sum-exp
    pointer), built with the port's flags into ``build/probes/``."""
    import subprocess

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    src = os.path.join(os.environ["CARD_PROBE_BASE"], "src/repro_torch/csrc/flash_attention.cu")
    dest = _build.PROBE_DIR / "flash_attention-base.so"
    dest.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(dest), src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}: {proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(str(dest))
    out = {}
    for route in ("wgmma", "tf32x3"):
        name, argtypes = ops.ENTRIES[route]
        fn = getattr(dll, name)
        fn.argtypes = argtypes if with_lse else argtypes[:4] + argtypes[5:]
        fn.restype = ctypes.c_int
        out[route] = fn
    return out


def probe_lse(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops

    dev = torch.device("cuda", 0)
    (gq, gk, gv), layers = gemma_layers(torch, dev)
    cfg = get_config("tspm-mlho")
    gen = torch.Generator(dev).manual_seed(1)
    tq, tk, tv = (torch.randn(smoke.LM_BATCH, H, smoke.LM_PROMPT_LEN, cfg.hd, generator=gen,
                              device=dev) for H in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    cases = [(f"gemma2_{name}", (gq, gk, gv), dict(causal=True, window=w, softcap=c))
             for name, w, c in layers]
    cases.append(("tspm_mlho", (tq, tk, tv), dict(causal=True, window=None, softcap=None)))
    out = {"card": smoke.smi(), "base": os.environ["CARD_PROBE_BASE"]}
    for name, (q, k, v), kw in cases:
        route = ops.route(q.dtype, q.shape[3])
        outs = {n: torch.empty_like(q) for n in ("base", "null", "pointer")}
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
        scratch = torch.empty(ops.tf32x3_scratch_elems(k.shape), dtype=torch.float32,
                              device=dev) if route == "tf32x3" else None

        def base():
            ptrs, mask = ops.entry_args(q, k, v, outs["base"], **kw)
            extra = [scratch.data_ptr()] if scratch is not None else []
            rc = base_entries()[route](*ptrs[:4], *ptrs[5:], *extra, *mask,
                                       torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                raise RuntimeError(f"base {route}: CUDA error {rc}")

        calls = {"base": base,
                 "null": lambda: ops._launch(q, k, v, outs["null"], scratch=scratch, **kw),
                 "pointer": lambda: ops._launch(q, k, v, outs["pointer"], scratch=scratch,
                                                lse=lse, **kw)}
        turns = smoke.in_turns(torch, calls, 20)
        out[name] = {"route": route, "shape": f"q {list(q.shape)} k {list(k.shape)} {kw}",
                     **{f"{n}_ms": t for n, t in turns.items()},
                     "o_identical": all(torch.equal(outs["base"], outs[n])
                                        for n in ("null", "pointer"))}
    return out


def probe_widths(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops

    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(smoke.SEED)

    def qkv(B, Hq, Hkv, S, D, dtype):
        return [torch.randn(B, H, S, D, generator=gen, device=dev).to(dtype)
                for H in (Hq, Hkv, Hkv)]

    (gq, gk, gv), _ = gemma_layers(torch, dev)
    gemma = get_config("gemma2-2b")
    tspm = get_config("tspm-mlho")
    cases = {
        "gemma2_global": ((gq, gk, gv), dict(causal=True, window=None,
                                             softcap=gemma.attn_softcap)),
        "deepseek": (qkv(smoke.DEEPSEEK_BATCH, 16, 16, smoke.DEEPSEEK_PROMPT_LEN, 128,
                         torch.bfloat16), dict(causal=True, window=None, softcap=None)),
        "pixtral": (qkv(2, 32, 8, 1088, 128, torch.bfloat16),
                    dict(causal=True, window=None, softcap=None)),
        "tspm_mlho": (qkv(smoke.LM_BATCH, tspm.n_heads, tspm.n_kv_heads, smoke.LM_PROMPT_LEN,
                          tspm.hd, torch.float32), dict(causal=True, window=None, softcap=None)),
    }
    out = {"card": smoke.smi(), "base": os.environ["CARD_PROBE_BASE"]}
    for name, ((q, k, v), kw) in cases.items():
        route = ops.route(q.dtype, q.shape[3])
        outs = {n: torch.empty_like(q) for n in ("base", "this")}
        scratch = torch.empty(ops.tf32x3_scratch_elems(k.shape), dtype=torch.float32,
                              device=dev) if route == "tf32x3" else None

        def base():
            ptrs, mask = ops.entry_args(q, k, v, outs["base"], **kw)
            extra = [scratch.data_ptr()] if scratch is not None else []
            rc = base_entries(True)[route](*ptrs, *extra, *mask,
                                           torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                raise RuntimeError(f"base {route}: CUDA error {rc}")

        calls = {"base": base,
                 "this": lambda: ops._launch(q, k, v, outs["this"], scratch=scratch, **kw)}
        turns = smoke.in_turns(torch, calls, 20)
        ms = {n: sum(t) / len(t) for n, t in turns.items()}
        out[name] = {"route": route, "shape": f"q {list(q.shape)} k {list(k.shape)} {kw}",
                     **{f"{n}_ms": t for n, t in turns.items()},
                     "base_mean_ms": ms["base"], "this_mean_ms": ms["this"],
                     "this_over_base": ms["this"] / ms["base"],
                     "o_identical": torch.equal(outs["base"], outs["this"])}
        del q, k, v, outs, scratch
    zq, zk, zv = qkv(2, 32, 32, 4096, 160, torch.bfloat16)
    zo = torch.empty_like(zq)
    kw = dict(causal=True, window=None, softcap=None)
    turns = smoke.in_turns(torch, {"this": lambda: ops._launch(zq, zk, zv, zo, **kw)}, 20)
    out["zamba2"] = {"route": ops.route(zq.dtype, 160), "shape": f"q {list(zq.shape)} {kw}",
                     "this_ms": turns["this"],
                     "this_mean_ms": sum(turns["this"]) / len(turns["this"])}
    return out


def probe_bwd(torch) -> dict:
    from repro_torch.kernels.flash_attention import ops

    dev = torch.device("cuda", 0)
    out = {"card": smoke.smi()}
    for name, (shape, dtype, kw) in smoke.BWD_MODEL_SHAPES.items():
        q, k, v, do = smoke.bwd_inputs(torch, dev, shape, dtype, 11)
        o, lse = ops.attention(q, k, v, return_lse=True, **kw)
        route = ops.bwd_route(q.dtype, shape[5])
        dev_ms = smoke.kernel_device_ms(
            torch, lambda: ops.attention_bwd(q, k, v, o, do, lse, **kw), 20)
        by_kernel = {n: sum(t for kn, t in dev_ms.items() if f"{n}_kernel" in kn)
                     for n in ops.BWD_KERNELS[route]}
        out[name] = {"route": route, "device_ms": by_kernel,
                     "device_sum_ms": sum(by_kernel.values()),
                     "event_ms": smoke.cuda_ms(
                         torch, lambda: ops.attention_bwd(q, k, v, o, do, lse, **kw), 20),
                     "profiler_kernels": sorted(dev_ms)}
    return out


def probe_step(torch) -> dict:
    import subprocess

    here, base = str(smoke.ROOT), os.path.abspath(os.environ["CARD_PROBE_BASE"])
    code = ("import json, sys, torch; sys.path.insert(0, 'src'); import chip_smoke; "
            "print('STEP ' + json.dumps(chip_smoke.check_gemma_training("
            "torch, torch.device('cuda', 0))))")

    def run(root: str, what: str) -> str:
        env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
        proc = subprocess.run([sys.executable, "-c", what], cwd=root, env=env,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise RuntimeError(f"{root}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        return proc.stdout

    for root in (base, here):
        run(root, "from repro_torch.kernels import _build; _build.build_all()")
    out = {"card": smoke.smi(), "base": base, "base_steps": [], "this_steps": []}
    for root, key in ((base, "base_steps"), (here, "this_steps"), (here, "this_steps"),
                      (base, "base_steps")):
        line = [ln for ln in run(root, code).splitlines() if ln.startswith("STEP ")][-1]
        r = json.loads(line[5:])
        out[key].append({k: r[k] for k in ("step_s", "losses", "launches",
                                           "peak_device_bytes")})
    return out


def probe_steptrace(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.training import optimizer as opt_lib, train_loop

    dev = torch.device("cuda", 0)
    cfg = get_config("gemma2-2b")
    mdl = model_lib.build(cfg)
    state = train_loop.init_state(mdl, torch.Generator(dev).manual_seed(smoke.SEED))
    toks = np.random.default_rng(smoke.SEED).integers(
        4, cfg.vocab_size, (1, smoke.GEMMA_TRAIN_SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": np.ones((1, smoke.GEMMA_TRAIN_SEQ), bool)}
    step = train_loop.make_train_step(mdl, opt_lib.OptConfig(
        peak_lr=smoke.GEMMA_TRAIN_LR, warmup_steps=0, decay_steps=100))
    for _ in range(2):
        state, _ = step(state, batch)
    metrics = {}
    r = traced(torch, lambda: metrics.update(step(state, batch)[1]), {
        "attention_bwd": ("bwd_wgmma_kernel", "prepass_kernel", "dq_kernel", "dkv_kernel"),
        "attention_fwd": ATTENTION_FWD, "matmul": MATMUL})
    return {"card": smoke.smi(), **r, "loss": float(metrics["loss"])}


ATTENTION_FWD = ("flash_wgmma_kernel", "flash_tf32x3_kernel", "flash_kernel",
                 "tf32x3_split_kernel")
MATMUL = ("gemm", "gemv", "xmma", "cutlass", "nvjet")


def traced(torch, fn, families: dict) -> dict:
    """One call of ``fn`` under a ``torch.profiler`` trace (CUDA activity),
    ended by a synchronize: its host wall, the device's busy time (the
    union of its kernel, copy and memset intervals) and idle share, device
    ms by kernel family (names containing a family's keys) and category,
    and the eight longest kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        dev_int = smoke.device_intervals(path)
    by_family = dict.fromkeys((*families, "other"), 0.0)
    for name, us in dev_int["by_kernel"].items():
        fam = next((f for f, keys in families.items() if any(k in name for k in keys)),
                   "other")
        by_family[fam] += us / 1e3
    busy = union_us(dev_int["spans"]) / 1e3
    top = sorted(dev_int["by_kernel"].items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": 1 - busy / (wall * 1e3), "device_ms_by_family": by_family,
            "device_ms_by_category": {k: v / 1e3 for k, v in dev_int["by_cat"].items()},
            "top_kernels_ms": [(n[:120], us / 1e3) for n, us in top]}


MOE_FAMILIES = {"attention_fwd": ATTENTION_FWD, "matmul": MATMUL,
                "sort_search": ("sort", "Sort", "radix", "Radix", "searchsorted", "cub::"),
                "gather_scatter": ("index", "Index", "gather", "scatter")}


def probe_moe(torch) -> dict:
    """deepseek-moe-16b at full size (bf16, seeded init): a warm prefill
    wave of the smoke's 4 x 512 tokens and a warm decode step at batch 4
    after it, each traced (``traced``), and the expert product alone, one
    ``torch.bmm`` of ``[64, c, 2048] @ [64, 2048, 1408]``, timed with CUDA
    events at the decode's capacity (8) and the prefill's (240) beside its
    bound (the weight bytes over 3.35 TB/s, the flops at 989 TFLOP/s)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib, moe

    dev = torch.device("cuda", 0)
    cfg = get_config("deepseek-moe-16b")
    mdl = model_lib.build(cfg)
    params = mdl.init(torch.Generator(dev).manual_seed(smoke.SEED))
    B, S = smoke.DEEPSEEK_BATCH, smoke.DEEPSEEK_PROMPT_LEN
    toks = torch.randint(4, cfg.vocab_size, (B, S), device=dev,
                         generator=torch.Generator(dev).manual_seed(smoke.SEED))
    state = {}

    def prefill():
        caches = mdl.init_caches(B, smoke.DEEPSEEK_MAX_LEN, device=dev)
        state["caches"] = mdl.apply(params, {"tokens": toks}, mode="prefill",
                                    caches=caches)[1]

    def decode():
        state["caches"] = mdl.apply(params, {"tokens": toks[:, :1]}, mode="decode",
                                    caches=state["caches"])[1]

    for _ in range(2):
        prefill()
    out = {"card": smoke.smi(), "prefill": traced(torch, prefill, MOE_FAMILIES)}
    for _ in range(3):
        decode()
    out["decode"] = traced(torch, decode, MOE_FAMILIES)
    w = params.blocks[0].ffn.w_gate
    e, d, ffe = w.shape
    for name, n in (("decode", B), ("prefill", B * S)):
        c = moe._capacity(n, cfg)
        h = torch.randn(e, c, d, device=dev).to(w.dtype)
        nbytes = (w.numel() + h.numel() + e * c * ffe) * w.element_size()
        out[f"expert_bmm_{name}"] = {
            "capacity": c, "ms": smoke.cuda_ms(torch, lambda: torch.bmm(h, w), 20),
            "bound_ms": max(nbytes / smoke.HBM_BYTES_PER_S,
                            2 * e * c * d * ffe / smoke.BF16_OPS_PER_S) * 1e3}
    del params, state
    torch.cuda.empty_cache()
    return out


def count_kernels(torch, calls: dict, tables: dict, want) -> dict:
    """Turns of each kernel, their tables against ``want``, and each one's
    device time by kernel from a profiler trace."""
    out = {"ms": {k: v for k, v in smoke.in_turns(torch, calls, 10).items()}}
    for k, t in tables.items():
        smoke.require(torch.equal(t, want), f"count: kernel {k} disagrees")
    out["device_ms"] = {k: smoke.kernel_device_ms(torch, fn, 5) for k, fn in calls.items()}
    return out


def probe_count(torch) -> dict:
    from repro_torch.core import encoding, sparsity
    from repro_torch.kernels.seq_hist import ops as hist_ops
    from repro_torch.kernels.tspm_fused import ops as fused_ops
    from repro_torch.kernels.tspm_pairgen import ops as pg_ops

    dev = torch.device("cuda", 0)
    H, nb = smoke.H_DEFAULT, 1 << smoke.H_DEFAULT
    out = {"card": smoke.smi()}
    db = smoke.make_cohort()
    E = db.max_events
    blk = max(1, sparsity.BLOCK_ELEMENTS // (E * E))
    args = [torch.from_numpy(a[:blk]).to(dev) for a in (db.phenx, db.date, db.nevents)]
    got = pg_ops.pairgen(*args)
    srt = torch.sort(torch.where(got.mask, got.seq, encoding.SENTINEL).reshape(blk, -1),
                     dim=1).values
    del got, args
    h, first = sparsity.hash_bucket(srt, H), sparsity.row_first_flags(srt)
    del srt
    tables = {k: torch.zeros(nb, dtype=torch.int32, device=dev) for k in ("new", "old")}
    calls = {"new": lambda: hist_ops._launch(h, first, tables["new"].zero_(), "partitioned"),
             "old": lambda: smoke.old_hist(torch, h, first, tables["old"].zero_())}
    out["seq_hist"] = {"shape": f"N={h.numel()} H={H} counted={int(first.sum())}",
                       **count_kernels(torch, calls, tables, hist_ops.hist(h, first, nb))}
    # the crossover against the old kernel: leading runs of the block's ids
    flat_h, flat_f = h.reshape(-1), first.reshape(-1)
    sizes = {}
    for log2 in range(18, 27):
        hs, fs = flat_h[:1 << log2], flat_f[:1 << log2]
        part, old = (torch.zeros(nb, dtype=torch.int32, device=dev) for _ in range(2))
        t = smoke.in_turns(torch, {
            "partitioned": lambda: hist_ops._launch(hs, fs, part.zero_(), "partitioned"),
            "global": lambda: hist_ops._launch(hs, fs, old.zero_(), "global")}, 20)
        smoke.require(torch.equal(part, old), "count: the routes disagree")
        sizes[1 << log2] = {"counted": int(fs.sum()), **t}
    out["seq_hist"]["sizes"] = sizes
    del h, first, tables, calls, flat_h, flat_f
    torch.cuda.empty_cache()

    db2 = smoke.make_cohort(smoke.TABLE2_PATIENTS, smoke.TABLE2_EVENTS)
    x, nev = (torch.from_numpy(a).to(dev) for a in (db2.phenx, db2.nevents))
    tables = {"old": torch.zeros(nb, dtype=torch.int32, device=dev)}
    calls = {"new": lambda: fused_ops.fused_table(x, nev, H),
             "old": lambda: smoke.old_fused(torch, x, nev, tables["old"].zero_(), H)}
    out["tspm_fused"] = {"shape": f"P={x.shape[0]} E={x.shape[1]} H={H}",
                         **count_kernels(torch, calls, tables, fused_ops.fused_table(x, nev, H))}
    return out


def first_wave(torch, mdl, params, prompts, device) -> tuple:
    """The first wave's logits (``smoke.first_wave_logits``, float64 on
    the host) and tokens of one ``ServeEngine.run`` over ``prompts``."""
    logits = []
    r = smoke.serve_on(torch, mdl, params, prompts, smoke.LM_NEW_TOKENS, device,
                       smoke.LM_BATCH, smoke.LM_MAX_LEN, timed=False, logits=logits)
    return ([t.cpu().double() for t in logits],
            {i: r["results"][i] for i in range(smoke.LM_BATCH)})


def logits_worker(run: str, tmp: str) -> int:
    """One CPU run of probe_logits: the weights and prompts it saved in
    ``tmp``, served on the CPU, logits and tokens saved as ``tmp/run.pt``."""
    import torch

    sys.path.insert(0, str(smoke.SRC))
    from repro_torch.configs import get_config
    from repro_torch.models import layers, model as model_lib

    if run == "float64":
        layers.DTYPES["float32"] = torch.float64     # weights, caches, activations
        torch.Tensor.float = torch.Tensor.double      # and the float32 upcasts
    mdl = model_lib.build(get_config("tspm-mlho"))
    params = mdl.init(torch.Generator("cpu").manual_seed(0))
    params.load_state_dict(torch.load(os.path.join(tmp, "params.pt")))
    prompts = torch.load(os.path.join(tmp, "prompts.pt"), weights_only=False)
    logits, tokens = first_wave(torch, mdl, params, prompts, "cpu")
    torch.save({"logits": logits, "tokens": tokens, "threads": torch.get_num_threads(),
                "capability": torch.backends.cpu.get_cpu_capability()},
               os.path.join(tmp, f"{run}.pt"))
    return 0


def probe_logits(torch) -> dict:
    import subprocess
    import threading

    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    dev = torch.device("cuda", 0)
    mdl = model_lib.build(get_config("tspm-mlho"))
    prompts = smoke.lm_prompts(smoke.make_raw_cohort())[:smoke.LM_BATCH]
    out = {"host": smoke.host_facts(torch), "limit": smoke.LM_LOGIT_TOL, "sets": []}

    def gap(a, b) -> float:
        return smoke.logit_diff(torch, a[0], b[0], a[1], b[1])

    def busy(stop) -> None:
        a = torch.randn(4096, 4096, device=dev)
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            while not stop.is_set():
                a = a @ a
                a = a / a.abs().max()

    with tempfile.TemporaryDirectory(prefix="logit_probe_") as tmp:
        torch.save(prompts, os.path.join(tmp, "prompts.pt"))
        for n, (gen_device, seed) in enumerate(LOGIT_SEEDS):
            t0 = time.perf_counter()
            params = mdl.init(torch.Generator(gen_device).manual_seed(seed)).to(dev)
            torch.save({k: v.cpu() for k, v in params.state_dict().items()},
                       os.path.join(tmp, "params.pt"))
            card = first_wave(torch, mdl, params, prompts, dev)
            row = {"weights": f"{gen_device} generator, seed {seed}"}
            if n == 0:
                again = first_wave(torch, mdl, params, prompts, dev)
                stop = threading.Event()
                side = threading.Thread(target=busy, args=(stop,))
                side.start()
                try:
                    loaded = first_wave(torch, mdl, params, prompts, dev)
                finally:
                    stop.set()
                    side.join()
                row["card_repeats"] = {"alone": all(torch.equal(a, b) for a, b in
                                                    zip(card[0], again[0])),
                                       "beside_load": all(torch.equal(a, b) for a, b in
                                                          zip(card[0], loaded[0]))}
            del params
            torch.cuda.empty_cache()
            cpu = {}
            for run, env in LOGIT_CPU_RUNS.items():
                if n and run not in ("float32", "float64"):
                    continue
                subprocess.run([sys.executable, os.path.abspath(__file__), "--logits-worker",
                                run, tmp], env={**os.environ, **env}, check=True, timeout=900)
                saved = torch.load(os.path.join(tmp, f"{run}.pt"), weights_only=False)
                cpu[run] = (saved["logits"], saved["tokens"])
                row.setdefault("cpu_threads", {})[run] = saved["threads"]
                row.setdefault("cpu_capability", {})[run] = saved["capability"]
            row["card_vs"] = {run: gap(card, got) for run, got in cpu.items()}
            row["cpu_vs_float64"] = {run: gap(got, cpu["float64"]) for run, got in cpu.items()
                                     if run != "float64"}
            row["max_abs_logit"] = max(t.abs().max().item() for t in cpu["float64"][0])
            row["seconds"] = time.perf_counter() - t0
            out["sets"].append(row)
            print(f"logits: {json.dumps(row)}", flush=True)
    return out


def main(argv: list[str]) -> int:
    import torch

    if argv[:1] == ["--logits-worker"]:
        return logits_worker(*argv[1:])
    if not torch.cuda.is_available():
        print("card_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(smoke.SRC))
    from repro_torch.kernels import _build

    _build.build_all()
    probes = {"idle": probe_idle, "share": probe_share, "price": probe_price,
              "scratch": probe_scratch, "flex": probe_flex, "psplit": probe_psplit,
              "tf32": probe_tf32, "count": probe_count, "logits": probe_logits,
              "bwd": probe_bwd, "lse": probe_lse, "widths": probe_widths, "step": probe_step,
              "steptrace": probe_steptrace, "moe": probe_moe}
    if not argv and "CARD_PROBE_BASE" not in os.environ:
        for name in ("lse", "widths", "step"):
            probes.pop(name)
    for name in argv or list(probes):
        t0 = time.perf_counter()
        result = probes[name](torch)
        print(json.dumps({"probe": name, "seconds": time.perf_counter() - t0,
                          "result": result}), flush=True)
    print(f"nvidia-smi: {smoke.smi()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
