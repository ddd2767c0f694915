"""Measurements of the PyTorch/CUDA port on one NVIDIA GPU that the smoke
test (``chip_smoke.py``) does not take.

Run from the root of a checkout, with one visible CUDA device:

    python3 card_probe.py [idle] [share] [price] [scratch] [flex] [psplit] [tf32] [count]
                          [logits] [bwd] [lse] [widths] [step] [steptrace] [moe]
                          [binding] [gloo] [plans] [steps]

(all when none is named; ``lse`` and ``widths`` only with
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
  widths the forward at every served shape of the tensor-core routes, in
         turns with the checkout at ``$CARD_PROBE_BASE``'s build of
         ``flash_attention.cu`` (its entries take the log-sum-exp pointer,
         as this one's do; built with the port's flags into
         ``build/probes/``): the wgmma route at the seamless-m4t-large-v2
         encoder and cross-attention (D 64), deepseek-moe-16b's and
         pixtral-12b's prefill shapes (D 128), zamba2-2.7b's (D 160) and
         gemma2-2b's local and global layers (D 256), the tf32x3 route at tspm-mlho's
         (D 64), each launched as serving launches it (null log-sum-exp
         pointer), in turns (base, this, this, base), both held to the
         plain version's limit, with whether ``o`` is byte-equal (it is
         where the schedule keeps the summation order);
  plans  the wgmma route's plans against each other (``probe_plans``):
         builds, edge cases, and the served shapes timed by events, by
         device time and by the host's enqueue time, beside SDPA and the
         plan with P as one bf16 term;
  steps  where a step of the pipelined schedule spends its cycles
         (``probe_steps``): an in-kernel ``clock64()`` trace of CTA 0;
  bwd    each kernel's device time of ``flash_attention_bwd`` at the
         training layers of the smoke's ``BWD_MODEL_SHAPES``, from a
         ``torch.profiler`` trace taken first in a fresh process (late in
         the smoke a trace keeps few events); then at tspm-mlho's layer the
         tf32x3 route in turns with ffma forced (``force_route``) and, with
         ``CARD_PROBE_BASE``, with the parent's build of the ffma entry,
         each held to the backward's limit, with device ms by kernel, the
         tf32x3 plans tried and its CTAs against the card's SMs;
  step   tspm-mlho's full-size training step under a ``torch.profiler``
         trace on the tf32x3 backward and with ffma forced, in turns: the
         attention backward's share of the step; with ``CARD_PROBE_BASE``
         also gemma2-2b's training step (the smoke's phase 10 (c): 3 steps
         at full width under remat) run by this checkout and by the one at
         ``$CARD_PROBE_BASE``, each in its own process, in turns (base,
         this, this, base), each checkout's kernels built beforehand;
  steptrace where that step's time goes: two warm steps, then one under
         a ``torch.profiler`` trace (CUDA activity): the step's host wall,
         the device's busy time (the union of its kernel, copy and memset
         intervals) and idle share, and device ms by kernel family
         (attention forward and backward, matmuls, the rest);
  binding the attention kernels bound as ``torch.library.custom_op``s
         against the binding before it (the wrapper's checks and the
         ``ctypes`` launch called directly), at tspm-mlho's forward shape and
         gemma2-2b's backward shape, in turns, with the outputs compared
         byte for byte and the host's time a call;
  gloo   which collectives ``gloo`` takes for CUDA tensors when 4 ranks
         share ``cuda:0`` (chip_smoke.py phase 13's world): one world an
         op (the process-group calls, the functional ones DTensor issues,
         a ``DeviceMesh`` of type ``cuda`` and DTensor redistributions),
         each op's result on rank 0, or how its world died (a signal, a
         hang past ``GLOO_PROBE_LIMIT_S``); the functional all-gather and
         the redistributions again with ``launch/mesh.gloo_cuda_all_gather``;
  moe    where deepseek-moe-16b's serving time goes at full size: a warm
         prefill wave (4 x 512 tokens) and a warm decode step (batch 4),
         each traced like ``steptrace`` (device ms by family: attention,
         matmuls, sorts and searches, gathers and scatters, the rest), and
         the expert product alone (one ``torch.bmm`` at the decode's and
         the prefill's capacity) against its bound.

``psplit``, ``tf32``, ``plans`` and ``steps`` build
``csrc/flash_attention.cu`` once more with ``-DFLASH_PROBES`` into
``build/probes/``, and ``count`` builds
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


# the wgmma route's served shapes at each head width: (name, (B, Hq, Hkv,
# Sq, Skv), mask); gemma2-2b's two layers are added from its config
SERVED_SHAPES = {
    64: (("seamless_enc", (2, 16, 16, 1024, 1024), dict(causal=False)),
         ("seamless_cross", (2, 16, 16, 64, 1024), dict(causal=False))),
    128: (("pixtral", (2, 32, 8, 1088, 1088), dict(causal=True)),
          ("deepseek", (4, 16, 16, 512, 512), dict(causal=True))),
    160: (("zamba2", (2, 32, 32, 4096, 4096), dict(causal=True)),),
    256: (),
}


def served_shapes(D: int) -> list:
    """``SERVED_SHAPES[D]`` with every mask option spelled out, and at D 256
    gemma2-2b's local and global layers."""
    from repro_torch.configs import get_config

    out = [(n, s, {"window": None, "softcap": None, **kw}) for n, s, kw in SERVED_SHAPES[D]]
    if D == 256:
        cfg = get_config("gemma2-2b")
        shape = (smoke.GEMMA_REQUESTS, cfg.n_heads, cfg.n_kv_heads, smoke.GEMMA_PROMPT_LEN,
                 smoke.GEMMA_PROMPT_LEN)
        out += [("gemma2_local", shape, dict(causal=True, window=cfg.sliding_window,
                                             softcap=cfg.attn_softcap)),
                ("gemma2_global", shape, dict(causal=True, window=None,
                                              softcap=cfg.attn_softcap))]
    return out


def bf16_qkv(torch, gen, B, Hq, Hkv, Sq, Skv, D):
    return [torch.randn(B, H, S, D, generator=gen, device=gen.device).to(torch.bfloat16)
            for H, S in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv))]


def probe_widths(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops, ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(smoke.SEED)
    tspm = get_config("tspm-mlho")
    cases = {name: (bf16_qkv(torch, gen, *shape, D), kw)
             for D in ops.WGMMA_HEAD_DIMS for name, shape, kw in served_shapes(D)}
    cases["tspm_mlho"] = ([torch.randn(smoke.LM_BATCH, H, smoke.LM_PROMPT_LEN, tspm.hd,
                                       generator=gen, device=dev)
                           for H in (tspm.n_heads, tspm.n_kv_heads, tspm.n_kv_heads)],
                          dict(causal=True, window=None, softcap=None))
    out = {"card": smoke.smi(), "base": os.environ["CARD_PROBE_BASE"]}
    for name, ((q, k, v), kw) in cases.items():
        route = ops.route(q.dtype, q.shape[3])
        dtype = str(q.dtype).removeprefix("torch.")
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
        want = ref.attention_ref(q, k, v, **kw)
        errs = {n: smoke.flash_err(torch, outs[n], want, dtype) for n in outs}
        del want
        out[name] = {"route": route, "shape": f"q {list(q.shape)} k {list(k.shape)} {kw}",
                     **{f"{n}_ms": t for n, t in turns.items()},
                     "base_mean_ms": ms["base"], "this_mean_ms": ms["this"],
                     "this_over_base": ms["this"] / ms["base"],
                     "o_identical": torch.equal(outs["base"], outs["this"]),
                     "max_abs_err": errs}
        del q, k, v, outs, scratch
        torch.cuda.empty_cache()
    return out


PLAN_INFO = ("registers", "local_bytes", "shared_bytes", "key_rows", "pv_n", "stages",
             "turns")


@functools.cache
def plan_entries():
    """``flash_attention.cu``'s plan variants (``FLASH_PROBES``): the launch
    of variant v at D and its build's facts (``PLAN_INFO``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    dll = _build.load_probe("flash_attention", "FLASH_PROBES")
    launch = dll.flash_attention_wgmma_variant
    launch.argtypes, launch.restype = [ctypes.c_int] + ops.ENTRIES["wgmma"][1], ctypes.c_int
    info = dll.flash_attention_variant_info
    info.argtypes, info.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    return launch, info


def plan_launch(torch, variant: int, q, k, v, out, lse=None, **kw) -> None:
    from repro_torch.kernels.flash_attention import ops

    ptrs, mask = ops.entry_args(q, k, v, out, lse=lse, **kw)
    rc = plan_entries()[0](variant, *ptrs, *mask, torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"plan {variant} at D={q.shape[3]}: CUDA error {rc}")


def probe_plans(torch) -> dict:
    """The wgmma route's plans against each other (``wgmma_variants`` of
    ``flash_attention.cu``, variant 0 the plan the route ships),
    at the widths in ``$CARD_PROBE_WIDTHS`` (default all): each build's
    registers, spill and shared memory; each plan over phase 3b's edge
    cases at its width (``chip_smoke.flash_edge_cases``), o and its
    log-sum-exp against ``attention_ref`` (elements beyond
    ``smoke.flash_limit`` counted, not raised), a second launch byte-equal;
    then each served shape (``served_shapes``) timed in turns across the
    plans, the shipped plan with P as one bf16 term (``p_bf16``, the probe
    entry: what the lo term costs) and ``scaled_dot_product_attention``
    (where it computes the same function), by CUDA events over back-to-back
    calls, by the device time of each call's kernels (a profiler trace) and
    by the host's time to enqueue a call; with the bound (4*D a visible
    pair at 989 TFLOP/s) and the split bound (6*D)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ref

    dev = torch.device("cuda", 0)
    widths = [int(w) for w in os.environ.get("CARD_PROBE_WIDTHS", "64,128,160,256").split(",")]
    out = {"card": smoke.smi()}
    for D in widths:
        plans = {}
        for variant in range(16):
            vals = (ctypes.c_int * len(PLAN_INFO))()
            if plan_entries()[1](D, variant, ctypes.addressof(vals)):
                break
            plans[variant] = dict(zip(PLAN_INFO, vals))
        checks = {v: {"cases": 0, "beyond_limit": 0, "max_abs_err": 0.0, "lse_beyond": 0,
                      "repeat_equal": True, "lse_leaves_o": True} for v in plans}
        gen = torch.Generator(dev).manual_seed(0)
        for B, Hq, Hkv, Sq, Skv, d, kw in smoke.flash_edge_cases():
            if d != D:
                continue
            kw = {"window": None, "softcap": None, **kw}
            q, k, v = bf16_qkv(torch, gen, B, Hq, Hkv, Sq, Skv, D)
            want, want_lse = ref.attention_ref(q, k, v, return_lse=True, **kw)
            w = want.float()
            seen = torch.isfinite(want_lse)
            for variant, c in checks.items():
                o1, o2, o3 = (torch.empty_like(q) for _ in range(3))
                lse = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
                plan_launch(torch, variant, q, k, v, o1, **kw)
                plan_launch(torch, variant, q, k, v, o2, **kw)
                plan_launch(torch, variant, q, k, v, o3, lse=lse, **kw)
                diff = (o1.float() - w).abs()
                ldiff = (lse[seen] - want_lse[seen]).abs()
                c["cases"] += 1
                c["beyond_limit"] += (diff > smoke.flash_limit(w, "bfloat16")).sum().item()
                c["max_abs_err"] = max(c["max_abs_err"], diff.max().item())
                c["lse_beyond"] += (ldiff > smoke.LSE_TOL + smoke.LSE_TOL
                                    * want_lse[seen].abs()).sum().item() + \
                    (lse[~seen] != torch.inf).sum().item()
                c["repeat_equal"] &= torch.equal(o1, o2)
                c["lse_leaves_o"] &= torch.equal(o1, o3)
        timing = {}
        for name, shape, kw in served_shapes(D):
            q, k, v = bf16_qkv(torch, gen, *shape, D)
            outs = {variant: torch.empty_like(q) for variant in plans}
            calls = {f"plan_{variant}": (lambda variant=variant: plan_launch(
                torch, variant, q, k, v, outs[variant], **kw)) for variant in plans}
            p_bf16 = torch.empty_like(q)
            calls["p_bf16"] = lambda: probe_launch(torch, q, k, v, p_bf16, **kw)
            if kw["window"] is None and kw["softcap"] is None:
                calls["sdpa"] = lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=kw["causal"], enable_gqa=True)
            turns = smoke.in_turns(torch, calls, 10)
            device = {n: sum(smoke.kernel_device_ms(torch, fn, 10).values())
                      for n, fn in calls.items()}
            host = {}
            for n, fn in calls.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    fn()
                host[n] = (time.perf_counter() - t0) / 10 * 1e3
                torch.cuda.synchronize()
            want = ref.attention_ref(q, k, v, **kw).float()
            pairs = shape[0] * shape[1] * smoke.visible_pairs(shape[3], shape[4], kw["causal"],
                                                              kw["window"])
            bound = max(sum(t.numel() * 2 for t in (q, k, v, q)) / smoke.HBM_BYTES_PER_S,
                        4 * D * pairs / smoke.BF16_OPS_PER_S) * 1e3
            timing[name] = {
                "shape": f"q {list(q.shape)} k {list(k.shape)} {kw}",
                "ms": {n: sum(t) / len(t) for n, t in turns.items()}, "turns": turns,
                "device_ms": device, "host_enqueue_ms": host,
                "bound_ms": bound,
                "bound_split_ms": max(bound, 1.5 * 4 * D * pairs / smoke.BF16_OPS_PER_S * 1e3),
                "max_abs_err": {variant: (o.float() - want).abs().max().item()
                                for variant, o in outs.items()}}
            del q, k, v, outs, want
            torch.cuda.empty_cache()
        out[D] = {"plans": plans, "checks": checks, "timing": timing}
        print(json.dumps({"plans_width": D, **out[D]}), flush=True)
    return out


STEP_MARKS = ("start", "kv_landed", "turn_taken", "issued", "s_landed", "softmax_done",
              "pv_landed", "p_ready")
STEP_SHAPES = ("seamless_enc", "pixtral", "zamba2", "gemma2_global")


def probe_steps(torch) -> dict:
    """Where a step of the wgmma route's pipelined schedule spends its
    cycles: the shipped plan at one served shape a width
    (``STEP_SHAPES``), built with TRACE = 1 (the probe entry
    ``flash_attention_wgmma_trace``), so that thread 0 of each consumer of
    CTA 0 (the longest causal band) writes ``clock64()`` at ``STEP_MARKS``
    of each step that issues both products.  Per consumer: the median
    cycles between consecutive marks and of a whole step over the steps
    after the first two and before the last, the step count, and the
    tensor-core cycles a step needs (both consumers' S and P V at the
    card's dense bf16 rate, 4,096 flops a cycle an SM); with the SM clock
    that ``nvidia-smi`` reads."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(1)
    dll = _build.load_probe("flash_attention", "FLASH_PROBES")
    fn = dll.flash_attention_wgmma_trace
    fn.argtypes, fn.restype = [ctypes.c_void_p] + ops.ENTRIES["wgmma"][1], ctypes.c_int
    steps, marks = 256, len(STEP_MARKS)
    out = {"card": smoke.smi(), "sm_clock": smoke.smi("clocks.sm,clocks.max.sm")}
    for D in ops.WGMMA_HEAD_DIMS:
        for name, shape, kw in served_shapes(D):
            if name not in STEP_SHAPES:
                continue
            q, k, v = bf16_qkv(torch, gen, *shape, D)
            o = torch.empty_like(q)
            info = ops.kernel_info(q.dtype, D)
            trace = torch.zeros(2 * steps * marks, dtype=torch.int32, device=dev)
            ptrs, mask = ops.entry_args(q, k, v, o, **kw)
            for _ in range(3):   # the last launch's marks stay
                rc = fn(trace.data_ptr(), *ptrs, *mask, torch.cuda.current_stream(dev).cuda_stream)
                if rc:
                    raise RuntimeError(f"trace at D={D}: CUDA error {rc}")
            torch.cuda.synchronize()
            tr = trace.view(2, steps, marks).cpu().numpy().astype(np.int64) & 0xFFFFFFFF
            rows = {}
            for cw in range(2):
                used = tr[cw][tr[cw, :, 0] != 0]
                n = len(used)
                mid = used[2:n - 1] if n > 4 else used
                gaps = (np.diff(mid, axis=1) % 2**32)
                whole = (np.diff(mid[:, 0]) % 2**32) if len(mid) > 1 else np.zeros(1)
                rows[f"consumer_{cw}"] = {
                    "steps": n,
                    "median_cycles": {f"{STEP_MARKS[i]}->{STEP_MARKS[i + 1]}":
                                      float(np.median(gaps[:, i])) for i in range(marks - 1)},
                    "median_step_cycles": float(np.median(whole))}
            bk = info["key_rows"]
            flops = 2 * 64 * bk * D * 2 + 2 * 2 * 64 * bk * D * 2   # both consumers' S and hi + lo P V
            out[name] = {"shape": f"q {list(q.shape)} k {list(k.shape)} {kw}", "key_rows": bk,
                         "tensor_cycles_a_step": flops / 4096, **rows}
            del q, k, v, o
            torch.cuda.empty_cache()
    return out


BWD_TURN_ROUNDS, BWD_TURN_ITERS = 3, 20
# the tf32x3 backward's plans: (resident rows, streamed rows BN, stages) and
# why each was or was not built (csrc/flash_attention_bwd.cu, hazard 11)
BWD_TF32X3_PLANS = {
    "128 x 32 x 2 (shipped)": "resident 128 KB + 2 stages x 48 KB = 230,968 B",
    "128 x 32 x 3": "not built: 278 KB > 227 KB",
    "128 x 64 x 2": "not built: 128 KB + 2 x 96 KB = 320 KB > 227 KB",
    "64 x 32 x 2": "not built: one consumer warpgroup a CTA, 160 KB, still 1 CTA an SM",
}


def base_bwd_entry():
    """The ffma backward's entry as ``$CARD_PROBE_BASE``'s
    ``flash_attention_bwd.cu`` has it (the parent's route at float32 D 64),
    built with the port's flags into ``build/probes/``."""
    import subprocess

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    src = os.path.join(os.environ["CARD_PROBE_BASE"],
                       "src/repro_torch/csrc/flash_attention_bwd.cu")
    dest = _build.PROBE_DIR / "flash_attention_bwd-base.so"
    dest.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(dest), src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}: {proc.stdout}{proc.stderr}")
    name, argtypes = ops.BWD_ENTRIES["ffma"]
    fn = getattr(ctypes.CDLL(str(dest)), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def probe_bwd(torch) -> dict:
    """The backward at each ``BWD_MODEL_SHAPES`` shape (device ms by kernel
    and CUDA-event ms), then at tspm-mlho's layer the tf32x3 route in turns
    with ffma forced (``force_route``) and, given ``$CARD_PROBE_BASE``, with
    the parent's build (its ffma entry), ``BWD_TURN_ROUNDS`` rounds of
    ``BWD_TURN_ITERS`` calls each way; device ms by kernel of each; the
    tf32x3 plans tried and its CTAs against the card's SMs."""
    from repro_torch.kernels.flash_attention import ops, ref

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
        del q, k, v, do, o, lse
    shape, dtype, kw = smoke.BWD_MODEL_SHAPES["tspm_mlho"]
    B, Hq, Hkv, Sq, Skv, D = shape
    q, k, v, do = smoke.bwd_inputs(torch, dev, shape, dtype, 11)
    o, lse = ops.attention(q, k, v, return_lse=True, **kw)
    mask = {"window": None, "softcap": None, **kw}
    calls = {"ffma": lambda: ops._backward(q, k, v, o, do, lse, force_route="ffma", **mask),
             "tf32x3": lambda: ops.attention_bwd(q, k, v, o, do, lse, **kw)}
    if "CARD_PROBE_BASE" in os.environ:
        fn = base_bwd_entry()
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        scratch = torch.empty(B * Hq * Sq, device=dev)
        ptrs, args = ops.entry_args(q, k, v, o, causal=True, window=None, softcap=None)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def parent():
            rc = fn(*ptrs[:4], do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), scratch.data_ptr(), *ptrs[5:], 0, *args, stream)
            assert rc == 0, rc
            return dq, dk, dv
        calls["parent_ffma"] = parent
    want64, _, _, limits = ref.attention_bwd_limit(q, k, v, o, do, **kw)
    ratio = {n: max(((g.double() - w).abs() / lim).max().item()
                    for g, w, lim in zip(fn_(), want64, limits)) for n, fn_ in calls.items()}
    turns = {n: [] for n in calls}
    for _ in range(BWD_TURN_ROUNDS):
        for n, t in smoke.in_turns(torch, calls, BWD_TURN_ITERS).items():
            turns[n] += t
    device = {n: smoke.kernel_device_ms(torch, fn_, 10) for n, fn_ in calls.items()}
    key_ctas = B * Hkv * -(-Skv // 128)
    out["tspm_mlho_turns"] = {
        "shape": f"q {[B, Hq, Sq, D]} k/v {[B, Hkv, Skv, D]} {dtype} {kw}",
        "ms": {n: sum(t) / len(t) for n, t in turns.items()}, "turns_ms": turns,
        "ratio_to_limit": ratio, "device_ms": device,
        "device_sum_ms": {n: sum(d.values()) for n, d in device.items()},
        "plans": BWD_TF32X3_PLANS, "info": ops.bwd_kernel_info(torch.float32, 64),
        "ctas": {"dK": key_ctas, "dV": key_ctas, "dQ": B * Hq * -(-Sq // 128),
                 "sms": torch.cuda.get_device_properties(dev).multi_processor_count}}
    return out


BINDING_ROUNDS, BINDING_ITERS = 3, 50


def probe_binding(torch) -> dict:
    """The attention kernels' binding as ``torch.library.custom_op``s
    against the binding before it (the wrapper's checks, then the
    ``ctypes`` launch called directly: ``ops._forward`` / ``ops._backward``),
    at tspm-mlho's prefill shape (the forward, float32, tf32x3) and
    gemma2-2b's training layer (the backward, bfloat16, wgmma), timed in
    turns (old, op, op, old) ``BINDING_ROUNDS`` times with CUDA events over
    ``BINDING_ITERS`` calls each; outputs compared byte for byte; and the
    host's microseconds a call, enqueued without a synchronize (what the
    op's dispatch adds)."""
    from repro_torch.kernels.flash_attention import ops

    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(5)
    q = torch.randn(8, 12, 896, 64, generator=g, device=dev)
    k, v = (torch.randn(8, 4, 896, 64, generator=g, device=dev) for _ in range(2))
    kw = dict(causal=True, window=None, softcap=None)

    def fwd_old():
        ops._check_shapes(q, k, v)
        return ops._forward(q, k, v, **kw)[0]

    shape, dtype, bkw = smoke.BWD_MODEL_SHAPES["gemma2_2b"]
    bq, bk, bv, bdo = smoke.bwd_inputs(torch, dev, shape, dtype, 11)
    bo, blse = ops.attention(bq, bk, bv, return_lse=True, **bkw)

    def bwd_old():
        ops._check_shapes(bq, bk, bv)
        return ops._backward(bq, bk, bv, bo, bdo, blse, **bkw)

    calls = {"forward": {"old": fwd_old, "op": lambda: ops.attention(q, k, v, **kw)},
             "backward": {"old": bwd_old,
                          "op": lambda: ops.attention_bwd(bq, bk, bv, bo, bdo, blse, **bkw)}}
    out = {"card": smoke.smi(),
           "forward_shape": "q [8,12,896,64] k/v [8,4,896,64] float32 causal (tf32x3)",
           "backward_shape": f"{shape} {dtype} {bkw} (wgmma)"}
    for name, pair in calls.items():
        a, b = (pair[n]() for n in ("old", "op"))
        same = all(torch.equal(x, y) for x, y in zip(
            a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)))
        turns = {"old": [], "op": []}
        for _ in range(BINDING_ROUNDS):
            for n, t in smoke.in_turns(torch, pair, BINDING_ITERS).items():
                turns[n] += t
        host = {}
        for n, fn in pair.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(BINDING_ITERS):
                fn()
            host[n] = (time.perf_counter() - t0) / BINDING_ITERS * 1e6
            torch.cuda.synchronize()
        ms = {n: sum(t) / len(t) for n, t in turns.items()}
        out[name] = {"ms": ms, "turns_ms": turns, "op_over_old": ms["op"] / ms["old"] - 1,
                     "host_us_per_call": host, "outputs_equal": same}
    return out


def tspm_step_trace(torch, force_ffma: bool) -> dict:
    """One full-size tspm-mlho training step (12 layers, float32, a batch of
    ``smoke.TRAIN_BATCH`` x ``smoke.TRAIN_SEQ`` seeded tokens) under the
    profiler after two warm steps (``traced``): device ms by family, the
    attention backward's among them; with ``force_ffma`` every backward
    takes the ffma route (``ops._backward``'s ``force_route``), the
    parent's route at this width."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import model as model_lib
    from repro_torch.training import optimizer as opt_lib, train_loop

    dev = torch.device("cuda", 0)
    cfg = get_config("tspm-mlho")
    mdl = model_lib.build(cfg)
    state = train_loop.init_state(mdl, torch.Generator(dev).manual_seed(smoke.SEED))
    toks = np.random.default_rng(smoke.SEED).integers(
        4, cfg.vocab_size, (smoke.TRAIN_BATCH, smoke.TRAIN_SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": np.ones((smoke.TRAIN_BATCH, smoke.TRAIN_SEQ), bool)}
    step = train_loop.make_train_step(mdl, opt_lib.OptConfig(
        peak_lr=1e-4, warmup_steps=0, decay_steps=100))
    original = ops._backward
    if force_ffma:
        ops._backward = functools.partial(original, force_route="ffma")
    try:
        for _ in range(2):
            state, _ = step(state, batch)
        before = dict(ops.attention_bwd.route_launches)
        metrics = {}
        r = traced(torch, lambda: metrics.update(step(state, batch)[1]), {
            "attention_bwd": ("bwd_tf32x3_kernel", "tf32x3_bwd_split_kernel", "prepass_kernel",
                              "dq_kernel", "dkv_kernel", "bwd_wgmma_kernel"),
            "attention_fwd": ATTENTION_FWD, "matmul": MATMUL})
        launches = {n: c - before[n] for n, c in ops.attention_bwd.route_launches.items()}
    finally:
        ops._backward = original
    bwd = r["device_ms_by_family"]["attention_bwd"]
    return {**r, "bwd_launches": launches, "loss": float(metrics["loss"]),
            "attention_bwd_share_of_busy": bwd / r["device_busy_ms"],
            "attention_bwd_share_of_wall": bwd / r["wall_ms"]}


def probe_step(torch) -> dict:
    """tspm-mlho's training step under the profiler on the tf32x3 backward
    and, in turns, with the ffma backward forced (tf32x3, ffma, ffma,
    tf32x3): the attention backward's share of the step read off the trace.
    Given ``$CARD_PROBE_BASE``, also gemma2-2b's phase 10 (c) steps as this
    checkout and the parent run them, in turns."""
    out = {"card": smoke.smi(), "tspm_mlho": {"tf32x3": [], "ffma": []}}
    for key in ("tf32x3", "ffma", "ffma", "tf32x3"):
        out["tspm_mlho"][key].append(tspm_step_trace(torch, key == "ffma"))
    if "CARD_PROBE_BASE" in os.environ:
        out["gemma2_2b"] = gemma_steps_against_base()
    return out


def gemma_steps_against_base() -> dict:
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
    out = {"base": base, "base_steps": [], "this_steps": []}
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


GLOO_PROBE_WORLD, GLOO_PROBE_LIMIT_S = 4, 60
GLOO_OPS = ("all_reduce_f32", "all_reduce_i32", "all_reduce_i64_max", "all_reduce_0d",
            "broadcast", "barrier", "all_gather", "all_gather_into_tensor",
            "reduce_scatter_tensor", "all_to_all_single", "funcol_all_reduce",
            "funcol_all_gather", "funcol_reduce_scatter", "device_mesh_cuda",
            "dtensor_redistribute")
GLOO_FIXED = ("funcol_all_gather", "dtensor_redistribute")


def gloo_op(torch, name: str, rank: int, world: int):
    """One collective on ``cuda:0`` tensors; -> what rank 0 reads back."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol

    dev = torch.device("cuda", 0)
    t = torch.arange(8, dtype=torch.float32, device=dev) + rank
    group = dist.group.WORLD
    if name.startswith("all_reduce"):
        x = {"all_reduce_f32": t, "all_reduce_i32": t.to(torch.int32),
             "all_reduce_i64_max": t.to(torch.int64), "all_reduce_0d": t.sum()}[name]
        dist.all_reduce(x, op=dist.ReduceOp.MAX if name.endswith("max") else dist.ReduceOp.SUM)
        return x.tolist()
    if name == "broadcast":
        dist.broadcast(t, 0)
        return t.tolist()
    if name == "barrier":
        dist.barrier()
        return "ok"
    if name == "all_gather":
        out = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(out, t)
        return [o[0].item() for o in out]
    if name == "all_gather_into_tensor":
        out = torch.empty(world * 8, device=dev)
        dist.all_gather_into_tensor(out, t)
        return out[::8].tolist()
    if name == "reduce_scatter_tensor":
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, torch.arange(world * 2, dtype=torch.float32, device=dev))
        return out.tolist()
    if name == "all_to_all_single":
        x = torch.arange(world * 2, dtype=torch.float32, device=dev) + 100 * rank
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out.tolist()
    if name == "funcol_all_reduce":
        return funcol.all_reduce(t, "sum", group).tolist()
    if name == "funcol_all_gather":
        return funcol.all_gather_tensor(t, 0, group)[::8].tolist()
    if name == "funcol_reduce_scatter":
        return funcol.reduce_scatter_tensor(t, "sum", 0, group).tolist()
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cuda", (2, world // 2), mesh_dim_names=("data", "model"))
    if name == "device_mesh_cuda":
        return str(mesh)
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)

    x = torch.arange(16, dtype=torch.float32, device=dev).reshape(4, 4)
    d = distribute_tensor(x, mesh, [Shard(0), Shard(1)], src_data_rank=None)
    p = DTensor.from_local(torch.ones(4, 4, device=dev), mesh, [Partial(), Replicate()])
    rep = [Replicate(), Replicate()]
    return {"full_tensor": d.full_tensor().sum().item(),
            "shard_to_replicate": d.redistribute(mesh, rep).to_local().sum().item(),
            "partial_to_replicate": p.redistribute(mesh, rep).to_local().sum().item(),
            "partial_to_shard": p.redistribute(mesh, [Shard(0), Replicate()]).to_local()
            .sum().item()}


def gloo_rank(rank: int, world: int, tmp: str, name: str, fixed: bool) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(smoke.SRC))
    from repro_torch.launch.mesh import gloo_cuda_all_gather

    torch.cuda.set_device(0)
    registered = gloo_cuda_all_gather() if fixed else None  # noqa: F841
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world)
    try:
        try:
            out = {"ok": gloo_op(torch, name, rank, world)}
            torch.cuda.synchronize()
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out = {"raised": f"{type(e).__name__}: {e}"[:300]}
        if rank == 0:
            with open(f"{tmp}/out.json", "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def probe_gloo(torch) -> dict:
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    out = {}
    for name, fixed in [(n, False) for n in GLOO_OPS] + [(n, True) for n in GLOO_FIXED]:
        key = f"{name} (gloo_cuda_all_gather)" if fixed else name
        with tempfile.TemporaryDirectory(prefix="gloo_probe_") as tmp:
            ctx = mp.start_processes(gloo_rank, args=(GLOO_PROBE_WORLD, tmp, name, fixed),
                                     nprocs=GLOO_PROBE_WORLD, join=False,
                                     start_method="spawn")
            t0 = time.perf_counter()
            try:
                while not ctx.join(timeout=2):
                    if time.perf_counter() - t0 > GLOO_PROBE_LIMIT_S:
                        for p in ctx.processes:
                            p.kill()
                        out[key] = {"hung": GLOO_PROBE_LIMIT_S}
                        break
                else:
                    with open(f"{tmp}/out.json") as f:
                        out[key] = json.load(f)
            except ProcessException as e:      # a signal, or an exception it raised
                out[key] = {"died": str(e)[:500]}
        print(f"gloo probe {key}: {json.dumps(out[key])}", flush=True)
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
              "steptrace": probe_steptrace, "moe": probe_moe, "binding": probe_binding,
              "gloo": probe_gloo, "plans": probe_plans, "steps": probe_steps}
    if not argv and "CARD_PROBE_BASE" not in os.environ:
        for name in ("lse", "widths"):
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
