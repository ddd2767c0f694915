"""Measurements of the PyTorch/CUDA port on one NVIDIA GPU that the smoke
test (``chip_smoke.py``) does not take.

Run from the root of a checkout, with one visible CUDA device:

    python3 card_probe.py [idle] [share] [price] [scratch] [flex] [psplit] [tf32]

(all seven when none is named).  Each prints one JSON line:

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
         limit.

``psplit`` and ``tf32`` build ``csrc/flash_attention.cu`` once more with
``-DFLASH_PROBES`` into ``build/probes/``: the measurement variants live
only in that library, never in the one the port loads.

The last line is ``nvidia-smi``'s name and power limit of the card.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

import chip_smoke as smoke

SHARES = (0.25, 0.5, 0.125, 0.0625)     # visited forward, then backward
PRICE_BUDGETS = (64 << 20, 128 << 20, 512 << 20, 1 << 30, 4 << 30)


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
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    src = _build.CSRC / "flash_attention.cu"
    lib = _build.BUILD_DIR.parent / "probes" / f"{_build.library_path(src).stem}-probes.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DFLASH_PROBES", "-o",
                               str(lib), str(src)], capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc -DFLASH_PROBES failed:\n{done.stdout}{done.stderr}")
    dll = ctypes.CDLL(str(lib))
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


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("card_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(smoke.SRC))
    from repro_torch.kernels import _build

    _build.build_all()
    probes = {"idle": probe_idle, "share": probe_share, "price": probe_price,
              "scratch": probe_scratch, "flex": probe_flex, "psplit": probe_psplit,
              "tf32": probe_tf32}
    for name in argv or list(probes):
        t0 = time.perf_counter()
        result = probes[name](torch)
        print(json.dumps({"probe": name, "seconds": time.perf_counter() - t0,
                          "result": result}), flush=True)
    print(f"nvidia-smi: {smoke.smi()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
