"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with one visible CUDA device:

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/csrc`` with
``nvcc`` (into ``build/kernels/``), then:

  1. prints the device (``torch.cuda.get_device_name`` and ``nvidia-smi``'s
     name and power limit);
  2. builds the kernels and prints the build seconds;
  3. holds each kernel byte for byte against its plain PyTorch version on
     the card, at edge shapes (P = 0, E = 0/1/127/128/129, nevents 0/1,
     duplicate codes and dates, both codecs with and without the fused
     duration); ``seq_hist`` at every H = 1..24 (15 and 16 are the edge
     of the one-partition case) with SENTINEL ids present, 3 elements off
     16-byte alignment, zero counted ids, every id in one bucket and ids
     out of range on both sides; ``tspm_fused`` against
     ``fused_table_ref`` for both codecs at every H = 1..24 (and against
     ``block_bucket_counts`` at H = 1/2/8/12/15/16/20/24), including a
     one-code cohort whose ids collide in one bucket, and at H =
     15/16/20/24 in rounds of about a patient each (a launch a round, one
     table); ``tspm_delta`` against ``delta_mine_torch`` for both codecs
     with and without the fused duration (P/E/D = 0, E and D at
     127/128/129, rows with no delta, an empty delta window, a single-event
     history, a history at full plane capacity), and the identity "pairs
     before the delta + the delta slab = the full mine"; and (phase 3b,
     run after phase 7 with phase 9) ``flash_attention`` against
     ``attention_ref`` in float32 (within 2e-5 + 2e-5 |want|) and bfloat16
     (within 2e-5 + 2^-6 |want|, two bfloat16 ulps; each case's median and
     max |want| printed beside a planted fault the limit must catch) at Sq = Skv = 1/127/128/129/200, Sq != Skv causal and not,
     D = 32/64/128/256, GQA groups 1/2/3/8, windows 1/16/4,096 at
     S = 8,192, softcap 50 and rows that see no key, and, for the wgmma
     route (bfloat16 at D = 64/128/256), S = 1/63/129/1,000 and
     Sq != Skv (63/1,000, 1,000/129) causal and not at each of its head
     widths, GQA groups 1/2/4/8, windows 1 and 300 with softcap 50 and rows
     that see no key at D = 256; the float32 cases at D = 64 (with a window
     of 300 and softcap 50 added at S = 700) take the tf32x3 route; D 160
     (wgmma's three 64-column boxes in bfloat16, ffma in float32) at S =
     1/63/127/128/129/1,000, Sq != Skv (63/1,000, 1,000/129) causal and
     not, GQA groups 1/2/4/8, windows 1 and 300 with softcap 50 and rows
     that see no key, its last 32 columns also held on their own; each
     case must launch the route ``ops.route`` names for it and give the
     same bytes when launched again; every forward
     build's registers, spill and shared memory printed (the tensor-core
     builds and float32 D 160 must spill nothing); then
     ``flash_attention_bwd`` (each build's registers, spill and shared
     memory printed once; the wgmma and tf32x3 builds and float32 D 160
     must spill nothing) against ``attention_bwd_ref`` in float64 at
     S = 1/127/128/129, Sq != Skv causal and not, D = 16/32/64/128/256,
     GQA groups 1/2/3/8, windows 1/16, softcap 50 and rows that see no key,
     in both dtypes (float32 at D 64 is the tf32x3 route, whose pre-pass
     must also write its plain twin ``ref.tf32x3_bwd_operands`` byte for
     byte); at D 160 (wgmma's three boxes in bfloat16, ffma in
     float32) S = 1/127/128/129, Sq != Skv causal and not, GQA groups
     1/2/4/8, windows 1/16, softcap 50 and rows that see no key, its last
     32 columns also held on their own; and at tspm-mlho's (q
     [8,12,256,64], float32, causal), gemma2-2b's (q [1,8,2048,256],
     bfloat16, window 4,096, softcap 50), zamba2-2.7b's (q
     [1,32,4096,160], bfloat16, causal, and [1,32,256,160] in float32),
     seamless-m4t-large-v2's encoder (q [2,16,1024,64], bfloat16, not
     causal), deepseek-moe-16b's (q [4,16,512,128]) and pixtral-12b's (q
     [2,32,1088,128], kv heads 8) bfloat16 training shapes, each
     run twice for identical bytes; the limit
     (``ref.attention_bwd_limit``) is ``BWD_ERR_FACTOR`` times the float32
     plain version's own distance from
     float64 (plus the rounding to bfloat16), printed per case beside a
     planted fault (the first query row's output gradient dropped) that it
     must catch; and times the backward at those training shapes beside its
     bound, its plain version and ``scaled_dot_product_attention``'s
     backward, and at tspm-mlho's the tf32x3 route in turns with ffma
     (``force_route``);
  4. drives the main path — ``MiningSession(...).fit(db)`` then
     ``frame.screen().collect()`` — on the paper's Table 1 cohort (4,985
     patients at ~471 events, first-occurrence filter) with
     ``screen='hash'`` and then ``screen='sorted'``, with the kernels'
     launch counts set to 0 just before each and read just after; it checks
     the row count against ``count_sequences``, the hash table's sum
     against the distinct (patient, id) pairs, and that the exact screen's
     kept set lies inside the hash screen's;
     then runs the ``chunked`` and ``files`` engines on the same cohort at
     one ``budget_bytes``, and the ``chunked`` engine again at 512 MiB, and
     requires the same rows in the same order, the same bucket table (no
     host sort: rows come in patient order) and each fit's peak device
     memory within its ``budget_bytes``; in between (phase 4c) the hash
     session serves its Table 1 frame through ``session.serve()``: the
     reference's serving mix cut to 2 distinct plans (2,048 zipf-drawn
     queries from 32 client threads), each distinct plan's keep mask equal to the
     frame chain's, the predicate op timed alone, and every byte of device
     memory the server took given back when it goes;
  5. holds the session on the card against the session on the CPU (plain
     versions) on the first 128 patients, byte for byte, for every engine
     (batch, chunked, files) under every screen (sorted, hash, fused), and
     for a 3-wave stream replay under a budget that evicts through the
     host and disk tiers (same rows, table and tier placement), and the
     same replay through 3 shards (balanced router, rebalancing every 2
     ticks, 8 migrations after wave 2, a spilled patient among them: same
     rows, merged table, tiers and router pins); and live query serving
     on an 8-wave stream replay (a server built before the first submit,
     streaming features; the 24-plan pool queried after each wave and
     through the background loop while the next wave ticks): every mask
     equals the frame chain on its view, and the card's ``query_batch``
     results and ``features()`` equal the CPU's;
  6. times each kernel at the main path's full-size shapes with CUDA
     events, beside its bound, its plain version and a library call
     (``seq_hist`` at each of the fit's patient blocks of at most 2^26
     ids, as the hash fit launches it, and over the whole slab; the two
     counting kernels' counted adds a second); ``seq_hist`` (each block,
     the stream's largest tick, the slab hashed to 2^12 buckets) and
     ``tspm_fused`` (both tables) in turns with the kernels before the
     partitioned design (the ``-DCOUNT_PROBES`` build), with each stage's
     device time from a profiler trace; ``tspm_delta``'s launch also by
     its device time; counts ``tspm_fused``'s launches (a round each) in a
     fused batch fit, and times the phases of the fit;
  7. drives the paper's Table 2 cohort (35,000 patients at ~318 events,
     E = 240) through ``MiningSession(engine='chunked', screen='hash')``
     and ``MiningSession(screen='fused')`` at the same ``budget_bytes``,
     and requires the fused table to equal the chunked engine's merged
     table, the fused survivors to equal the chunked rows that the table
     keeps, in the same order, both fits to peak within ``budget_bytes``,
     and the corpus-free counting pass alone to peak under 1 GB of device
     memory; it times ``tspm_fused`` there;
  8. drives the streaming path at Table 1 (between phases 6 and 7): the
     stream fit, a 3-wave replay through ``session.submit``/``run``, the
     same replay of the cohort's first 1,248 patients under a 1 GiB budget
     (eviction, host-tier restores) and the fused screen on the stream
     engine, each with the launch counts zeroed just before and read just
     after (``tspm_delta`` launches = ticks); the sketch table must equal
     the batch engine's and the rows the batch rows as multisets (sorted on
     the card), the evicting replay the plain replay's rows of its patients
     row for row; then (e) the 3-wave replay of those 1,248 patients
     through 4 shards (``placement='host'``, hash router, rebalancing every
     32 ticks, the 64 heaviest patients migrated after wave 2):
     ``tspm_delta`` launches = shard ticks, merged table = their batch
     table, rows = their batch rows as multisets; (f) the same under
     ``placement='devices'`` (every shard on the card, two-pass ticks,
     async admits), checkpointed after wave 2,
     restored in this process and finished there: byte-identical to (e),
     journaled across the restore, and its journal verifies; (g) (c) again
     with a tick journal: byte-identical to (c), the journal verifies
     (``tspm_delta`` launched once a replayed tick), replays on the card to
     the live ``state_digest``, stops at ``upto_tick``, and convicts a
     flipped segment byte and a re-chained forged delta; then the
     streaming launcher (``python -m repro_torch.launch.stream
     --shards 4 --router hash --rebalance-every 4``) runs through with
     ``--journal-dir``, stops after wave 3 with a checkpoint and resumes
     to that run's ``state_digest``, and ``--replay-journal`` gives the
     same digest; ``launch.serve --workload
     queries`` and ``examples/quickstart_torch.py`` run in their own
     processes; and times ``tspm_delta`` at the fit's largest
     slab and ``seq_hist`` at the stream's largest tick (beside its plain
     version and ``torch.bincount``);
  9. serves LM requests (last, after phase 3b; the LM side's matmuls
     leave cuBLAS's workspace allocated, which the mining fits' absolute
     peaks would count against their budgets):
     ``tspm-mlho`` at full size from a seeded init answers 16 prompts of
     896 tokens (Table 1 patient documents, ``data/tokenize``) with 64 new
     tokens each through ``ServeEngine(batch_size=8, max_len=1024)``, two
     waves, with the launch counts zeroed just before ``run`` and read just
     after (``flash_attention`` = 12 layers x 2 waves); its first wave must
     equal the same engine's on the CPU (plain versions, the same weights),
     token for token except at near ties (top-1/top-2 margin < 1e-4), and
     its logits (prefill and every decode step) must lie within
     ``LM_LOGIT_TOL`` of the CPU's, a limit that two planted deviations
     served on the card (the weights in bfloat16, RoPE on half-split
     pairs) must each break;
     ``gemma2-2b`` at full size (26 layers, bf16) answers 2 random prompts
     of 8,192 tokens (8 new), and the kernel is held against its plain
     version on the q/k/v of the first local and the first global layer;
     tspm-mlho's 24 launches must all take the tf32x3 route and gemma2-2b's
     26 the wgmma route; the kernel is timed at these three shapes beside
     its bound, its plain version and (tspm-mlho)
     ``scaled_dot_product_attention`` (every ``time_flash`` of phase 9
     times that call in turns with the kernel, and records both device
     times from a profiler trace), and at tspm-mlho's shape the ffma
     route is timed in turns with tf32x3, and tf32x3's pre-pass and main
     kernel are timed on the device from a ``torch.profiler`` trace;
     then the MoE and VLM families, each model freed before the next and
     allocated device memory after them within 1 GiB of before:
     (d) deepseek-moe-16b's full widths (d 2,048, 64 experts of 1,408,
     top-6, 2 shared, vocab 102,400) cut to 2 layers, in float32, the same
     weights on the card and the CPU: one prefill of 2 x 128 seeded tokens
     and 8 decode steps on each; every layer's routing (``eid``, ``keep``,
     ``slot``) byte-equal first, a difference allowed only where the
     CPU's k-th against (k+1)-th probability margin is below 1e-5 (the
     smallest margin printed), then the logits of the requests whose
     routing agreed in every layer within ``MOE_LOGIT_TOL`` (at least one
     request compared), and the first MoE layer alone on one input;
     (e) deepseek-moe-16b at full size (28 layers, bf16, seeded init on
     the card) serves 8 seeded prompts of 512 tokens, 16 new each, through
     ``ServeEngine(batch_size=4, max_len=640)``: 56 ``flash_attention``
     launches, all wgmma, no backward; prefill s a wave, decode ms a step,
     tokens/s, peak device memory and the first prefill's dropped
     assignments at the config's capacity factor; then, at
     ``capacity_factor=16`` (no drops), prefill + decode logits against
     the train-mode forward at the same positions (the reference's check,
     tests/test_archs_smoke.py), read in bfloat16 and held with the same
     weights made float32 within 2e-3 on the requests whose routing agreed
     on both paths (each flip at a margin below 1e-5);
     (f) pixtral-12b at full size (40 layers, bf16): 2 requests of 1,024
     seeded patch embeddings + 64 tokens through ``model.apply`` prefill
     (40 launches, all wgmma, GQA 32/8), 8 decode steps, the same check at
     offset ``n_patches`` in bfloat16, within ``BF16_CONSIST_REL``, a
     limit the off-by-one rows must break; the kernel is timed at both prefill shapes
     beside its bound, its plain version and
     ``scaled_dot_product_attention``;
     then the xLSTM and hybrid families, each model freed before the next
     and allocated device memory after them within 1 GiB of before:
     (g) zamba2-2.7b's and xlstm-125m's full widths cut to 6 layers
     (zamba2: one group of 6 Mamba2 layers and one shared attention
     invocation at D 160, on ffma in float32; xlstm: 5 mLSTM and 1 sLSTM),
     in float32, the same weights on the card and the CPU: one prefill of
     1 x 256 seeded tokens and 8 decode steps on each, logits within
     ``RECUR_LOGIT_REL`` of the CPU's largest |logit|;
     (h) zamba2-2.7b at full size (54 Mamba2 layers, 2 shared blocks of 32
     heads x 160, bf16, seeded init on the card) serves 2 seeded prompts of
     4,096 tokens, 32 new each, through ``ServeEngine(batch_size=2,
     max_len=4128)``: one wave, 9 ``flash_attention`` launches, all wgmma
     at D 160 (each launch's head width recorded), no backward; prefill s a
     wave, decode ms a step, tokens/s and peak device memory; then prefill
     + decode logits against the train-mode forward (under no_grad) at 1 x
     (1,024 + 128) tokens (both in chunks of 128), read in bf16 and held
     with the weights made float32 within 2e-3; the kernel timed at the prefill shape (q
     [2,32,4,096,160]) beside its bound, its plain version and
     ``scaled_dot_product_attention``, and the ffma route at float32 D 160
     (q [1,32,1,024,160]);
     (i) xlstm-125m at full size (12 layers, bf16) serves 4 seeded prompts
     of 2,048 tokens, 32 new each, through ``ServeEngine(batch_size=4,
     max_len=2080)``: no ``flash_attention`` launch; the same readings and
     the same consistency check at 2 x (512 + 128) tokens;
     then the encoder-decoder family, each model freed before the next:
     (j) seamless-m4t-large-v2's full widths cut to 2 encoder and 2 decoder
     layers, in float32, the same weights on the card and the CPU: one
     prefill of 1 x (256 source frames + 64 target tokens) and 8 decode
     steps on each, logits within ``ENCDEC_LOGIT_REL`` of the CPU's
     largest, 6 tf32x3 launches a prefill; prefill + decode against the
     train-mode forward within 2e-3;
     (k) seamless-m4t-large-v2 at full size (24 + 24 layers, bf16, nothing
     cut): 2 x (1,024 seeded source frames + 64 tokens) prefill (72
     ``flash_attention`` launches, all wgmma at D 64: 24 encoder, 24
     decoder self- and 24 cross-attentions), then 32 greedy decode steps
     (no launch: one query row); prefill s, decode ms a step, tokens/s,
     peak device memory; the kernel timed at the encoder's and the
     cross-attention's prefill shapes;
 10. trains (last): (a) tspm-mlho at full width cut to 2 layers, batch 8
     x 256 tokens of the launcher's corpus, initialised on the CPU and
     copied to the card: step 1's gradients per parameter within
     ``TRAIN_GRAD_SHARE`` of its max |g|, and 3 train steps' loss, ce and
     grad norm within ``TRAIN_RTOL`` of the CPU's; (b) ``python -m
     repro_torch.launch.train --arch tspm-mlho --batch 8 --seq 256
     --patients 512 --ckpt-dir D`` in its own process, stopped at step 50
     (``--steps 50``), then rerun with ``--steps 100``, which must resume
     at step 50 from a state whose digest equals the saved one's; over
     the two runs' 100 steps, falling ce and 12 backward launches a step;
     each run's step time, tokens/s and peak device memory; (c)
     gemma2-2b at full width (every block checkpointed) takes 3 steps on
     one batch of 1 x 2,048 random tokens: finite, falling loss, 26
     backward launches a step, its step time and peak device memory;
     (d) deepseek-moe-16b (2 layers), pixtral-12b (2 layers; 128 patches
     + 128 tokens), xlstm-125m (6), zamba2-2.7b (6: its shared attention
     through the ffma backward at float32 D 160) and seamless-m4t-large-v2
     (2 + 2) at full widths in float32, the same weights on the card and
     the CPU: step 1's loss, ce and aux within ``TRAIN_RTOL`` and every
     gradient within ``TRAIN_GRAD_SHARE`` of its largest |g|, the MoE
     routing byte-equal; (e) 3 bf16 steps each, the config's remat:
     zamba2-2.7b at full size on 1 x 4,096 tokens (9 wgmma backward
     launches a step at D 160), seamless-m4t-large-v2 at full size on 2 x
     (1,024 + 1,024), xlstm-125m at full size on 2 x 1,024,
     deepseek-moe-16b (4 x 512) and pixtral-12b (2 x (1,024 patches +
     64)) at full width cut to 4 layers (peak under 60 GB): finite losses
     and gradient norms, backward launches by route, step s, tokens/s and
     peak device memory;
 11. the dry run (``launch/dryrun``) on fake ``cuda`` tensors, through the
     attention ops' fake implementations (last): (a) gemma2-2b's training
     step at 1 x 2,048 under remat (phase 10 (c)'s) and pixtral-12b's
     prefill of 2 x (1,024 patches + 64 tokens) (phase 9 (f)'s, its caches
     1,088 long) are traced fake and then run for real: the traced peak within
     ``DRY_PEAK_RATIO`` of ``max_memory_allocated`` (both above what was
     allocated before the step's inputs), ``FlopCounterMode``'s count of
     the fake step equal to that of the real one, ``costmodel.step_flops``
     over the count within the reference's band, and the step's ``mfu``
     (model FLOPs over its seconds times 989 TFLOP/s); (b) every assigned
     arch's ``decode_32k`` cell traces (``run_cell``), and the report's
     roofline and dry-run tables of those cells are printed;
 12. the dry run on the reference's production meshes (``launch/mesh``: a
     fake process group of 256 or 512 ranks, DTensor over it) on fake
     ``cuda`` tensors: (a) gemma2-2b's ``train_4k`` on ``pod16x16`` and
     deepseek-moe-16b's ``prefill_32k`` on ``pod2x16x16`` (its MoE layers on
     the expert-parallel path) each trace (``run_cell``) with collective
     bytes, every parameter's local shape is its sanitized spec's shard
     shape, and the per-rank peak, fit, collectives by kind,
     ``t_collective`` and trace seconds are printed; (b) both flash kernels
     launch at the local q/k/v shapes rank 0's attention op saw in
     gemma2-2b's trace, held against their plain versions (phase 3b's
     limits): the forward on every batch row, the backward on the first
     and the last;
 13. a real process group (last): 4 processes spawned on ``cuda:0``,
     joined over ``gloo`` with a ``file://`` rendezvous, each mesh a
     ``DeviceMesh`` of type ``cuda``, the world under its own time limit
     (``MESH_WORLD_LIMIT_S``): (a) tspm-mlho at full size (12 layers,
     float32) on phase 10's batch (8 x 256) on a 2 x 2 ``('data',
     'model')`` mesh (``pipeline.shard_batch``, ``param_shardings``):
     the loss within ``TRAIN_RTOL`` and every gathered gradient within
     ``TRAIN_GRAD_SHARE`` of the one-process step on the card, each
     rank's attention launches by route (forward and backward, not zero),
     the step's seconds and, in a profiled repeat, the host seconds in
     collective ops; (b) ``tree_compressed_psum_mean`` of the step's local
     gradients over 'data': each mean within half its quantization step of
     the exact all-reduced mean, each error ``g - q * scale`` exactly; (c)
     the full train state (parameters and seeded moments) resharded onto
     the 2 x 2 mesh, saved (``checkpoint.save``: gathered, rank 0 writes),
     restored and resharded onto the 1 x 2 mesh of ranks 0-1: byte-equal,
     ranks 2-3 holding no shard; (d) the Table 1 cohort sliced by
     ``pipeline.balance_buckets``, each rank's patients mined on the card
     and screened by ``screen_hash(..., axis_names=('data',))``: the
     all-reduced 2^20 table byte-equal to the one-process table and the
     kept rows summing to the one-process count; (e) the reference's
     convergence drill (300 steps, final MSE under 1e-3); each rank's
     peak device memory.

Every failed check raises, so the script exits non-zero.  The last three
lines of its output are the ``nvidia-smi`` line, the ``kernels`` JSON line
and the result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N_PATIENTS, AVG_EVENTS, SEED = 4985, 471, 0   # the paper's Table 1 cohort
TABLE2_PATIENTS, TABLE2_EVENTS = 35000, 318   # the paper's Table 2 cohort
THRESHOLD = 5
H_DEFAULT = 20                 # MiningConfig.n_buckets_log2
BUDGET_BYTES = 4 << 30         # budget_bytes of the chunked/files/fused runs
SMALL_BUDGET_BYTES = 512 << 20  # ... of a second chunked run (many small chunks)
CHECK_BUDGET_BYTES = 32 << 20  # ... of the card-vs-CPU runs (several chunks)
CHECK_DISK_BYTES = 16 << 20    # disk_bytes of the card-vs-CPU stream run
# deltas a patient in the replays of phases 5 and 8: 3 (with 8 the smoke
# read 1,002 s of its 1,200 s limit on a slow host, an H100 80GB HBM3
# machine; with 4, and phase 10 (d)-(e) added, 1,046 s)
STREAM_WAVES = 3
STREAM_CHECKPOINT_WAVE = 2     # (f): waves before its checkpoint
STREAM_BUDGET_BYTES = 1 << 30  # budget_bytes of phase 8's evicting replay
# patients of the evicting replay (the cohort's first quarter, 78 ticks a
# wave): 1 GiB of the store's cost model holds ~445 whole Table 1 histories
# (padded to 304 events, 2.4 MB each), so the replay still spills and
# restores through the host tier
STREAM_BUDGET_PATIENTS = 1248
# (e) and (f) replay the same first quarter through 4 shards (28.8 and 53.5
# + 40.6 s of journal verify at the whole cohort; cut for phase 13's room)
FUSED_PASS_LIMIT = 10**9       # the corpus-free counting pass's peak (1 GB)
# phase 5's cohort, with both budgets above sized to it so that every
# tier is still used: at 256 patients the phase's CPU side took 110-224 s
# of a smoke that read up to 1,021 s of its 1,200 s limit on a slow host
CHECK_PATIENTS = 128
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
INT_OPS_PER_S = 67e12          # H100 SXM non-tensor 32-bit rate (data sheet fp32)
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores (FFMA)
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12        # H100 SXM TF32 tensor cores, dense
# tspm_fused's operations: what the function needs, whatever a design
# spends.  Per counted pair the id (IMAD.WIDE, SHF and two LOP3: 4), the
# multiply-shift (IMAD.WIDE.U32 and three IMADs for the 64-bit product,
# SHF.R.U64, the mask's LOP3: 6) and one count (1), as the SASS of the
# kernel before the partitioned design has them (fused_kernel<false>, bit
# codec; cuobjdump -sass of its sm_90a build); per pair i < j of a row
# that repeats a code, the dedup test (the two lookback loads and tests:
# 4).  A row with no repeated code needs no dedup test, and no design
# needs a slot with j <= i or a dead i
FUSED_PAIR_OPS, FUSED_DEDUP_OPS = 11, 4
FLASH_TOL = 2e-5               # float32: atol = rtol, tests/test_kernels_flash.py
# bfloat16: 2e-5 + 2^-6 |want|.  The kernel and the plain version both
# round a float32 result to bfloat16, so they may part by one bfloat16 ulp
# (at most 2^-7 |want|) beside the float32 arithmetic's 2e-5.  That file's
# 2e-2 + 2e-2 |want| is near |want| itself at S = 8,192, where the median
# |want| is ~2e-2
BF16_REL = 2.0 ** -6
# the forward's log-sum-exp against the plain version's (float32 on every
# route): 2e-5 + 2e-5 |want|, the float32 output's limit.  The kernels'
# scores differ from the plain version's by float32 sums in another order
# (3xTF32's ~2^-22 a product on tf32x3), and exp2 / log2 by 2^-22
LSE_TOL = 2e-5
# |SDPA - the kernel| below which the library computes the same function
# (a wrong mask or scale moves o by O(1)): float32 1e-3; bfloat16 2^-4, a
# few bfloat16 ulps of |o| <= max |v| ~ 4 (SDPA rounds P to bfloat16 before
# P V, the wgmma route splits it into hi + lo)
SDPA_SAME_FUNCTION = {"float32": 1e-3, "bfloat16": 2.0 ** -4}
LM_PROMPT_LEN, LM_NEW_TOKENS, LM_REQUESTS = 896, 64, 16   # phase 9, tspm-mlho
LM_BATCH, LM_MAX_LEN = 8, 1024
GEMMA_PROMPT_LEN, GEMMA_NEW_TOKENS, GEMMA_REQUESTS = 8192, 8, 2
NEAR_TIE = 1e-4                # a greedy token may differ below this margin
# max |card - CPU| of the first wave's float32 logits (prefill and every
# decode step); set from the readings of sound runs and of the planted
# deviations of ``logit_controls``, which must each break it
LM_LOGIT_TOL = 1e-3


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def smi(fields: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def host_facts(torch) -> dict:
    """The card's driver, bus id and clocks, and the host CPU that computes
    the plain versions: what tells two machines apart when a reading differs
    between them."""
    cpu = ""
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next((ln.split(":", 1)[1].strip() for ln in f
                        if ln.startswith("model name")), "")
    except OSError:
        pass
    return {"gpu": smi("driver_version,pci.bus_id,clocks.max.sm,temperature.gpu"),
            "sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "cpu": cpu, "cpu_count": os.cpu_count(), "threads": torch.get_num_threads(),
            "cpu_capability": torch.backends.cpu.get_cpu_capability()}


def in_turns(torch, calls: dict, iters: int = 10) -> dict:
    """CUDA-event ms of each call, timed a, b, b, a (both readings)."""
    order = list(calls) + list(reversed(list(calls)))
    out = {name: [] for name in calls}
    for name in order:
        out[name].append(cuda_ms(torch, calls[name], iters))
    return out


def device_intervals(trace_path: str) -> dict:
    """Device activity of a Chrome trace: (start, end) microseconds of each
    kernel, memcpy and memset, by category, plus kernel time by name."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans, by_cat, by_kernel = [], {}, {}
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X" or cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((ts, ts + dur))
        key = e["name"] if cat == "gpu_memcpy" else cat
        by_cat[key] = by_cat.get(key, 0.0) + dur
        if cat == "kernel":
            by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + dur
    return {"spans": spans, "by_cat": by_cat, "by_kernel": by_kernel}


def kernel_device_ms(torch, fn, iters: int) -> dict:
    """Mean device milliseconds a call of ``fn`` spends in each kernel it
    launches, by the kernel's name in a ``torch.profiler`` trace (CUDA
    activity) of ``iters`` calls after a warm-up call.  Unlike CUDA events
    around the calls, this leaves out the host's time between launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        by_kernel = device_intervals(path)["by_kernel"]
    return {name: us / iters / 1e3 for name, us in by_kernel.items()}


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean milliseconds of ``fn`` on the device, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(torch, got, want) -> float:
    """0.0 when the tensors are byte-identical, else their largest
    difference (raises, since every kernel must match exactly)."""
    for g, w in zip(got, want):
        w = w.to(g.device)
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            diff = (g.double() - w.double()).abs().max().item() if g.numel() else 0.0
            raise RuntimeError(f"kernel differs from its plain version: "
                               f"{g.dtype}{tuple(g.shape)} vs "
                               f"{w.dtype}{tuple(w.shape)}, max |diff| {diff}")
    return 0.0


def pairgen_edge_cases():
    rng = np.random.default_rng(0)
    for P, E in [(0, 8), (3, 0), (2, 1), (4, 127), (4, 128), (3, 129), (2, 304)]:
        phenx = rng.integers(0, 7, (P, E)).astype(np.int32)          # duplicate codes
        date = np.sort(rng.integers(-40, 60, (P, E)), axis=1).astype(np.int32)  # ties
        nevents = rng.integers(0, E + 1, P).astype(np.int32)
        if P >= 2 and E:
            nevents[:2] = [0, 1]
        yield phenx, date, nevents
    big = rng.integers(0, 2**24 - 1, (2, 64)).astype(np.int32)       # full codec width
    yield big, np.sort(rng.integers(0, 40000, (2, 64)), axis=1).astype(np.int32), \
        np.array([64, 40], np.int32)


def random_cohort(rng, n_patients: int, max_events: int, n_codes: int,
                  date_range: int = 400):
    """(phenx, date, nevents) drawn as tests/conftest.py::random_dbmart
    draws them, so a seed gives the reference tests' cohort."""
    nevents = rng.integers(0, max_events + 1, n_patients).astype(np.int32)
    e_pad = -(-max(int(nevents.max(initial=1)), 1) // 8) * 8
    phenx = rng.integers(0, n_codes, (n_patients, e_pad)).astype(np.int32)
    date = np.sort(rng.integers(0, date_range, (n_patients, e_pad)).astype(np.int32),
                   axis=1)
    for p in range(n_patients):
        n = int(nevents[p])
        if n < e_pad:
            date[p, n:] = date[p, n - 1] if n else 0
    return phenx, date, nevents


def fused_edge_cases():
    """E on and around 128, duplicate codes, rows of 0 and 1 events, and
    the hash adversary of tests/test_kernels_fused.py (one code, H = 1/2)."""
    rng = np.random.default_rng(2)
    for P, E, V in [(5, 127, 9), (5, 128, 9), (4, 129, 9), (3, 8, 3), (64, 304, 40)]:
        phenx = rng.integers(0, V, (P, E)).astype(np.int32)
        date = np.sort(rng.integers(0, 400, (P, E)), axis=1).astype(np.int32)
        nevents = rng.integers(2, E + 1, P).astype(np.int32)
        nevents[:2] = [0, 1]
        yield phenx, date, nevents
    yield random_cohort(np.random.default_rng(31), 6, 12, 1)


def hist_edge_cases(torch, h, first, nb: int):
    """(h, mask) pairs of phase 3's histogram checks: the hashed sorted ids
    with SENTINEL rows (as the fit gives them), the same 3 elements off
    16-byte alignment, zero counted ids, every id in one bucket, and ids
    outside [0, nb) on both sides."""
    flat_h, flat_m = h.reshape(-1), first.reshape(-1)
    yield h, first
    yield flat_h[3:], flat_m[3:]
    yield h, torch.zeros_like(first)
    yield torch.full_like(h, nb - 1), first
    yield h * 3 - nb, first


def count_probe(torch, name: str, entry: str, argtypes):
    """An entry point of the ``COUNT_PROBES`` build of ``csrc/<name>.cu``
    (the counting kernels as they were before the partitioned design),
    never the library the port loads."""
    import ctypes

    from repro_torch.kernels import _build

    fn = getattr(_build.load_probe(name, "COUNT_PROBES"), entry)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def old_hist(torch, h, mask, out, shared: bool = False) -> None:
    """Adds into ``out`` with the histogram kernel before the partitioned
    design: its global-atomics kernel is the port's ``global`` route; its
    shared-table kernel (``shared``) lives only in the ``COUNT_PROBES``
    build (``seq_hist_old_shared``)."""
    import ctypes

    from repro_torch.kernels.seq_hist import ops as hist_ops

    if not shared:
        hist_ops._launch(h, mask, out, force_route="global")
        return
    fn = count_probe(torch, "seq_hist", "seq_hist_old_shared",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_void_p])
    h, mask = h.reshape(-1), mask.reshape(-1)
    rc = fn(h.data_ptr(), mask.data_ptr(), h.numel(), out.data_ptr(), out.numel(),
            torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"seq_hist_old_shared: CUDA error {rc}")


def old_fused(torch, x, nev, out, H: int) -> None:
    """Adds into ``out`` with the fused kernel before the partitioned
    design (``tspm_fused_old``: every slot of the n^2 square; global
    atomics above 2^15 buckets), launched as it was: 256 threads, as many
    blocks an SM as its shared memory allowed."""
    import ctypes

    from repro_torch.analysis import roofline
    from repro_torch.kernels import bucket_count as bc

    fn = count_probe(torch, "tspm_fused", "tspm_fused_old",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    P, E = x.shape
    shared = (1 << H) <= bc.MAX_SHARED_BUCKETS
    blocks = bc.blocks_per_sm(((1 << H) if shared else 0) * 4 + 8 * E, roofline.THREADS)
    rc = fn(x.data_ptr(), nev.data_ptr(), out.data_ptr(), P, E, 0, H, int(shared),
            roofline.THREADS, blocks, torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"tspm_fused_old: CUDA error {rc}")


def stage_ms(device_ms: dict, stages: dict) -> dict:
    """Device ms of each stage: the sum over the kernels whose name holds
    one of the stage's names (``kernel_device_ms``)."""
    return {stage: sum(ms for k, ms in device_ms.items() if any(n in k for n in names))
            for stage, names in stages.items()}


# the measurement builds of the counting kernels (the old design)
COUNT_PROBE_BUILDS = {"seq_hist": "COUNT_PROBES", "tspm_fused": "COUNT_PROBES"}
HIST_STAGES = {"a": ("hist_count_pass", "scan_offsets", "hist_stage"),
               "b": ("count_segments",)}
FUSED_STAGES = {"a": ("fused_count_pass", "scan_offsets", "fused_stage"),
                "b": ("count_segments",)}


def check_fused_kernel(torch, dev) -> tuple[float, int]:
    """Phase 3 for ``tspm_fused``: the kernel against the plain version of
    its own algorithm on the card and against the contract
    (``block_bucket_counts``, materializing) on the CPU; and the
    fused-duration route (pair generation + histogram per block)."""
    from repro_torch.core import encoding
    from repro_torch.kernels.tspm_fused import ops as fused_ops, ref as fused_ref

    err, n = 0.0, 0
    for phenx, date, nevents in fused_edge_cases():
        cpu = [torch.from_numpy(a) for a in (phenx, date, nevents)]
        x, d, nev = (a.to(dev) for a in cpu)
        pairs = fused_ops.row_pairs(nevents, phenx.shape[1])
        most = int(pairs.max(initial=0))
        for codec in encoding.CODECS:
            for H in range(1, 25):
                got = fused_ops.fused_bucket_counts(x, d, nev, codec=codec,
                                                    n_buckets_log2=H)
                want = fused_ref.fused_table_ref(x, nev, H, codec)
                err = max(err, max_abs_err(torch, [got], [want]))
                n += 1
                if H in (1, 2, 8, 12, 15, 16, 20, 24):
                    err = max(err, max_abs_err(torch, [got], [
                        fused_ref.block_bucket_counts(*cpu, codec, n_buckets_log2=H)]))
                    n += 1
                if H in (15, 16, 20, 24) and most:
                    # rounds of about one patient: several rounds, one table
                    rounds = fused_ops.fused_rounds(nevents, phenx.shape[1], most)
                    before = fused_ops.fused_bucket_counts.launches
                    got = fused_ops.fused_bucket_counts(x, d, nev, codec=codec,
                                                        n_buckets_log2=H, round_pairs=most)
                    require(fused_ops.fused_bucket_counts.launches - before == len(rounds),
                            "tspm_fused: a launch a round")
                    require(len(rounds) > 1 or np.count_nonzero(pairs) < 2,
                            "tspm_fused: one round only")
                    err = max(err, max_abs_err(torch, [got], [want]))
                    n += 1
            got = fused_ops.fused_bucket_counts(x, d, nev, codec=codec,
                                                fuse_duration=True,
                                                n_buckets_log2=12, block_patients=2)
            err = max(err, max_abs_err(torch, [got], [fused_ref.fused_bucket_counts_ref(
                *cpu, codec, True, 30, 12)]))
            n += 1
    empty = fused_ops.fused_bucket_counts(*(torch.zeros((0, 8), dtype=torch.int32,
                                                        device=dev),) * 2,
                                          torch.zeros(0, dtype=torch.int32, device=dev),
                                          n_buckets_log2=4)
    require(empty.shape == (16,) and int(empty.sum()) == 0, "empty fused table")
    return err, n


def delta_edge_cases():
    """(phenx, date, n_old, n_new, new_phenx, new_date) at the cases of
    tests/test_kernels_delta.py: P/E/D = 0, E and D at 127/128/129, rows
    with no delta, an empty delta window, a single-event history and a
    history at full plane capacity."""
    rng = np.random.default_rng(3)

    def draw(P, E, D):
        phenx = rng.integers(0, 9, (P, E)).astype(np.int32)      # duplicate codes
        date = np.sort(rng.integers(-40, 400, (P, E)), axis=1).astype(np.int32)
        new_ph = rng.integers(0, 9, (P, D)).astype(np.int32)
        new_dt = np.sort(rng.integers(400, 900, (P, D)), axis=1).astype(np.int32)
        return phenx, date, new_ph, new_dt

    for P, E, D in [(0, 8, 8), (3, 0, 4), (3, 8, 0)]:
        phenx, date, new_ph, new_dt = draw(P, E, D)
        yield phenx, date, np.zeros(P, np.int32), np.zeros(P, np.int32), new_ph, new_dt
    for P, E, D in [(3, 16, 8), (2, 127, 129), (2, 128, 128), (3, 129, 127),
                    (2, 127, 127), (2, 129, 129)]:
        phenx, date, new_ph, new_dt = draw(P, E, D)
        n_old = rng.integers(0, E + 1, P).astype(np.int32)
        n_new = rng.integers(0, D + 1, P).astype(np.int32)
        n_new[1] = 0                                            # a row with no delta
        yield phenx, date, n_old, n_new, new_ph, new_dt
    phenx, date, new_ph, new_dt = draw(4, 16, 4)
    yield phenx, date, np.full(4, 16, np.int32), np.zeros(4, np.int32), new_ph, new_dt
    phenx, date, new_ph, new_dt = draw(3, 8, 5)                  # single-event history
    yield phenx, date, np.array([1, 1, 0], np.int32), np.array([5, 1, 2], np.int32), \
        new_ph, new_dt
    phenx, date, _, _ = draw(3, 16, 4)                           # planes exactly full
    yield phenx, date, np.full(3, 12, np.int32), np.full(3, 4, np.int32), \
        phenx[:, 12:].copy(), date[:, 12:].copy()


def check_delta_kernel(torch, dev) -> tuple[float, int]:
    """Phase 3 for ``tspm_delta``: the kernel against ``delta_mine_torch``
    on the card, byte for byte, and the streaming identity: the pairs
    before a delta plus the delta slab are the full ``mine_dense``."""
    from repro_torch.core import encoding, mining
    from repro_torch.kernels.tspm_delta import ops as delta_ops
    from repro_torch.stream import delta as stream_delta

    err, n = 0.0, 0
    for case in delta_edge_cases():
        cuda = [torch.from_numpy(a).to(dev) for a in case]
        for codec in encoding.CODECS:
            for fuse in (False, True):
                got = delta_ops.delta_pairgen(*cuda, codec=codec, fuse_duration=fuse)
                want = stream_delta.delta_mine_torch(*cuda, codec, fuse, 30)
                err = max(err, max_abs_err(torch, got, want))
                n += 1
    phenx, date, nevents = random_cohort(np.random.default_rng(4), 6, 40, 9)
    n_old = (nevents * 0.4).astype(np.int32)
    n_new = nevents - n_old
    D = int(n_new.max())
    new_ph = np.zeros((6, D), np.int32)
    new_dt = np.zeros((6, D), np.int32)
    for p in range(6):
        new_ph[p, :n_new[p]] = phenx[p, n_old[p]:nevents[p]]
        new_dt[p, :n_new[p]] = date[p, n_old[p]:nevents[p]]
    x, d = torch.from_numpy(phenx).to(dev), torch.from_numpy(date).to(dev)

    def rows(mined):
        seq, dur, pat, msk = mining.flatten(mined)
        return list(zip(*(a[msk].cpu().numpy().tolist() for a in (pat, seq, dur))))

    old = rows(mining.mine(x, d, torch.from_numpy(n_old).to(dev)))
    new = rows(delta_ops.delta_pairgen(x, d, *(torch.from_numpy(a).to(dev) for a in
                                               (n_old, n_new, new_ph, new_dt))))
    full = rows(mining.mine(x, d, torch.from_numpy(nevents).to(dev)))
    require(new and sorted(old + new) == sorted(full),
            "pairs before the delta + the delta slab != the full mine_dense")
    n += 1
    return err, n


def flash_edge_cases():
    """(B, Hq, Hkv, Sq, Skv, D, options) at the kernels' edges: one-row and
    ragged tiles, Sq != Skv causal and not, every head width, GQA groups
    of 1, 2, 3 and 8, windows 1, 16 and 4,096 at S = 8,192, softcap 50, and
    rows that see no key (non-causal with a window, Sq > Skv).  Then the
    wgmma route's own edges (bfloat16 at D = 64/128/256, 128-row query
    tiles, 64- or 128-key tiles): at each of its head widths lengths that
    are no multiple of 64 or 128 and Sq != Skv causal and not; at D = 256
    GQA groups 1, 2, 4 and 8, windows 1 and 300 with softcap 50, and rows
    that see no key; D 160 (the wgmma route's three boxes, the last half
    filled) at S = 1/63/127/128/129/1,000, Sq != Skv causal and not, GQA
    groups 1, 2, 4 and 8, windows 1 and 300 with softcap 50, and rows that
    see no key.  Each case runs in float32 too: at D = 64 on the
    tf32x3 route (with a window of 300 and softcap 50 at S = 700 for it),
    at the other widths on the ffma route."""
    for S in (1, 127, 128, 129, 200):
        yield 2, 4, 2, S, S, 64, dict(causal=True)
    for Sq, Skv in ((100, 260), (260, 100)):
        for causal in (True, False):
            yield 1, 4, 4, Sq, Skv, 64, dict(causal=causal)
    for D in (32, 64, 128, 256):
        yield 1, 4, 2, 130, 130, D, dict(causal=True)
    for Hq, Hkv in ((8, 8), (8, 4), (6, 2), (8, 1)):
        yield 1, Hq, Hkv, 96, 96, 64, dict(causal=True)
    for window in (1, 16, 4096):
        yield 1, 2, 1, 8192, 8192, 64, dict(causal=True, window=window)
    yield 1, 4, 2, 200, 200, 128, dict(causal=True, softcap=50.0)
    yield 1, 4, 2, 300, 300, 256, dict(causal=True, window=64, softcap=50.0)
    yield 1, 4, 2, 96, 40, 64, dict(causal=False, window=16)
    yield 1, 4, 2, 700, 700, 64, dict(causal=True, window=300, softcap=50.0)
    for D in (64, 128, 256):
        for S in (1, 63, 129, 1000):
            yield 1, 4, 2, S, S, D, dict(causal=True)
        for Sq, Skv in ((63, 1000), (1000, 129)):
            for causal in (True, False):
                yield 1, 4, 2, Sq, Skv, D, dict(causal=causal)
    for Hkv in (8, 4, 2, 1):
        yield 1, 8, Hkv, 200, 200, 256, dict(causal=True)
    for window in (1, 300):
        yield 1, 4, 2, 700, 700, 256, dict(causal=True, window=window, softcap=50.0)
    yield 1, 4, 2, 96, 40, 256, dict(causal=False, window=16)
    # D 160 (zamba2-2.7b's shared attention): three 64-column boxes on
    # wgmma, the third half filled (bfloat16); ffma (float32)
    for S in (1, 63, 127, 128, 129, 1000):
        yield 1, 4, 2, S, S, 160, dict(causal=True)
    for Sq, Skv in ((63, 1000), (1000, 129)):
        for causal in (True, False):
            yield 1, 4, 2, Sq, Skv, 160, dict(causal=causal)
    for Hkv in (8, 4, 2, 1):
        yield 1, 8, Hkv, 200, 200, 160, dict(causal=True)
    for window in (1, 300):
        yield 1, 4, 2, 700, 700, 160, dict(causal=True, window=window, softcap=50.0)
    yield 1, 4, 2, 96, 40, 160, dict(causal=False, window=16)


def flash_limit(want, dtype: str):
    """The elementwise limit on |got - want| (see ``BF16_REL``)."""
    return FLASH_TOL + (FLASH_TOL if dtype == "float32" else BF16_REL) * want.abs()


def flash_err(torch, got, want, dtype: str) -> float:
    """Largest |got - want|; raises unless every element is within
    ``flash_limit``."""
    g, w = got.float(), want.float()
    bad = ((g - w).abs() > flash_limit(w, dtype)).sum().item()
    err = (g - w).abs().max().item() if g.numel() else 0.0
    if g.shape != w.shape or got.dtype != want.dtype or bad:
        raise RuntimeError(f"flash_attention differs from attention_ref: {got.dtype}"
                           f"{tuple(got.shape)} vs {want.dtype}{tuple(want.shape)}, "
                           f"{bad} elements beyond the limit, max |diff| {err}")
    return err


def bf16_reading(torch, got, want, case: str) -> dict:
    """The scale of a bfloat16 comparison (median and max |want|) beside
    its max |diff|, and a planted fault held to the same limit: the output
    of a kernel whose bfloat16 pair unpack swapped the two halves of each
    32-bit word of v (o's columns 2i and 2i+1 trade places).  The fault
    must break the limit; ``old_limit_bad`` counts the elements it breaks
    under tests/test_kernels_flash.py's 2e-2 + 2e-2 |want|."""
    g, w = got.float(), want.float()
    fault = g.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)
    fdiff = (fault - w).abs()
    a = w.abs()
    r = {"case": case, "median_want": a.median().item(), "max_want": a.max().item(),
         "max_diff": (g - w).abs().max().item(), "fault_max_diff": fdiff.max().item(),
         "fault_bad": (fdiff > flash_limit(w, "bfloat16")).sum().item(),
         "old_limit_bad": (fdiff > 2e-2 + 2e-2 * a).sum().item()}
    require(r["fault_bad"] > 0, f"bfloat16 limit passes a swapped-halves fault: {r}")
    return r


def lse_err(torch, got, want, case: str) -> float:
    """Largest |got - want| of a log-sum-exp over the rows that see a key;
    raises unless those are within ``LSE_TOL`` + ``LSE_TOL`` |want| and the
    others are +inf in both."""
    seen = torch.isfinite(want)
    diff = (got[seen] - want[seen]).abs()
    bad = (diff > LSE_TOL + LSE_TOL * want[seen].abs()).sum().item()
    require(got.dtype == torch.float32 and got.shape == want.shape and not bad
            and bool((got[~seen] == torch.inf).all()),
            f"{case}: the log-sum-exp differs from the plain version's ({bad} beyond the "
            f"limit, max |diff| {diff.max().item() if diff.numel() else 0.0})")
    return diff.max().item() if diff.numel() else 0.0


def check_flash_kernel(torch, dev) -> tuple[dict, int, list, dict]:
    """Phase 3 for ``flash_attention``: the kernels against
    ``attention_ref`` on the card at every edge case within ``flash_limit``,
    each case through the route ``ops.route`` names for it (at D 160 the
    last 32 columns also held on their own), with each
    bfloat16 case's reading (``bf16_reading``); each case once more with
    the log-sum-exp, whose ``o`` must be the same bytes and whose lse must
    be the plain version's within ``LSE_TOL`` (``lse_err``), and a third
    time without it, bit for bit the first; an empty batch launches
    nothing.  Returns the largest differences, the comparisons, the
    readings and the comparisons by route."""
    from repro_torch.kernels.flash_attention import ops as flash_ops, ref as flash_ref

    err, n, readings = {"float32": 0.0, "bfloat16": 0.0}, 0, []
    gen = torch.Generator(dev).manual_seed(0)
    routes = {}
    for B, Hq, Hkv, Sq, Skv, D, kw in flash_edge_cases():
        for dtype in err:
            q, k, v = (torch.randn(B, H, S, D, generator=gen, device=dev)
                       .to(getattr(torch, dtype)) for H, S in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv)))
            route = flash_ops.route(q.dtype, D)
            before = flash_ops.attention.route_launches[route]
            got = flash_ops.attention(q, k, v, **kw)
            require(flash_ops.attention.route_launches[route] == before + 1,
                    f"{dtype} D={D} did not launch the {route} route")
            o_lse, lse = flash_ops.attention(q, k, v, return_lse=True, **kw)
            require(flash_ops.attention.route_launches[route] == before + 2,
                    f"{dtype} D={D} with its log-sum-exp did not launch the {route} route")
            require(torch.equal(flash_ops.attention(q, k, v, **kw), got),
                    f"{route} {[B, Hq, Hkv, Sq, Skv, D]} {kw}: a second launch differs")
            want, want_lse = flash_ref.attention_ref(q, k, v, return_lse=True, **kw)
            e = flash_err(torch, got, want, dtype)
            if D == 160:      # the third box's 32 columns on their own
                flash_err(torch, got[..., 128:], want[..., 128:], dtype)
                require(want[..., 128:].float().abs().max().item() > 0.1,
                        "D 160: the last 32 columns of the plain version are all but zero")
            require(torch.equal(got, o_lse),
                    f"{route} {[B, Hq, Hkv, Sq, Skv, D]} {kw}: o differs with the log-sum-exp")
            e_lse = lse_err(torch, lse, want_lse, f"{route} {[B, Hq, Hkv, Sq, Skv, D]} {kw}")
            err[dtype] = max(err[dtype], e)
            r = routes.setdefault(route, {"comparisons": 0, "max_abs_err": 0.0,
                                          "lse_max_abs_err": 0.0})
            r["comparisons"] += 1
            r["max_abs_err"] = max(r["max_abs_err"], e)
            r["lse_max_abs_err"] = max(r["lse_max_abs_err"], e_lse)
            if dtype == "bfloat16":
                readings.append(bf16_reading(
                    torch, got, want, f"{[B, Hq, Hkv, Sq, Skv, D]} {kw}"))
            n += 1
    builds = [("wgmma", "bfloat16", D) for D in flash_ops.WGMMA_HEAD_DIMS]
    builds += [("tf32x3", "float32", D) for D in flash_ops.TF32X3_HEAD_DIMS]
    builds += [("ffma", "float32", D) for D in flash_ops.HEAD_DIMS]
    builds += [("ffma", "bfloat16", D) for D in (16, 32)]
    info = {f"{r} {dt} D={D}": flash_ops.kernel_info(getattr(torch, dt), D, r)
            for r, dt, D in builds}
    print(f"phase 3b flash_attention builds: {json.dumps(info)}", flush=True)
    require(all(i["local_bytes"] == 0 for b, i in info.items()
                if not b.startswith("ffma") or b.endswith("D=160")),
            f"a tensor-core or D 160 flash_attention build spills: {info}")
    empty = torch.zeros(0, 4, 8, 64, device=dev)
    before = flash_ops.attention.launches
    require(flash_ops.attention(empty, empty, empty).shape == empty.shape
            and flash_ops.attention.launches == before, "empty attention launched")
    require(set(routes) == set(flash_ops.ROUTES), f"the edge cases miss a route: {routes}")
    return err, n, readings, routes


def check_kernels(torch, dev) -> dict:
    """Phase 3: every kernel against its plain version on the card."""
    from repro_torch.core import encoding, sparsity
    from repro_torch.kernels.seq_hist import ops as hist_ops, ref as hist_ref
    from repro_torch.kernels.tspm_pairgen import ops as pg_ops, ref as pg_ref

    err = {"tspm_pairgen": 0.0, "seq_hist": 0.0}
    n = 0
    for phenx, date, nevents in pairgen_edge_cases():
        cpu = [torch.from_numpy(a) for a in (phenx, date, nevents)]
        for codec in encoding.CODECS:
            for fuse in (False, True):
                got = pg_ops.pairgen(*(a.to(dev) for a in cpu), codec=codec,
                                     fuse_duration=fuse, bucket_days=30)
                want = pg_ref.pairgen_ref(*(a.to(dev) for a in cpu), codec, fuse, 30)
                err["tspm_pairgen"] = max(err["tspm_pairgen"],
                                          max_abs_err(torch, got, want))
                n += 1
    rng = np.random.default_rng(1)
    for H in range(1, 25):                 # 15 and 16: the one-partition edge
        ids = rng.integers(-2**62, 2**62, (64, 1000), dtype=np.int64)
        ids[:, ::9] = ids[:, :1]                 # repeats inside each row
        ids[:, -50:] = encoding.SENTINEL
        mask = torch.from_numpy(rng.random(ids.shape) < 0.8).to(dev)
        seq = torch.from_numpy(ids).to(dev)
        srt = torch.sort(torch.where(mask, seq, encoding.SENTINEL), dim=1).values
        h, first = sparsity.hash_bucket(srt, H), sparsity.row_first_flags(srt)
        nb = 1 << H
        routes = ("shared",) if nb <= 1 << 15 else ("global", "partitioned")
        for hh, ff in hist_edge_cases(torch, h, first, nb):
            want = hist_ref.hist_ref(hh, ff, nb)
            got = hist_ops.hist(hh, ff, nb)
            err["seq_hist"] = max(err["seq_hist"], max_abs_err(torch, [got], [want]))
            for r in routes:                     # each route alone, as timed
                got = torch.zeros_like(want)
                hist_ops._launch(hh, ff, got, force_route=r)
                err["seq_hist"] = max(err["seq_hist"], max_abs_err(torch, [got], [want]))
            n += 1 + len(routes)
        if H in (1, 12, 14, 15, 16, 20, 24):
            cpu_counts = sparsity.local_bucket_counts(seq.cpu(), mask.cpu(), H)
            err["seq_hist"] = max(err["seq_hist"], max_abs_err(
                torch, [sparsity.local_bucket_counts(seq, mask, H)], [cpu_counts]))
            n += 1
    empty = hist_ops.hist(torch.zeros(0, dtype=torch.int32, device=dev),
                          torch.zeros(0, dtype=torch.bool, device=dev), 16)
    require(empty.shape == (16,) and int(empty.sum()) == 0, "empty histogram")
    err["tspm_fused"], n_fused = check_fused_kernel(torch, dev)
    n += n_fused
    err["tspm_delta"], n_delta = check_delta_kernel(torch, dev)
    n += n_delta
    torch.cuda.synchronize()
    print(f"phase 3: {n} kernel comparisons byte-identical", flush=True)
    return err


def make_raw_cohort(n_patients: int = N_PATIENTS, avg_events: int = AVG_EVENTS,
                    seed: int = SEED):
    """The comparison protocol's dbmart: benchmark rows, string-coded like
    the paper's, before the first-occurrence filter."""
    from repro_torch.data import dbmart, synthea

    pid, date, xid, _ = synthea.generate_benchmark_rows(n_patients, avg_events, seed)
    return dbmart.from_rows(pid.tolist(), date.tolist(), [f"phx{v}" for v in xid.tolist()])


def make_cohort(n_patients: int = N_PATIENTS, avg_events: int = AVG_EVENTS,
                seed: int = SEED, raw=None):
    """The comparison protocol's cohort: ``make_raw_cohort`` (or ``raw``),
    then the first-occurrence filter."""
    from repro_torch.data import dbmart

    return dbmart.first_occurrence_filter(
        raw if raw is not None else make_raw_cohort(n_patients, avg_events, seed))


def distinct_pairs(seq: np.ndarray, patient: np.ndarray) -> int:
    """Distinct (id, patient) pairs of a canonical (id, patient)-sorted corpus."""
    if not len(seq):
        return 0
    return int(1 + np.count_nonzero((seq[1:] != seq[:-1]) | (patient[1:] != patient[:-1])))


def launch_counters() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.seq_hist import ops as hist_ops
    from repro_torch.kernels.tspm_delta import ops as delta_ops
    from repro_torch.kernels.tspm_fused import ops as fused_ops
    from repro_torch.kernels.tspm_pairgen import ops as pg_ops

    return {"tspm_pairgen": pg_ops.pairgen, "seq_hist": hist_ops.hist,
            "tspm_fused": fused_ops.fused_bucket_counts,
            "tspm_delta": delta_ops.delta_pairgen,
            "flash_attention": flash_ops.attention,
            "flash_attention_bwd": flash_ops.attention_bwd}


# kernels that count launches by route
ROUTED = ("seq_hist", "flash_attention", "flash_attention_bwd")


def zero_launches() -> None:
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    for name in ROUTED:
        routes = counters[name].route_launches
        for r in routes:
            routes[r] = 0


def read_launches() -> dict:
    """Each kernel's launches, and those of ``ROUTED`` by route
    (``seq_hist.partitioned``, ``flash_attention.wgmma``,
    ``flash_attention_bwd.wgmma``, ...)."""
    counters = launch_counters()
    out = {name: fn.launches for name, fn in counters.items()}
    for name in ROUTED:
        out.update({f"{name}.{r}": n for r, n in counters[name].route_launches.items()})
    return out


def fit_engine(torch, db, device, **config) -> dict:
    """One ``MiningSession.fit`` with the launch counts zeroed just before
    and read just after, its host wall (ended by a synchronize) and the
    peak device memory of the fit."""
    from repro_torch.api import MiningConfig, MiningSession

    session = MiningSession(MiningConfig(**config), device=device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    frame = session.fit(db)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    return dict(session=session, frame=frame, plan=session.plan(),
                launches=read_launches(), fit_s=fit_s,
                peak_device_bytes=torch.cuda.max_memory_allocated())


def engine_rows(frame):
    """The frame's rows in the order the engine produced them, before the
    canonical host sort (which this must not trigger)."""
    raw = frame._corpus._raw
    require(raw is not None, "frame was canonicalized before its rows were read")
    return raw


def run_main_path(torch, db, screen: str, device) -> dict:
    """Phase 4: one fit through the entry points, counts zeroed before and
    read after; returns the frame, its screened keep mask and times."""
    r = fit_engine(torch, db, device, threshold=THRESHOLD, screen=screen)
    frame = r["frame"]
    t1 = time.perf_counter()
    seq, dur, patient, _ = frame.arrays()          # canonical order
    t2 = time.perf_counter()
    result = frame.screen().collect()
    t3 = time.perf_counter()
    return dict(session=r["session"], frame=frame, seq=seq, dur=dur, patient=patient,
                result=result, keep=frame.screen().keep_mask(), launches=r["launches"],
                peak_device_bytes=r["peak_device_bytes"], fit_s=r["fit_s"],
                canonicalize_s=t2 - t1, screen_collect_s=t3 - t2)


def check_main_path(torch, db, device) -> tuple[dict, object]:
    """Phase 4; returns its readings and the ``screen='hash'`` session,
    whose frame phase 4c serves (its canonical sort already paid)."""
    from repro_torch.core import mining

    n_seq = int(mining.count_sequences(db.nevents))
    out = {}
    runs = {}
    for screen in ("hash", "sorted"):
        r = run_main_path(torch, db, screen, device)
        runs[screen] = r
        require(r["launches"]["tspm_pairgen"] > 0, f"{screen}: pairgen never launched")
        if screen == "hash":
            require(r["launches"]["seq_hist"] > 0, "hash: seq_hist never launched")
            require(r["launches"]["seq_hist.partitioned"] == r["launches"]["seq_hist"],
                    "hash: a fit block of 2^26 ids left the partitioned route")
        require(len(r["seq"]) == n_seq,
                f"{screen}: {len(r['seq'])} rows != count_sequences {n_seq}")
        sup = r["result"].support
        require(len(r["result"].seq) == len(sup) and (sup >= 1).all(),
                f"{screen}: support column")
        if screen == "sorted":
            require((sup >= THRESHOLD).all(), "sorted: kept support below threshold")
        out[screen] = {k: r[k] for k in ("launches", "peak_device_bytes", "fit_s",
                                         "canonicalize_s", "screen_collect_s")}
        out[screen]["kept_rows"] = int(len(r["result"].seq))
        print(f"phase 4 ({screen}): {json.dumps(out[screen])}", flush=True)
    h, s = runs["hash"], runs["sorted"]
    counts = h["frame"]._corpus.counts()
    pairs = distinct_pairs(h["seq"], h["patient"])
    require(int(counts.astype(np.int64).sum()) == pairs,
            f"hash table sums to {int(counts.sum())}, not the {pairs} distinct pairs")
    for name in ("seq", "dur", "patient"):
        require(np.array_equal(h[name], s[name]), f"canonical {name} differs by screen")
    require(not (s["keep"] & ~h["keep"]).any(), "exact kept set not inside hash kept set")
    out.update(rows=n_seq, distinct_pairs=pairs,
               patients=db.n_patients, max_events=db.max_events)
    return out, h["session"]


SERVE_BATCH = 32        # QueryServer batch_size of phases 4c and 5
SERVE_DISTINCT = 24     # distinct plans of the serving mix (phase 5)
# phase 4c draws from a sixth as many: each distinct plan's frame-chain
# oracle takes ~2.8 s at Table 1 on the host (H100 80GB HBM3 machine, 8
# cores); 24 of them pushed the smoke past 900 s, and 12 left too little
# room for phase 10 (d)-(e) under the 1,200 s limit on a slow host; 4 (11.97 s
# of oracle) left too little for phase 13
STATIC_SERVE_DISTINCT = 2
SERVE_QUERIES = 2048    # queries drawn from them with zipf weights (phase 4c)
SERVE_CLIENTS = 32      # client threads of phase 4c
SERVE_SEED = 7


def serving_mix(codes, n_distinct: int = SERVE_DISTINCT, n_queries: int = SERVE_QUERIES,
                seed: int = SERVE_SEED):
    """The reference's serving mix (``benchmarks/serving_latency.py``): a
    pool of distinct plans over the cohort's codes —
    ``screen().starts_with``, ``.ends_with``, ``.min_duration`` and
    ``.starts_with().top_k`` in turn — and a stream of queries drawn from
    it with zipf weights."""
    from repro_torch.serving.tspm import plan

    rng = np.random.default_rng(seed)
    pool = []
    while len(pool) < n_distinct:
        kind = len(pool) % 4
        c = int(rng.choice(codes))
        if kind == 0:
            pool.append(plan().screen().starts_with(c))
        elif kind == 1:
            pool.append(plan().screen().ends_with(c))
        elif kind == 2:
            pool.append(plan().screen().min_duration(int(rng.integers(1, 120))))
        else:
            pool.append(plan().screen().starts_with(c).top_k(int(rng.integers(1, 16))))
    weights = 1.0 / np.arange(1, len(pool) + 1)
    stream = [pool[i] for i in rng.choice(len(pool), size=n_queries,
                                          p=weights / weights.sum())]
    return pool, stream


def drive_clients(server, stream, n_clients: int = SERVE_CLIENTS):
    """``n_clients`` threads, each submitting its strided share of
    ``stream`` to the running server and waiting for each result; returns
    the submit-to-result latencies, the wall and the (plan, result) pairs."""
    import threading

    lats, results, errors = [], [], []
    lock = threading.Lock()
    barrier = threading.Barrier(n_clients + 1)

    def client(chunk):
        barrier.wait()
        mine = []
        try:
            for p in chunk:
                t0 = time.perf_counter()
                r = server.submit(p).result(timeout=900)
                mine.append((time.perf_counter() - t0, p, r))
        except BaseException as ex:          # surfaced below, on the main thread
            errors.append(ex)
        with lock:
            lats.extend(m[0] for m in mine)
            results.extend(m[1:] for m in mine)

    threads = [threading.Thread(target=client, args=(stream[i::n_clients],))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    require(not errors, f"a serving client failed: {errors[:1]}")
    return lats, wall, results


def percentile_ms(lats, q: float) -> float:
    lat = np.sort(np.asarray(lats))
    return float(lat[int(q * (len(lat) - 1))]) * 1e3


def frame_chain_masks(frame, plans) -> dict:
    """Each plan's keep mask by the frame chain (``QueryPlan.apply``: the
    plan's ops applied to ``frame`` in order), keyed by the resolved ops,
    with the frame of each shared op prefix built once, so chains share
    their forced prefixes."""
    frames = {(): frame}
    for p in plans:
        ops = p.resolve(THRESHOLD).ops
        for i in range(1, len(ops) + 1):
            if ops[:i] not in frames:
                kind, arg = ops[i - 1]
                frames[ops[:i]] = getattr(frames[ops[:i - 1]], kind)(arg)
    return {p.resolve(THRESHOLD).ops: frames[p.resolve(THRESHOLD).ops].keep_mask()
            for p in plans}


def same_mask(got, want) -> bool:
    return got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)


def check_static_serving(torch, session, db, device) -> dict:
    """Phase 4c: phase 4's ``screen='hash'`` session serves its Table 1
    frame (its canonical sort already paid) through
    ``session.serve(batch_size=32)``: the serving mix's 2,048 queries (over
    ``STATIC_SERVE_DISTINCT`` distinct plans) from 32 client threads
    against ``server.start()``; each distinct plan's
    keep mask must equal the frame chain's, evaluated once a plan (and
    timed); the predicate op is timed alone at one dispatch of 32
    descriptors; dropping the server must give back every byte of device
    memory it took."""
    import gc

    def serve() -> dict:
        from repro_torch.serving.tspm import server as server_mod

        frame = session.last_frame
        server = session.serve(batch_size=SERVE_BATCH)
        view = server.view()
        require(view.frame is frame, "4c: the server does not serve the fitted frame")
        t0 = time.perf_counter()
        cols = view.columns()
        torch.cuda.synchronize()
        out = {"rows": view.n_rows, "npad": int(cols.start.shape[0]),
               "column_build_s": time.perf_counter() - t0,
               "column_bytes": sum(getattr(cols, f).nbytes
                                   for f in ("start", "end", "dur", "screen", "valid"))}
        require(cols.start.device == device and cols.n_rows == len(frame),
                "4c: columns not on the card or not the frame's rows")
        pool, stream = serving_mix(np.unique(db.phenx[db.phenx >= 0]),
                                   n_distinct=STATIC_SERVE_DISTINCT)
        frame._corpus._prefix_cache.clear()
        server.start()
        lats, wall, results = drive_clients(server, stream)
        server.stop()
        st = server.stats()
        out.update(queries=st["queries"], waves=st["waves"],
                   cache_hit_ratio=st["cache_hit_ratio"], wall_s=wall,
                   p50_ms=percentile_ms(lats, 0.50), p99_ms=percentile_ms(lats, 0.99),
                   distinct_plans=len(pool),
                   predicate_rows=len(view.pred_cache))
        require(st["queries"] == len(stream), "4c: queries went missing")
        descs = sorted({d for p in pool for d in p.resolve(THRESHOLD).split_canonical()[0]})
        codes = np.zeros(SERVE_BATCH, np.int32)
        args = np.zeros(SERVE_BATCH, np.int32)
        for i, (kind, arg) in enumerate(descs[:SERVE_BATCH]):
            codes[i], args[i] = server_mod._OP_CODE[kind], arg
        codes_d, args_d = torch.from_numpy(codes).to(device), torch.from_numpy(args).to(device)
        out["predicate_op_ms"] = cuda_ms(torch, lambda: server_mod._pred_kernel(
            cols.start, cols.end, cols.dur, cols.screen, codes_d, args_d), 5)
        out["predicate_op_descriptors"] = min(len(descs), SERVE_BATCH)
        out["allocated_while_serving"] = torch.cuda.memory_allocated()
        served: dict = {}
        for p, r in results:
            served.setdefault(p.ops, {})[id(r.keep)] = r.keep
        del results
        oracle_s = []
        for p in pool:
            masks = served.get(p.ops, {})
            r = server.query(p)
            masks[id(r.keep)] = r.keep
            frame._corpus._prefix_cache.clear()
            t0 = time.perf_counter()
            want = p.resolve(THRESHOLD).apply(frame).keep_mask()
            oracle_s.append(time.perf_counter() - t0)
            for keep in masks.values():
                require(same_mask(keep, want), f"4c: served mask of {p} != the frame chain's")
        frame._corpus._prefix_cache.clear()
        out.update(oracle_median_s=float(np.median(oracle_s)),
                   oracle_total_s=float(np.sum(oracle_s)),
                   checked_masks=sum(len(m) for m in served.values()) + len(pool))
        return out

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = serve()
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out.update(allocated_before=before, allocated_after=torch.cuda.memory_allocated(),
               phase_s=time.perf_counter() - t0)
    require(out["allocated_after"] == before,
            f"4c: {out['allocated_after'] - before} B stay allocated after the server went")
    print(f"phase 4c (static serving at Table 1): {json.dumps(out)}", flush=True)
    return out


def check_card_vs_cpu(torch, db, device) -> dict:
    """Phase 5: the session on the card equals the session on the CPU, for
    every engine under every screen."""
    from repro_torch.api import MiningConfig, MiningSession

    small = db.slice_patients(0, CHECK_PATIENTS)
    rows = {}
    for engine in ("batch", "chunked", "files"):
        for screen in ("sorted", "hash", "fused"):
            cfg = MiningConfig(engine=engine, screen=screen, threshold=THRESHOLD,
                               budget_bytes=CHECK_BUDGET_BYTES)
            frames = [MiningSession(cfg, device=d).fit(small) for d in (device, "cpu")]
            for f in (lambda fr: fr.collect(), lambda fr: fr.screen().collect()):
                got, want = f(frames[0]), f(frames[1])
                for g, w in zip(got, want):
                    require(g.dtype == w.dtype and g.tobytes() == w.tobytes(),
                            f"{engine}/{screen}: card and CPU frames differ")
            rows[f"{engine}/{screen}"] = len(frames[0])
    rows["stream/hash"] = check_stream_card_vs_cpu(small, device)
    rows["sharded/hash"] = check_sharded_card_vs_cpu(small, device)
    live = check_live_serving_card_vs_cpu(small, device)
    print(f"phase 5: card == CPU on {CHECK_PATIENTS} patients, every engine and "
          f"screen ({json.dumps(rows)})", flush=True)
    print(f"phase 5 (live serving, card == CPU): {json.dumps(live)}", flush=True)
    return {"patients": CHECK_PATIENTS, "rows": rows, "live_serving": live}


def check_live_serving_card_vs_cpu(db, device) -> dict:
    """Phase 5 live serving: an 8-wave replay of the 128 patients on a
    stream session with ``screen='hash'`` and a server built before the
    first submit, streaming the features of the 64 most supported ids of
    the batch frame.  After each wave the 24-plan pool is queried at once
    (``query_batch``), then submitted again through the background loop
    while the next wave ticks.  Every result's keep mask must equal the
    frame chain on the view it ran against; the card's and the CPU's
    ``query_batch`` results (view tick and keep bytes a plan) and
    ``features()`` must be identical.  (The background results' views
    depend on thread timing, so they are held to the frame chain only.)"""
    import gc

    import torch

    from repro_torch.api import MiningConfig, MiningSession
    from repro_torch.launch import stream as launch_stream

    cfg = MiningConfig(screen="hash", threshold=THRESHOLD)
    ids = MiningSession(cfg, device=device).fit(db).top_k(64).unique()[0]
    pool, _ = serving_mix(np.unique(db.phenx[db.phenx >= 0]))
    runs = {}
    for d in (device, "cpu"):
        session = MiningSession(cfg, device=d)
        server = session.serve(batch_size=SERVE_BATCH, feature_ids=ids)
        publish_s = []

        def timed_publish(orig=server.replica.publish, publish_s=publish_s):
            t0 = time.perf_counter()
            view = orig()
            publish_s.append(time.perf_counter() - t0)
            return view

        server.replica.publish = timed_publish
        server.start()
        waves, background, tickets, first_s = [], [], [], []
        for _ in launch_stream.replay_waves(db, session, STREAM_WAVES):
            session.run()            # the wave's ticks; last wave's tickets race them
            background += [(t.plan, t.result(timeout=600)) for t in tickets]
            t0 = time.perf_counter()
            res = server.query_batch(pool)
            first_s.append(time.perf_counter() - t0)
            require(len({id(r.view) for r in res}) == 1, "live: one wave, several views")
            waves.append({"tick": res[0].view.tick, "view": res[0].view,
                          "keep": [r.keep for r in res], "features": server.features()})
            tickets = [server.submit(p) for p in pool]
        background += [(t.plan, t.result(timeout=600)) for t in tickets]
        server.stop()
        # every result against the frame chain on its own view, one chain
        # evaluation of the pool a view
        got: dict = {}
        for w in waves:
            got.setdefault(id(w["view"]), (w["view"], []))[1].extend(zip(pool, w["keep"]))
        for p, r in background:
            got.setdefault(id(r.view), (r.view, []))[1].append((p, r.keep))
        checked = 0
        for view, results in got.values():
            want = frame_chain_masks(view.frame, pool)
            for p, keep in results:
                require(same_mask(keep, want[p.resolve(THRESHOLD).ops]),
                        f"live ({d}): {p} != the frame chain on its view (tick {view.tick})")
                checked += 1
        require(server.replica.published == session.service.n_ticks + 1,
                f"live ({d}): {server.replica.published} publications for "
                f"{session.service.n_ticks} ticks")
        runs[str(d)] = {"waves": waves, "checked": checked,
                        "publications": server.replica.published,
                        "publish_s": publish_s, "first_query_s": first_s,
                        "background_views": sorted({r.view.tick for _, r in background})}
        del server, session, got, background
        gc.collect()     # the timed publish hook closes a reference cycle
    card, cpu = runs[str(device)], runs["cpu"]
    for a, b in zip(card["waves"], cpu["waves"]):
        require(a["tick"] == b["tick"], "live: card and CPU views differ in tick")
        for p, x, y in zip(pool, a["keep"], b["keep"]):
            require(x.tobytes() == y.tobytes(), f"live: card and CPU masks of {p} differ")
        for x, y in zip(a["features"], b["features"]):      # CPU tensors
            require(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y),
                    "live: card and CPU features() differ")
    pub = np.asarray(card["publish_s"])
    return {"patients": db.n_patients, "ticks": card["waves"][-1]["tick"],
            "rows": card["waves"][-1]["view"].n_rows,
            "publications": card["publications"],
            "publish_s": {"median": float(np.median(pub)), "max": float(pub.max()),
                          "total": float(pub.sum())},
            "first_query_s": card["first_query_s"],
            "cpu_first_query_s": cpu["first_query_s"],
            "checked_masks": {"card": card["checked"], "cpu": cpu["checked"]},
            "background_view_ticks": card["background_views"]}


def check_stream_card_vs_cpu(db, device) -> dict:
    """Phase 5 for the stream engine: a 3-wave replay through
    ``session.submit``/``run`` under a budget that evicts, with the disk
    tier on (its codec and blockstore under the card's store); the card
    and the CPU give the same rows, table and tier placement."""
    import tempfile

    from repro_torch.api import MiningConfig, MiningSession

    with tempfile.TemporaryDirectory(prefix="tspm_disk_") as tmp:
        sessions = []
        for d in (device, "cpu"):
            cfg = MiningConfig(screen="hash", threshold=THRESHOLD,
                               budget_bytes=CHECK_BUDGET_BYTES,
                               disk_bytes=CHECK_DISK_BYTES,
                               disk_dir=os.path.join(tmp, str(d).replace(":", "")))
            session = MiningSession(cfg, device=d)
            replay_waves(db, session, 3)
            sessions.append(session)
        (card, cpu), tiers = sessions, []
        for f in (lambda fr: engine_rows(fr), lambda fr: fr.screen().collect()):
            for g, w in zip(f(card.frame()), f(cpu.frame())):
                require(g.dtype == w.dtype and g.tobytes() == w.tobytes(),
                        "stream: card and CPU frames differ")
        require(np.array_equal(card.frame()._corpus.counts(), cpu.frame()._corpus.counts()),
                "stream: card and CPU tables differ")
        for session in sessions:
            store = session.service.store
            tiers.append({k: store.tier_of(k) for k in store.pids})
        require(tiers[0] == tiers[1], "stream: card and CPU tier placement differ")
        placed = {t: list(tiers[0].values()).count(t) for t in ("device", "host", "disk")}
        require(placed["host"] and placed["disk"], f"stream: tiers not all used {placed}")
        return {"rows": len(card.frame()), "placement": placed}


def check_sharded_card_vs_cpu(db, device) -> dict:
    """Phase 5 for the sharded engine: a 3-wave replay through 3 shards
    (balanced router, rebalancing every 2 ticks) under a budget that evicts
    through the host and disk tiers, with 8 migrations after wave 2 (the
    first of them a spilled patient); the card and the CPU give the same
    rows, merged table, tier of every key and router pins."""
    from repro_torch.api import MiningConfig, MiningSession
    from repro_torch.stream.shard import ShardRouter

    moves: list = []

    def migrate_eight(session, w):
        svc = session.service
        if w != 1:
            return
        if not moves:       # chosen on the card's run, replayed on the CPU's
            spilled = [k for sh in svc.shards for k in sh.store.held_keys()]
            require(spilled, "sharded: nothing spilled by wave 2")
            resident = [k for k in sorted(svc.pids) if k not in spilled]
            for k in [spilled[0]] + resident[:7]:
                moves.append((k, (svc.router.route(k) + 1) % svc.n_shards))
        for k, dst in moves:
            svc.migrate(k, dst)

    with tempfile.TemporaryDirectory(prefix="tspm_disk_") as tmp:
        sessions = []
        for d in (device, "cpu"):
            cfg = MiningConfig(n_shards=3, router="balance", rebalance_every=2,
                               screen="hash", threshold=THRESHOLD,
                               budget_bytes=CHECK_BUDGET_BYTES,
                               disk_bytes=CHECK_DISK_BYTES,
                               disk_dir=os.path.join(tmp, str(d).replace(":", "")))
            router = ShardRouter.balanced(list(range(db.n_patients)), db.nevents, 3)
            session = MiningSession(cfg, device=d, router=router)
            replay_waves(db, session, 3, after_wave=lambda w, s=session: migrate_eight(s, w))
            sessions.append(session)
        card, cpu = sessions
        for g, w in zip(engine_rows(card.frame()), engine_rows(cpu.frame())):
            require(g.dtype == w.dtype and g.tobytes() == w.tobytes(),
                    "sharded: card and CPU rows differ")
        a, b = card.service.snapshot().counts, cpu.service.snapshot().counts
        require(a.dtype == b.dtype and a.tobytes() == b.tobytes(),
                "sharded: card and CPU merged tables differ")
        tiers = [{k: sh.store.tier_of(k) for sh in s.service.shards for k in sh.store.pids}
                 for s in sessions]
        require(tiers[0] == tiers[1], "sharded: card and CPU tier placement differ")
        require(card.service.router.pinned == cpu.service.router.pinned and
                card.service.migrations == cpu.service.migrations,
                "sharded: card and CPU router pins or migrations differ")
        require(len(card.service.migrations) >= len(moves) == 8, "sharded: 8 migrations")
        placed = {t: list(tiers[0].values()).count(t) for t in ("device", "host", "disk")}
        require(placed["host"] and placed["disk"], f"sharded: tiers not all used {placed}")
        return {"rows": len(card.frame()), "placement": placed,
                "migrations": len(card.service.migrations)}


def check_files_vs_chunked(torch, db, device) -> dict:
    """Phase 4b: the files and chunked engines at one budget visit the same
    chunks, so their rows agree in order, with the same bucket table; the
    spill goes to a temporary directory that the session removes.  The
    chunked engine at a smaller budget (more, smaller chunks) gives the
    same rows in the same order.  Every fit peaks within its budget."""
    import tempfile

    def spills():
        return {n for n in os.listdir(tempfile.gettempdir()) if n.startswith("tspm_spill_")}

    before = spills()
    runs, out = {}, {}
    for name, engine, budget in (("chunked", "chunked", BUDGET_BYTES),
                                 ("files", "files", BUDGET_BYTES),
                                 ("chunked_small", "chunked", SMALL_BUDGET_BYTES)):
        r = fit_engine(torch, db, device, engine=engine, screen="hash",
                       threshold=THRESHOLD, budget_bytes=budget)
        require(r["launches"]["tspm_pairgen"] > 0 and r["launches"]["seq_hist"] > 0,
                f"{name}: a kernel of the path never launched")
        runs[name] = r
        out[name] = {"fit_s": r["fit_s"], "launches": r["launches"],
                     "n_chunks": r["plan"].n_chunks, "rows": len(r["frame"]),
                     "peak_device_bytes": r["peak_device_bytes"], "budget_bytes": budget}
        print(f"phase 4b ({name}): {json.dumps(out[name])}", flush=True)
        require(r["peak_device_bytes"] <= budget,
                f"{name}: peak {r['peak_device_bytes']} B > budget_bytes {budget}")
    require(spills() == before, "the files engine left its spill directory behind")
    c = runs["chunked"]["frame"]
    require(runs["files"]["plan"].n_chunks > 1, "files: the budget gave one chunk")
    for other in ("files", "chunked_small"):
        f = runs[other]["frame"]
        for col, a, b in zip(("seq", "dur", "patient"), engine_rows(c), engine_rows(f)):
            require(a.dtype == b.dtype and np.array_equal(a, b),
                    f"{other} and chunked rows differ in {col}")
        require(np.array_equal(c._corpus.counts(), f._corpus.counts()),
                f"{other} and chunked bucket tables differ")
    out["budget_bytes"] = BUDGET_BYTES
    return out


def host_keep(torch, seq: np.ndarray, counts: np.ndarray, device,
              piece: int = 1 << 26) -> np.ndarray:
    """The hash screen's keep mask of host rows, computed on the card a
    piece at a time."""
    from repro_torch.core import sparsity

    keep = np.empty(len(seq), bool)
    table = torch.from_numpy(counts).to(device)
    for s in range(0, len(seq), piece):
        ids = torch.from_numpy(seq[s:s + piece]).to(device)
        keep[s:s + piece] = sparsity.screen_hash_from_counts(
            ids, torch.ones_like(ids, dtype=torch.bool), table, THRESHOLD,
            H_DEFAULT).cpu().numpy()
    return keep


def check_table2(torch, db, device) -> dict:
    """Phase 7: the paper's Table 2 cohort through the chunked hash screen
    and the corpus-free fused screen, compared row for row."""
    from repro_torch.core import mining
    from repro_torch.kernels.tspm_fused import ops as fused_ops

    n_seq = int(mining.count_sequences(db.nevents))
    out = {"patients": db.n_patients, "max_events": db.max_events, "rows": n_seq,
           "budget_bytes": BUDGET_BYTES}
    ch = fit_engine(torch, db, device, engine="chunked", screen="hash",
                    threshold=THRESHOLD, budget_bytes=BUDGET_BYTES)
    require(ch["plan"].n_chunks >= 4, f"chunked: {ch['plan'].n_chunks} chunks, not >= 4")
    require(ch["launches"]["tspm_pairgen"] > 0 and ch["launches"]["seq_hist"] > 0,
            "chunked: a kernel of the path never launched")
    c_rows = engine_rows(ch["frame"])
    require(len(c_rows[0]) == n_seq, f"chunked: {len(c_rows[0])} rows != {n_seq}")
    c_counts = ch["frame"]._corpus.counts()
    keep = host_keep(torch, c_rows[0], c_counts, device)
    out["chunked"] = {"engine": ch["plan"].engine, "n_chunks": ch["plan"].n_chunks,
                      "fit_s": ch["fit_s"], "rows": n_seq, "kept_rows": int(keep.sum()),
                      "peak_device_bytes": ch["peak_device_bytes"],
                      "launches": ch["launches"]}
    print(f"phase 7 (chunked, hash): {json.dumps(out['chunked'])}", flush=True)
    require(ch["peak_device_bytes"] <= BUDGET_BYTES,
            f"chunked: peak {ch['peak_device_bytes']} B > budget_bytes {BUDGET_BYTES}")

    fu = fit_engine(torch, db, device, screen="fused", threshold=THRESHOLD,
                    budget_bytes=BUDGET_BYTES)
    require(fu["launches"]["tspm_fused"] >= 1, "fused: tspm_fused never launched")
    require(fu["launches"]["tspm_pairgen"] > 0, "fused: the re-mine never launched")
    f_rows = engine_rows(fu["frame"])
    f_counts = fu["frame"]._corpus.counts()
    require(f_counts.dtype == c_counts.dtype and np.array_equal(f_counts, c_counts),
            "fused table != the chunked engine's merged table")
    require(len(f_rows[0]) == int(keep.sum()), "fused survivors != chunked kept rows")
    whole = bool(keep.all())
    for name, a, b in zip(("seq", "dur", "patient"), f_rows, c_rows):
        require(a.dtype == b.dtype and np.array_equal(a, b if whole else b[keep]),
                f"fused survivors differ from the chunked kept rows in {name}")
    out["fused"] = {"engine": fu["plan"].engine, "n_chunks": fu["plan"].n_chunks,
                    "fit_s": fu["fit_s"], "rows": len(f_rows[0]),
                    "kept_rows": len(f_rows[0]),
                    "peak_device_bytes": fu["peak_device_bytes"],
                    "launches": fu["launches"]}
    out["table_sum"] = int(c_counts.astype(np.int64).sum())
    print(f"phase 7 (fused): {json.dumps(out['fused'])}", flush=True)
    require(fu["peak_device_bytes"] <= BUDGET_BYTES,
            f"fused: peak {fu['peak_device_bytes']} B > budget_bytes {BUDGET_BYTES}")
    launches = fu["launches"]
    del ch, fu, c_rows, f_rows, keep

    # the corpus-free counting pass alone: the cohort and the table
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    args = [torch.from_numpy(a).to(device) for a in (db.phenx, db.date, db.nevents)]
    counts = fused_ops.fused_bucket_counts(*args, n_buckets_log2=H_DEFAULT)
    torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    require(np.array_equal(counts.cpu().numpy(), c_counts),
            "the counting pass alone gives another table")
    require(peak < FUSED_PASS_LIMIT,
            f"fused counting pass peaked at {peak} B of device memory, not < 1 GB")
    out["fused_counting_pass"] = {"seconds": pass_s, "peak_device_bytes": peak,
                                  "limit_bytes": FUSED_PASS_LIMIT}
    print(f"phase 7 (fused counting pass alone): "
          f"{json.dumps(out['fused_counting_pass'])}", flush=True)
    del args, counts
    torch.cuda.empty_cache()
    return out, launches


def replay_waves(db, session, n_waves: int, seed: int = 0, after_wave=None):
    """Submit the deltas wave after wave (wave-major, as encounters
    arrive; ``launch.stream.replay_waves`` cuts them), draining the queue
    with ``session.run()`` after each wave and then calling
    ``after_wave(w)``; returns the live frame."""
    from repro_torch.launch import stream as launch_stream

    for w in launch_stream.replay_waves(db, session, n_waves, seed):
        session.run()
        if after_wave is not None:
            after_wave(w)
    return session.frame()


def run_stream(torch, db, device, waves: int | None = None, on_session=None,
               **config):
    """One stream-engine run through the entry points (``fit``, or a wave
    replay through ``submit``/``run``) with telemetry on, the launch
    counts zeroed just before and read just after; returns the frame and
    what the run measured (``on_session`` gets the session first)."""
    from repro_torch.api import MiningConfig, MiningSession

    session = MiningSession(MiningConfig(engine="stream", threshold=THRESHOLD,
                                         telemetry=True, **config), device=device)
    if on_session is not None:
        on_session(session)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    frame = session.fit(db) if waves is None else replay_waves(db, session, waves)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    m = session.metrics()
    out = {"wall_s": wall, "ticks": m["stream.ticks"], "launches": launches,
           "dispatch_s": m["stream.tick.dispatch_s"]["sum"],
           "device_s": m["stream.tick.device_s"]["sum"],
           "collect_s": m["stream.tick.collect_s"]["sum"],
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "seqset_columns": m["sketch.set_columns"],
           "evictions": m["store.evictions"],
           "host_restores": m.get("storage.restores{tier=host}", 0),
           "jit.retraces": m["jit.retraces"], "rows": len(frame)}
    require(launches["tspm_delta"] == out["ticks"] > 0,
            f"tspm_delta launched {launches['tspm_delta']} times in {out['ticks']} ticks")
    require(launches["seq_hist"] >= out["ticks"], "the sketch fold skipped seq_hist")
    return frame, out


def card_sorted(torch, rows, device):
    """(seq, dur, patient) rows sorted on the card by (seq, patient, dur)."""
    from repro_torch.core import sparsity

    seq, dur, pat = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in rows)
    order = sparsity.stable_order(seq, pat, dur)
    return seq[order], dur[order], pat[order]


def require_same_multiset(torch, got_rows, want_sorted, device, what: str) -> None:
    got = card_sorted(torch, got_rows, device)
    require(all(torch.equal(g, w) for g, w in zip(got, want_sorted)),
            f"{what}: rows differ from the batch rows as multisets")


def check_stream(torch, db, device) -> tuple[dict, dict]:
    """Phase 8: the streaming path at Table 1 on the card — (a) the stream
    fit, (b) a ``STREAM_WAVES``-wave replay, (c) the same replay of the first
    ``STREAM_BUDGET_PATIENTS`` patients under a 1 GiB budget
    (eviction and restores through the host tier), (d) the fused screen
    on the stream engine, (e) and (f) the replay of those first patients
    through 4 shards (``check_sharded``); every check on the card, no host
    sort."""
    batch = fit_engine(torch, db, device, engine="batch", screen="hash",
                       threshold=THRESHOLD)
    b_rows, b_table = engine_rows(batch["frame"]), batch["frame"]._corpus.counts()
    del batch
    want = card_sorted(torch, b_rows, device)
    out = {}

    fa, out["a_fit"] = run_stream(torch, db, device, screen="hash")
    require(np.array_equal(fa._corpus.counts(), b_table),
            "stream sketch table != the batch engine's local_bucket_counts")
    require_same_multiset(torch, engine_rows(fa), want, device, "stream fit")
    print(f"phase 8 (a, fit): {json.dumps(out['a_fit'])}", flush=True)
    launches = out["a_fit"]["launches"]
    del fa

    fb, out["b_waves"] = run_stream(torch, db, device, waves=STREAM_WAVES, screen="hash")
    rows_b = engine_rows(fb)
    require(np.array_equal(fb._corpus.counts(), b_table), "wave replay table != batch table")
    require_same_multiset(torch, rows_b, want, device, "wave replay")
    print(f"phase 8 (b, {STREAM_WAVES} waves): {json.dumps(out['b_waves'])}", flush=True)

    # (c) on the first STREAM_BUDGET_PATIENTS patients: the same wave cuts
    # (replay_waves draws patient after patient), and each wave's ticks take
    # the queue in patient order, so its rows are (b)'s rows of those
    # patients, in (b)'s order
    n_c = STREAM_BUDGET_PATIENTS
    sub = db.slice_patients(0, n_c)
    held = []
    fc, out["c_budget"] = run_stream(torch, sub, device, waves=STREAM_WAVES, screen="hash",
                                     budget_bytes=STREAM_BUDGET_BYTES,
                                     on_session=held.append)
    out["c_budget"].update(budget_bytes=STREAM_BUDGET_BYTES, patients=n_c)
    print(f"phase 8 (c, {STREAM_WAVES} waves, {n_c} patients, budget): "
          f"{json.dumps(out['c_budget'])}", flush=True)
    mine_c = rows_b[2] < n_c
    for name, a, b in zip(("seq", "dur", "patient"), engine_rows(fc), rows_b):
        require(a.dtype == b.dtype and np.array_equal(a, b[mine_c]),
                f"evicting replay differs from the replay in {name}")
    sub_batch = fit_engine(torch, sub, device, engine="batch", screen="hash",
                           threshold=THRESHOLD)
    sub_table = sub_batch["frame"]._corpus.counts()
    sub_rows = engine_rows(sub_batch["frame"])
    require(np.array_equal(fc._corpus.counts(), sub_table),
            "evicting replay's table != the batch table of its patients")
    require(out["c_budget"]["evictions"] > 0 and out["c_budget"]["host_restores"] > 0,
            "the 1 GiB budget spilled or restored nothing")
    del fb, fc, rows_b, mine_c, sub_batch
    out["g_journal"] = check_journaled_replay(torch, sub, device, held.pop(),
                                              out["c_budget"]["wall_s"])

    fd, out["d_fused"] = run_stream(torch, db, device, screen="fused")
    keep = host_keep(torch, b_rows[0], b_table, device)
    kept = want if keep.all() else card_sorted(torch, [a[keep] for a in b_rows], device)
    require_same_multiset(torch, engine_rows(fd), kept, device, "stream fused survivors")
    require(np.array_equal(fd._corpus.counts(), b_table), "stream fused table")
    out["d_fused"]["kept_rows"] = int(keep.sum())
    print(f"phase 8 (d, fused): {json.dumps(out['d_fused'])}", flush=True)
    del fd, kept, b_rows, want
    torch.cuda.empty_cache()
    out["e_sharded"], out["f_devices_checkpoint"] = check_sharded(
        torch, sub, device, card_sorted(torch, sub_rows, device), sub_table)
    del sub_rows
    torch.cuda.empty_cache()
    return out, launches


JOURNAL_COMMIT_EVERY = 16      # journal_commit_every of phase 8 (g)
JOURNAL_UPTO_TICK = 156        # the partial replay of phase 8 (g): 2 of its 3 waves' 234 ticks


def journal_readings(jdir: str) -> dict:
    """Entries by kind, segments and bytes on disk of a journal."""
    from repro_torch.journal import read_journal
    from repro_torch.journal.entries import entry_kind

    kinds: dict = {}
    for e, _ in read_journal(jdir):
        k = entry_kind(e)
        kinds[k] = kinds.get(k, 0) + 1
    return {"entries": kinds,
            "disk_bytes": sum(f.stat().st_size for f in Path(jdir).iterdir())}


def commit_span_s(session) -> float:
    return float(sum(sp.duration_s for sp in session.trace().spans
                     if sp.name == "journal.commit" and sp.t1 is not None))


def forge_torn_segment(src: str, dst: str) -> str:
    """A copy of a journal with one byte flipped in the middle of its
    middle segment's blob in ``blocks.dat``; returns that segment's key."""
    import shutil

    shutil.copytree(src, dst)
    with open(os.path.join(dst, "index.json")) as f:
        index = json.load(f)
    segs = sorted((k[1], v) for k, v in index["entries"] if str(k[1]).startswith("jseg"))
    key, (offset, nbytes, *_rest) = segs[len(segs) // 2]
    with open(os.path.join(dst, "blocks.dat"), "r+b") as f:
        f.seek(offset + nbytes // 2)
        b = f.read(1)
        f.seek(offset + nbytes // 2)
        f.write(bytes([b[0] ^ 0x01]))
    return key


def forge_delta(src: str, dst: str, tick_keys: list) -> tuple[int, int]:
    """A re-chained copy of a journal (``write_journal``) in which the
    first delta entry after the first commit carries other phenX codes;
    returns that entry's index and the first tick that mined the delta
    (from the live run's per-tick patient keys)."""
    from repro_torch.journal import read_journal, write_journal
    from repro_torch.journal.entries import decode_entry, encode_entry, entry_kind
    from repro_torch.storage.codec import decode_key

    raw = [e for e, _ in read_journal(src)]
    kinds = [entry_kind(e) for e in raw]
    first_commit = kinds.index("commit")
    i = next(j for j in range(first_commit, len(raw)) if kinds[j] == "delta")
    kind, fields, arrays, blobs = decode_entry(raw[i])
    raw[i] = encode_entry(kind, fields, dict(arrays, phenx=arrays["phenx"] + 1000), blobs)
    write_journal(dst, raw)
    key, done = decode_key(fields["key"]), kinds[:i].count("tick")
    tick = next(t for t, keys in tick_keys if t > done and key in keys)
    return i, tick


def check_journaled_replay(torch, db, device, plain, plain_wall: float) -> dict:
    """Phase 8 (g): (c) again (the first 1,248 patients, 3 waves, 1 GiB)
    with ``journal_dir`` set (a commit every 16 ticks).  It must end
    byte-identical to (c) (snapshot and the tier of every key); the
    journal must verify (its replay launching ``tspm_delta`` once a tick),
    ``MiningSession.replay`` on the card must reach the live
    ``state_digest`` and ``upto_tick=156`` must stop at tick 156; a flipped
    byte in a segment must give a proof naming the segment, and a
    re-chained journal with one delta's codes changed a ``Divergence`` at
    the first tick that mined that delta."""
    import gc

    from repro_torch.api import MiningSession
    from repro_torch.journal import Divergence, TornSegment
    from repro_torch.launch.stream import state_digest
    from repro_torch.stream.events import TickCompleted

    tick_keys, held = [], []

    def watch(session):
        held.append(session)
        session._ensure_service().subscribe(
            lambda ev: tick_keys.append((ev.tick, set(ev.keys))), kinds=TickCompleted)

    with tempfile.TemporaryDirectory(prefix="tspm_journal_") as root:
        jdir = os.path.join(root, "g")
        fg, out = run_stream(torch, db, device, waves=STREAM_WAVES, screen="hash",
                             budget_bytes=STREAM_BUDGET_BYTES, journal_dir=jdir,
                             journal_commit_every=JOURNAL_COMMIT_EVERY, on_session=watch)
        live = held.pop()
        a, b = live.service.snapshot(), plain.service.snapshot()
        for name in ("seq", "dur", "patient", "counts"):
            x, y = getattr(a, name), getattr(b, name)
            require(x.dtype == y.dtype and x.tobytes() == y.tobytes(),
                    f"(g): the journaled replay differs from (c) in {name}")
        tiers = [{k: s.service.store.tier_of(k) for k in s.service.store.pids}
                 for s in (live, plain)]
        require(tiers[0] == tiers[1], "(g): tier placement differs from (c)")
        del plain, fg
        m = live.metrics()
        j = live.journal()
        out.update(plain_wall_s=plain_wall, overhead=out["wall_s"] / plain_wall - 1,
                   commits=j.n_commits, commit_span_s=commit_span_s(live),
                   journal_metrics={k: m[k] for k in ("journal.entries", "journal.commits",
                                                      "journal.bytes")})
        j.flush()
        out.update(journal_readings(jdir))
        ticks = live.service.n_ticks
        require(ticks > JOURNAL_UPTO_TICK, f"(g): {ticks} ticks")

        zero_launches()
        t0 = time.perf_counter()
        res = live.verify()
        torch.cuda.synchronize()
        out["verify_s"] = time.perf_counter() - t0
        out["verify_launches"] = read_launches()
        require(res.ok, f"(g): verify failed: {res}")
        require(out["verify_launches"]["tspm_delta"] == ticks,
                f"(g): the verify's replay launched tspm_delta "
                f"{out['verify_launches']['tspm_delta']} times for {ticks} ticks")
        out["verify"] = str(res)
        gc.collect()

        t0 = time.perf_counter()
        replayed = MiningSession.replay(jdir, device=device)
        torch.cuda.synchronize()
        out["replay_s"] = time.perf_counter() - t0
        out["state_digest"] = state_digest(live.service)
        require(replayed.device == device and
                state_digest(replayed.service) == out["state_digest"],
                "(g): the replay on the card missed the live state_digest")
        del replayed
        t0 = time.perf_counter()
        part = MiningSession.replay(jdir, upto_tick=JOURNAL_UPTO_TICK, device=device)
        out["replay_upto_s"] = time.perf_counter() - t0
        require(part.service.n_ticks == JOURNAL_UPTO_TICK,
                f"(g): replay(upto_tick={JOURNAL_UPTO_TICK}) stopped at "
                f"{part.service.n_ticks}")
        del part
        gc.collect()

        seg = forge_torn_segment(jdir, os.path.join(root, "torn"))
        res = live.verify(os.path.join(root, "torn"))
        require(not res.ok and isinstance(res.proof, TornSegment) and seg in res.proof.reason,
                f"(g): a flipped byte in {seg} was not convicted by name: {res}")
        out["torn_proof"] = str(res.proof)
        index, tick = forge_delta(jdir, os.path.join(root, "forged"), tick_keys)
        t0 = time.perf_counter()
        res = live.verify(os.path.join(root, "forged"))
        out["forged_verify_s"] = time.perf_counter() - t0
        require(not res.ok and isinstance(res.proof, Divergence) and res.proof.tick == tick,
                f"(g): the forged delta (entry {index}, mined at tick {tick}) gave {res}")
        out["forged_proof"] = str(res.proof)
        del live
    gc.collect()
    print(f"phase 8 (g, (c) journaled): {json.dumps(out)}", flush=True)
    return out


SHARDS = 4                     # shards of phase 8 (e) and (f)
SHARD_MIGRATIONS = 64          # patients migrated after wave 2 in (e) and (f)


def sharded_session(device, placement: str, journal_dir: str | None = None):
    from repro_torch.api import MiningConfig, MiningSession

    return MiningSession(MiningConfig(
        n_shards=SHARDS, router="hash", rebalance_every=32, imbalance_threshold=1.05,
        placement=placement, telemetry=True, screen="hash", threshold=THRESHOLD,
        journal_dir=journal_dir), device=device)


def migrate_heaviest(db, session) -> None:
    """Phase 8 (e)/(f) after wave 2: the ``SHARD_MIGRATIONS`` patients with
    the most events, each to the next shard."""
    svc = session.service
    for p in np.argsort(-db.nevents, kind="stable")[:SHARD_MIGRATIONS]:
        svc.migrate(int(p), (svc.router.route(int(p)) + 1) % svc.n_shards)


def sharded_readings(torch, session, wall: float, launches: dict, ticks: int) -> dict:
    """What phase 8 (e)/(f) print: wall, sharded and shard ticks,
    migrations, rebalances, both load signals, peak device memory and the
    ``TickStats`` sums."""
    svc = session.service
    m = session.metrics()
    return {"wall_s": wall, "sharded_ticks": svc.n_ticks, "shard_ticks": ticks,
            "migrations": len(svc.migrations),
            "rebalances": m["shard.rebalances"], "shard_loads": svc.shard_loads(),
            "shard_load": svc.shard_load(), "launches": launches,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "dispatch_s": sum(st.dispatch_s for st in svc.stats),
            "device_s": sum(st.device_s for st in svc.stats),
            "collect_s": sum(st.collect_s for st in svc.stats),
            "migration_wall_s": svc.migration_wall_s, "admit_wall_s": svc.admit_wall_s}


def check_sharded(torch, db, device, want, b_table) -> tuple[dict, dict]:
    """Phase 8 (e): the ``STREAM_WAVES``-wave replay of ``db`` (the first
    ``STREAM_BUDGET_PATIENTS`` Table 1 patients) through 4 shards ('host'
    placement, hash router, rebalancing every 32 ticks), the 64 heaviest
    patients migrated after wave 2; its merged table must equal the batch
    table of ``db`` and its rows the batch rows as multisets.  (f): the
    same replay under 'devices' placement (every shard on the card,
    two-pass ticks, async admits), checkpointed after wave
    ``STREAM_CHECKPOINT_WAVE``, restored in this process into a new
    session, the other waves there; its snapshot, pids, pins and
    migrations must equal (e)'s byte for byte."""
    import gc

    from repro_torch.api import MiningSession
    from repro_torch.launch import stream as launch_stream

    def after(session, w):
        if w == 1:
            migrate_heaviest(db, session)

    session = sharded_session(device, "host")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    frame = replay_waves(db, session, STREAM_WAVES,
                         after_wave=lambda w: after(session, w))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    svc = session.service
    e = sharded_readings(torch, session, wall, launches, len(svc.stats))
    require(launches["tspm_delta"] == len(svc.stats) > 0,
            f"(e): tspm_delta launched {launches['tspm_delta']} times in "
            f"{len(svc.stats)} shard ticks")
    require(launches["seq_hist"] >= len(svc.stats), "(e): a shard tick skipped seq_hist")
    require(len(svc.migrations) >= SHARD_MIGRATIONS,
            f"(e): {len(svc.migrations)} migrations < {SHARD_MIGRATIONS}")
    snap = svc.snapshot()
    require(snap.counts.dtype == np.int64 and np.array_equal(snap.counts, b_table),
            "(e): the merged table != the batch engine's table")
    require_same_multiset(torch, engine_rows(frame), want, device, "(e) sharded replay")
    print(f"phase 8 (e, {SHARDS} shards, host): {json.dumps(e)}", flush=True)
    keep = {"snap": snap, "pids": dict(svc.pids), "pinned": dict(svc.router.pinned),
            "migrations": list(svc.migrations)}
    del session, svc, frame, snap
    torch.cuda.empty_cache()

    jroot = tempfile.TemporaryDirectory(prefix="tspm_journal_")
    jdir = os.path.join(jroot.name, "f")
    session = sharded_session(device, "devices", journal_dir=jdir)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tspm_ckpt_") as ckpt_dir:
        saved, ticks = {}, 0
        for w in launch_stream.replay_waves(db, session, STREAM_WAVES):
            session.run()
            after(session, w)
            if w == STREAM_CHECKPOINT_WAVE - 1:
                require(session.service.placement == "devices" and
                        session.service.async_migration, "(f): not 'devices' placement")
                t1 = time.perf_counter()
                saved["path"] = session.checkpoint(ckpt_dir, extra={"next_wave": w + 1})
                saved["save_s"] = time.perf_counter() - t1
                saved["bytes"] = sum(f.stat().st_size
                                     for f in Path(saved["path"]).iterdir())
                ticks = len(session.service.stats)
                break
        saved["commit_span_s"] = commit_span_s(session)
        session.journal().close()     # the restored session reopens the journal
        del session
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        session = MiningSession.restore(ckpt_dir, device=device)
        restore_s = time.perf_counter() - t1
        start = int(session.restore_extra["next_wave"])
        require(start == STREAM_CHECKPOINT_WAVE, f"(f): restored at wave {start}")
        for w in launch_stream.replay_waves(db, session, STREAM_WAVES, start_wave=start):
            session.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()
    svc = session.service
    f = sharded_readings(torch, session, wall, launches, ticks + len(svc.stats))
    f.update(checkpoint_bytes=saved["bytes"], save_s=saved["save_s"], restore_s=restore_s)
    require(launches["tspm_delta"] == f["shard_ticks"] > 0,
            f"(f): tspm_delta launched {launches['tspm_delta']} times in "
            f"{f['shard_ticks']} shard ticks")
    snap = svc.snapshot()
    for name in ("seq", "dur", "patient", "counts"):
        a, b = getattr(snap, name), getattr(keep["snap"], name)
        require(a.dtype == b.dtype and a.tobytes() == b.tobytes(),
                f"(f): the restored 'devices' run differs from (e) in {name}")
    require(svc.pids == keep["pids"] and svc.router.pinned == keep["pinned"]
            and svc.migrations == keep["migrations"],
            "(f): pids, router pins or migrations differ from (e)")
    # the journal, continued in its directory after the restore, verifies
    # over the whole run
    f["commit_span_s"] = saved["commit_span_s"] + commit_span_s(session)
    session.journal().flush()
    f["journal"] = journal_readings(jdir)
    kinds = f["journal"]["entries"]
    require(kinds.get("open") == 1 and kinds.get("checkpoint") == 1 and
            kinds.get("migrate", 0) >= SHARD_MIGRATIONS,
            f"(f): journal entries by kind {kinds}")
    t1 = time.perf_counter()
    res = session.verify()
    torch.cuda.synchronize()
    f["verify_s"] = time.perf_counter() - t1
    f["verify"] = str(res)
    require(res.ok, f"(f): the journal of the checkpointed run failed to verify: {res}")
    session.journal().close()
    del session, svc
    gc.collect()          # sharded services and replayed sessions hold cycles
    torch.cuda.empty_cache()
    jroot.cleanup()
    print(f"phase 8 (f, {SHARDS} shards, devices, checkpoint after wave "
          f"{STREAM_CHECKPOINT_WAVE}, journaled): "
          f"{json.dumps(f)}", flush=True)
    return e, f


LAUNCHER_ARGS = ["--shards", "4", "--router", "hash", "--rebalance-every", "4"]


def check_launcher(tmp_root: str) -> dict:
    """The streaming launcher on the card at its default cohort, four
    times: through all waves with ``--journal-dir`` (the uninterrupted run;
    it verifies its journal), then checkpointing and stopping after wave 3,
    then resuming, and ``--replay-journal`` on the first run's journal in
    a new process: the resumed and the replayed run's ``state_digest=``
    must equal the uninterrupted run's (a run without a journal, once
    more, no longer runs: the resumed run has none)."""
    import re

    env = {**os.environ, "PYTHONPATH": str(SRC)}
    ckpt_dir = os.path.join(tmp_root, "launcher_ckpt")
    journal_dir = os.path.join(tmp_root, "launcher_journal")
    runs = {"journaled": ["--journal-dir", journal_dir],
            "stopped": ["--checkpoint-dir", ckpt_dir, "--stop-after-wave", "3"],
            "resumed": ["--checkpoint-dir", ckpt_dir, "--resume"],
            "replayed": ["--replay-journal", journal_dir]}
    out = {}
    for name, extra in runs.items():
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.stream",
                               *LAUNCHER_ARGS, *extra], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=300)
        require(proc.returncode == 0,
                f"launcher ({name}) exited {proc.returncode}: {proc.stderr[-2000:]}")
        digest = re.findall(r"^state_digest=([0-9a-f]{64})$", proc.stdout, re.M)
        require(len(digest) == 1, f"launcher ({name}) printed no state_digest")
        out[name] = {"s": time.perf_counter() - t0, "digest": digest[0],
                     "ingested": [ln for ln in proc.stdout.splitlines()
                                  if ln.startswith(("ingested", "journal ", "replayed "))]}
    whole = out["journaled"]["digest"]
    require(out["resumed"]["digest"] == whole,
            "launcher: the resumed run's digest != the uninterrupted run's")
    require(out["stopped"]["digest"] != whole,
            "launcher: stopping after wave 3 changed nothing")
    require(out["replayed"]["digest"] == whole,
            "launcher: the journal's replay and the uninterrupted run differ")
    print(f"phase 8 (launcher {' '.join(LAUNCHER_ARGS)}): {json.dumps(out)}", flush=True)
    return out


def check_serving_launchers() -> dict:
    """``python -m repro_torch.launch.serve --workload queries`` at its
    defaults and ``python examples/quickstart_torch.py``, each in its own
    process on the card with a time limit."""
    import re

    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = {}
    for name, cmd, expect in (
            ("serve_queries", ["-m", "repro_torch.launch.serve", "--workload", "queries"],
             "served 128 queries"),
            ("quickstart", [str(ROOT / "examples" / "quickstart_torch.py")],
             "served 3 queries")):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *cmd], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=300)
        require(proc.returncode == 0 and expect in proc.stdout,
                f"{name} exited {proc.returncode}: {proc.stdout[-1500:]} {proc.stderr[-1500:]}")
        lines = proc.stdout.splitlines()
        out[name] = {"s": time.perf_counter() - t0,
                     "lines": [ln.strip() for ln in lines
                               if re.search(r"serving|served|latency|serve ", ln)]}
    print(f"serving launchers: {json.dumps(out)}", flush=True)
    return out


def time_delta(torch, db, dev, err: dict) -> dict:
    """``tspm_delta`` at the stream fit's largest slab: the 16 patients
    with the longest histories admitted in one tick (B = 16, Ew = D = 512),
    beside its bound (13 B of stores a slot plus the inputs read once)
    and its plain version, with CUDA events.  The kernel is timed by its
    launch alone into allocated outputs; the wrapper's time per call
    (checks, three allocations, the launch) is printed beside it."""
    from repro_torch.kernels.tspm_delta import ops as delta_ops
    from repro_torch.stream import delta as stream_delta

    top = np.argsort(-db.nevents, kind="stable")[:16]
    n_new = db.nevents[top].astype(np.int32)
    W = 512                                   # _pow2_bucket(301, 8)
    new_ph = np.zeros((16, W), np.int32)
    new_dt = np.zeros((16, W), np.int32)
    for i, p in enumerate(top):
        new_ph[i, :n_new[i]] = db.phenx[p, :n_new[i]]
        new_dt[i, :n_new[i]] = db.date[p, :n_new[i]]
    args = [torch.from_numpy(a).to(dev) for a in
            (new_ph, new_dt, np.zeros(16, np.int32), n_new, new_ph, new_dt)]
    got = delta_ops.delta_pairgen(*args)
    err["tspm_delta"] = max(err["tspm_delta"], max_abs_err(
        torch, got, stream_delta.delta_mine_torch(*args)))
    outs = tuple(torch.empty_like(a) for a in got)
    launch = lambda: delta_ops._launch(args, outs, 0, 0, 30)     # noqa: E731
    ms = cuda_ms(torch, launch, 200)
    require(all(torch.equal(a, b) for a, b in zip(outs, got)), "tspm_delta launch alone")
    device = kernel_device_ms(torch, launch, 200)
    wrapper = cuda_ms(torch, lambda: delta_ops.delta_pairgen(*args), 50)
    plain = cuda_ms(torch, lambda: stream_delta.delta_mine_torch(*args), 10)
    slots = 16 * W * W
    bound = {"bytes": (slots * 13 + 4 * 16 * W * 4 + 2 * 16 * 4) / HBM_BYTES_PER_S * 1e3,
             "operations": slots / INT_OPS_PER_S * 1e3}
    tick = time_hist_tick(torch, got)
    del got, args, outs
    device_ms = sum(device.values())
    return {"ms": ms, "device_ms": device_ms, "device_ms_by_kernel": device,
            "device_bound_share": max(bound.values()) / device_ms,
            "wrapper_ms": wrapper, "plain_ms": plain, "bound": bound, "hist_tick": tick,
            "shape": f"B=16 Ew={W} D={W} real={int(np.sum(n_new * (n_new - 1) // 2))}"}


def time_hist_tick(torch, mined) -> dict:
    """``seq_hist`` at the stream fit's largest tick (16 patients' delta
    slab, every id novel: the sketch's row sort and first flags over empty
    histories), in turns with the kernel before the partitioned design,
    beside its plain version and ``torch.bincount`` with weights."""
    from repro_torch.core import encoding, sparsity
    from repro_torch.kernels.seq_hist import ref as hist_ref

    B = mined.seq.shape[0]
    flat = torch.where(mined.mask.reshape(B, -1), mined.seq.reshape(B, -1), encoding.SENTINEL)
    srt = torch.sort(flat, dim=1).values
    del flat
    h, first = sparsity.hash_bucket(srt, H_DEFAULT), sparsity.row_first_flags(srt)
    del srt
    nb = 1 << H_DEFAULT
    out = time_hist_block(torch, h, first, nb, True)
    weights = first.reshape(-1).to(torch.float32)
    lib = torch.bincount(h.reshape(-1), weights=weights, minlength=nb)
    require(torch.equal(lib.to(torch.int32), hist_ref.hist_ref(h, first, nb)),
            "bincount yardstick disagrees at the tick")
    out["plain_ms"] = cuda_ms(torch, lambda: hist_ref.hist_ref(h, first, nb), 10)
    out["library_ms"] = cuda_ms(torch, lambda: torch.bincount(
        h.reshape(-1), weights=weights, minlength=nb), 10)
    del h, first, weights, lib
    return out


def hist_bound(n: int, counted: int, n_buckets: int) -> dict:
    """Least time of the histogram on these inputs: every mask byte is read,
    h only where the mask is set, and the table is written once."""
    return {"bytes": (n + 4 * counted + 4 * n_buckets) / HBM_BYTES_PER_S * 1e3,
            "operations": counted / INT_OPS_PER_S * 1e3}


def turns_ms(torch, calls: dict, iters: int = 10) -> dict:
    """``in_turns`` readings (a, b, b, a) of each call and their mean."""
    t = in_turns(torch, calls, iters)
    return {**{f"{k}_turns": v for k, v in t.items()},
            **{k: sum(v) / len(v) for k, v in t.items()}}


def time_hist_paths(torch, h, first, H: int) -> dict:
    """Phase 6a: the histogram at a small table (H = 12, the private
    shared table) over the main path's ids, in turns with the kernel
    before the partitioned design on its shared path and on its global
    path, all three tables equal."""
    from repro_torch.kernels.seq_hist import ops as hist_ops

    nb = 1 << H
    out = {"H": H, "n": h.numel(), "counted": int(first.sum())}
    tables = {k: torch.zeros(nb, dtype=torch.int32, device=h.device)
              for k in ("old_shared", "old_global")}
    calls = {"ms": lambda: hist_ops.hist(h, first, nb),
             "old_shared_ms": lambda: old_hist(torch, h, first,
                                               tables["old_shared"].zero_(), True),
             "old_global_ms": lambda: old_hist(torch, h, first,
                                               tables["old_global"].zero_(), False)}
    out.update(turns_ms(torch, calls))
    want = hist_ops.hist(h, first, nb)
    for k, t in tables.items():
        require(torch.equal(t, want), f"seq_hist at H={H}: the {k} kernel disagrees")
    bound = hist_bound(out["n"], out["counted"], nb)
    out["bound_ms"] = max(bound.values())
    return out


def time_hist_block(torch, hb, fb, nb: int, device_trace: bool) -> dict:
    """``seq_hist`` at one of the fit's blocks: the wrapper as the fit
    calls it (``ms``, its route) and the partitioned route in turns with
    the kernel before the partitioned design (global atomics, the
    ``global`` route), beside the bound; with ``device_trace`` the
    partitioned route's stages' device time from a profiler trace."""
    from repro_torch.kernels.seq_hist import ops as hist_ops

    old = torch.zeros(nb, dtype=torch.int32, device=hb.device)
    part = torch.zeros(nb, dtype=torch.int32, device=hb.device)
    counted = int(fb.sum())
    calls = {"partitioned_ms": lambda: hist_ops._launch(hb, fb, part.zero_(), "partitioned"),
             "old_ms": lambda: old_hist(torch, hb, fb, old.zero_())}
    out = {"rows": hb.shape[0], "n": hb.numel(), "counted": counted,
           "route": hist_ops.route(hb.numel(), nb), **turns_ms(torch, calls),
           "ms": cuda_ms(torch, lambda: hist_ops.hist(hb, fb, nb), 10),
           "bound_ms": max(hist_bound(hb.numel(), counted, nb).values())}
    want = hist_ops.hist(hb, fb, nb)
    require(torch.equal(old, want) and torch.equal(part, want),
            "seq_hist: the global and partitioned routes disagree")
    if device_trace:
        dev_ms = kernel_device_ms(torch, lambda: hist_ops._launch(hb, fb, part.zero_(),
                                                                  "partitioned"), 10)
        out["device_ms_by_kernel"] = dev_ms
        out["stage_device_ms"] = stage_ms(dev_ms, HIST_STAGES)
        out["old_device_ms"] = sum(kernel_device_ms(
            torch, lambda: old_hist(torch, hb, fb, old.zero_()), 10).values())
    return out


def time_kernels(torch, db, dev, err: dict, launches: dict):
    """Phase 6a: each kernel at the main path's full-size shapes."""
    from repro_torch.core import encoding, sparsity
    from repro_torch.kernels.seq_hist import ops as hist_ops, ref as hist_ref
    from repro_torch.kernels.tspm_pairgen import ops as pg_ops, ref as pg_ref

    phenx, date, nevents = (torch.from_numpy(a).to(dev)
                            for a in (db.phenx, db.date, db.nevents))
    P, E = phenx.shape
    pairs = P * E * E
    got = pg_ops.pairgen(phenx, date, nevents)
    err["tspm_pairgen"] = max(err["tspm_pairgen"], max_abs_err(
        torch, got, pg_ref.pairgen_ref(phenx, date, nevents)))
    pg_ms = cuda_ms(torch, lambda: pg_ops.pairgen(phenx, date, nevents), 5)
    pg_plain = cuda_ms(torch, lambda: pg_ref.pairgen_ref(phenx, date, nevents), 3)
    pg_bytes = 2 * P * E * 4 + P * 4 + pairs * (8 + 4 + 1)
    pg_bound = {"bytes": pg_bytes / HBM_BYTES_PER_S * 1e3,
                "operations": pairs / INT_OPS_PER_S * 1e3}

    H = 20                                        # MiningConfig.n_buckets_log2
    flat = torch.where(got.mask, got.seq, encoding.SENTINEL).reshape(P, -1)
    del got
    srt = torch.sort(flat, dim=1).values
    del flat
    first = sparsity.row_first_flags(srt)
    paths = time_hist_paths(torch, sparsity.hash_bucket(srt, 12), first, 12)
    h = sparsity.hash_bucket(srt, H)
    del srt
    n, nb = h.numel(), 1 << H
    table = hist_ops.hist(h, first, nb)
    err["seq_hist"] = max(err["seq_hist"], max_abs_err(
        torch, [table], [hist_ref.hist_ref(h, first, nb)]))
    slab_ms = cuda_ms(torch, lambda: hist_ops.hist(h, first, nb), 10)
    # the fit's launches: one per patient block of at most BLOCK_ELEMENTS
    # ids (sparsity.local_bucket_counts); the row is the first (full) block's
    blk = max(1, sparsity.BLOCK_ELEMENTS // (E * E))
    blocks = [time_hist_block(torch, h[s:s + blk], first[s:s + blk], nb, s == 0)
              for s in range(0, P, blk)]
    hb, fb = h[:blk], first[:blk]
    weights = fb.reshape(-1).to(torch.float32)
    lib = torch.bincount(hb.reshape(-1), weights=weights, minlength=nb)
    require(torch.equal(lib.to(torch.int32), hist_ops.hist(hb, fb, nb)),
            "bincount yardstick disagrees")
    hs_plain = cuda_ms(torch, lambda: hist_ref.hist_ref(hb, fb, nb), 3)
    hs_lib = cuda_ms(torch, lambda: torch.bincount(hb.reshape(-1), weights=weights,
                                                    minlength=nb), 3)
    hs_bound = hist_bound(blocks[0]["n"], blocks[0]["counted"], nb)
    counted = int(first.sum())
    fit_ms = sum(b["ms"] for b in blocks)
    fit_old = sum(b["old_ms"] for b in blocks)
    fit_bound = sum(b["bound_ms"] for b in blocks)
    hs_extra = {"blocks": blocks, "fit_blocks_ms": fit_ms, "fit_blocks_old_ms": fit_old,
                "fit_blocks_bound_ms": fit_bound, "old_ms": blocks[0]["old_ms"],
                "stage_device_ms": blocks[0]["stage_device_ms"],
                "slab_ms": slab_ms, "slab_shape": f"N={n} H={H} counted={counted}",
                "counted_adds_per_s": counted / (fit_ms / 1e3),
                "old_adds_per_s": counted / (fit_old / 1e3),
                "bound_adds_per_s": counted / (fit_bound / 1e3)}
    print(f"seq_hist at the fit's blocks: {json.dumps(hs_extra)}", flush=True)
    del h, first, weights, lib, table, hb, fb
    torch.cuda.empty_cache()

    print(f"seq_hist at H=12: {json.dumps(paths)}", flush=True)
    return paths, [
        kernel_row("tspm_pairgen", "src/repro/kernels/tspm_pairgen/pairgen.py:29",
                   launches, err, pg_ms, pg_plain, pg_bound, None, f"P={P} E={E}"),
        {**kernel_row("seq_hist", "src/repro/kernels/seq_hist/seq_hist.py:25",
                      launches, err, blocks[0]["ms"], hs_plain, hs_bound, hs_lib,
                      f"N={blocks[0]['n']} H={H} counted={blocks[0]['counted']} "
                      f"(the first of {len(blocks)} blocks of {blk} patients)"),
         **hs_extra},
    ]


def kernel_row(name, replaces, launches, err, ms, plain, bound, lib_ms, shape):
    by = max(bound, key=bound.get)
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": launches[name], "max_abs_err": err[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bound[by], "bound_by": by,
            "library_ms": lib_ms, "shape": shape}


def time_fused(torch, db, dev, err: dict) -> dict:
    """``tspm_fused`` at a cohort's full size and H = 20, beside its bound
    and the plain version of its algorithm, with CUDA events.  The bound
    reads the cohort once and writes the table once (bytes), or does the
    operations ``FUSED_*_OPS`` count (each counted pair's id,
    multiply-shift and count; the dedup test of each pair of a row that
    repeats a code) at the 32-bit rate; the counted pairs a second are the
    pace of its counts."""
    from repro_torch.analysis import roofline
    from repro_torch.kernels.tspm_fused import ops as fused_ops, ref as fused_ref

    x, nev = (torch.from_numpy(a).to(dev) for a in (db.phenx, db.nevents))
    P, E = x.shape
    got = fused_ops.fused_table(x, nev, H_DEFAULT)
    err["tspm_fused"] = max(err["tspm_fused"], max_abs_err(
        torch, [got], [fused_ref.fused_table_ref(x, nev, H_DEFAULT)]))
    n = np.clip(db.nevents.astype(np.int64), 0, E)
    repeats = rows_with_repeats(db.phenx, n)
    upper = n * (n - 1) // 2
    dedup = int(upper[repeats].sum())
    if not repeats.any():                # then every pair i < j is counted
        require(int(got.sum()) == int(upper.sum()),
                "tspm_fused counted another number of pairs")
    counted = int(got.sum())
    old = torch.zeros_like(got)
    t = turns_ms(torch, {"ms": lambda: fused_ops.fused_table(x, nev, H_DEFAULT),
                         "old_ms": lambda: old_fused(torch, x, nev, old.zero_(), H_DEFAULT)})
    require(torch.equal(old, got), "tspm_fused: the old kernel disagrees")
    dev_ms = kernel_device_ms(torch, lambda: fused_ops.fused_table(x, nev, H_DEFAULT), 5)
    plain = cuda_ms(torch, lambda: fused_ref.fused_table_ref(x, nev, H_DEFAULT), 2)
    ops = FUSED_PAIR_OPS * counted + FUSED_DEDUP_OPS * dedup
    bound = {"bytes": (P * E * 4 + P * 4 + 4 * (1 << H_DEFAULT)) / HBM_BYTES_PER_S * 1e3,
             "operations": ops / INT_OPS_PER_S * 1e3}
    rounds = len(fused_ops.fused_rounds(db.nevents, E, roofline.mining_tile_plan(
        E, H_DEFAULT, device=dev).round_pairs))
    del x, nev, got, old
    torch.cuda.empty_cache()
    return {**t, "plain_ms": plain, "bound": bound, "dedup_pairs": dedup, "operations": ops,
            "rounds": rounds, "device_ms_by_kernel": dev_ms,
            "stage_device_ms": stage_ms(dev_ms, FUSED_STAGES),
            "counted_adds_per_s": counted / (t["ms"] / 1e3),
            "old_adds_per_s": counted / (t["old_ms"] / 1e3),
            "bound_adds_per_s": counted / (max(bound.values()) / 1e3),
            "shape": f"P={P} E={E} H={H_DEFAULT} counted={counted}"}


def rows_with_repeats(phenx: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Whether each row repeats a code among its first n events."""
    P, E = phenx.shape
    pad = np.iinfo(np.int64).min + np.arange(E, dtype=np.int64)   # distinct, below every code
    live = np.arange(E)[None, :] < n[:, None]
    srt = np.sort(np.where(live, phenx.astype(np.int64), pad[None, :]), axis=1)
    return (srt[:, 1:] == srt[:, :-1]).any(axis=1)


def fused_fit_launches(torch, db, device) -> int:
    """``tspm_fused``'s launches in one fused batch fit of ``db`` (the
    counts zeroed just before the fit and read just after)."""
    fu = fit_engine(torch, db, device, screen="fused", threshold=THRESHOLD)
    n = fu["launches"]["tspm_fused"]
    require(n >= 1, "fused: tspm_fused never launched")
    print(f"fused batch fit: {n} tspm_fused launches, {fu['fit_s']} s", flush=True)
    del fu
    torch.cuda.empty_cache()
    return n


def time_fit_phases(torch, db, device) -> dict:
    """Phase 6b: the batch engine's phases, each ended by a synchronize."""
    from repro_torch.api import SequenceFrame
    from repro_torch.core import mining, sparsity

    t = {}
    t0 = time.perf_counter()
    args = [torch.from_numpy(a).to(device) for a in (db.phenx, db.date, db.nevents)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mined = mining.mine(*args)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = sparsity.local_bucket_counts(mined.seq, mined.mask, 20)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    frame = SequenceFrame(*mining.flatten(mined), counts=counts)
    t4 = time.perf_counter()
    t.update(host_to_device_s=t1 - t0, mine_s=t2 - t1, hash_counts_s=t3 - t2,
             compact_and_copy_to_host_s=t4 - t3, rows=len(frame))
    del mined, counts, frame
    torch.cuda.empty_cache()
    return t


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the mask leaves visible, for one (batch, head)."""
    qi = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qi + 1, Skv) if causal else np.full(Sq, Skv, np.int64)
    lo = np.maximum(qi - window + 1, 0) if window is not None else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def time_flash(torch, q, k, v, *, causal, window, softcap, sdpa: bool,
               beside: str | None = None) -> dict:
    """``flash_attention`` on ``q/k/v [B,H,S,D]`` with CUDA events: the
    launch alone into an allocated output (the route ``ops.route`` names,
    with a null log-sum-exp pointer as serving launches it), in turns with
    the same launch writing the log-sum-exp (``ms_lse``, training's form),
    with ``beside``, that route at the same shape, and (where it computes
    the same function: no softcap, no window) one
    ``scaled_dot_product_attention`` call as the yardstick; then the plain
    version.  ``device_ms`` and ``library_device_ms`` are the device time
    of the route's and of the library call's kernels in a profiler trace
    (events around back-to-back calls also count the host's time between
    launches where a call is short), None where the trace holds none of
    them: late in this script a trace misses the kernels launched through
    ``ctypes`` (``card_probe.py plans`` times them in a fresh process).
    The bound is the larger of q, k, v and o over 3.35 TB/s and the
    operations over the card's peak for their type: for bfloat16 4*D a
    visible pair on bf16 tensor cores (``bound_split_ms`` also counts the
    wgmma route's second P V product of its bf16 hi + lo split, 6*D a pair);
    for float32 3xTF32, float32-accurate work at the card's highest rate:
    12*D a pair (three TF32 products each way) on TF32 tensor cores, with
    ``bound_ffma_ms`` (4*D a pair at the FFMA rate) beside it.  On the
    tf32x3 route ``prepass_ms`` and ``main_kernel_ms`` are the device times
    of its two kernels in a profiler trace of the call."""
    from repro_torch.kernels.flash_attention import ops as flash_ops, ref as flash_ref

    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v = (t.contiguous() for t in (q, k, v))
    B, Hq, Sq, D = q.shape
    route = flash_ops.route(q.dtype, D)
    outs = {r: torch.empty_like(q) for r in (route, beside) if r}
    calls = {r: (lambda r=r: flash_ops._launch(q, k, v, outs[r], force_route=r, **kw))
             for r in outs}
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    calls["lse"] = lambda: flash_ops._launch(q, k, v, torch.empty_like(q), lse=lse, **kw)
    if sdpa:
        import torch.nn.functional as F

        calls["sdpa"] = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                               enable_gqa=True)
    turns = in_turns(torch, calls)
    ms = {r: sum(t) / len(t) for r, t in turns.items()}
    device = {r: sum(kernel_device_ms(torch, calls[r], 10).values()) or None
              for r in (route, "sdpa") if r in calls}
    dtype = str(q.dtype).removeprefix("torch.")
    want = flash_ref.attention_ref(q, k, v, **kw)
    errs = {r: flash_err(torch, outs[r], want, dtype) for r in outs}
    out = outs[route]
    reading = bf16_reading(torch, out, want, "layer") if dtype == "bfloat16" else None
    del want
    plain = cuda_ms(torch, lambda: flash_ref.attention_ref(q, k, v, **kw), 2)
    if sdpa:
        lib_err = (calls["sdpa"]().float() - out.float()).abs().max().item()
        require(lib_err < SDPA_SAME_FUNCTION[dtype],
                f"scaled_dot_product_attention computes another function here "
                f"(max |diff| {lib_err})")
    pairs = B * Hq * visible_pairs(Sq, k.shape[2], causal, window)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    f32 = q.dtype == torch.float32
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": (12 * D * pairs / TF32_OPS_PER_S if f32
                            else 4 * D * pairs / BF16_OPS_PER_S) * 1e3}
    by = max(bound, key=bound.get)
    split = max(bound["bytes"], 1.5 * bound["operations"]) if route == "wgmma" else None
    r = {"route": route, "ms": ms[route], "ms_turns": turns[route],
         "ms_lse": ms["lse"], "ms_lse_turns": turns["lse"], "plain_ms": plain,
         "library_ms": ms.get("sdpa"), "library_ms_turns": turns.get("sdpa"),
         "device_ms": device[route], "library_device_ms": device.get("sdpa"),
         "bound_ms": bound[by], "bound_by": by,
         "bound_split_ms": split, "max_abs_err": errs[route], "bf16_reading": reading,
         "visible_pairs": pairs,
         "shape": f"q {list(q.shape)} k {list(k.shape)} {dtype} causal={causal} "
                  f"window={window} softcap={softcap}"}
    if f32:
        r["bound_ffma_ms"] = max(bound["bytes"], 4 * D * pairs / FP32_OPS_PER_S * 1e3)
    if route == "tf32x3":
        scratch = torch.empty(flash_ops.tf32x3_scratch_elems(k.shape), dtype=torch.float32,
                              device=q.device)
        dev_ms = kernel_device_ms(torch, lambda: flash_ops._launch(
            q, k, v, out, scratch=scratch, **kw), 20)
        pre = [t for n, t in dev_ms.items() if "tf32x3_split_kernel" in n]
        main = [t for n, t in dev_ms.items() if "flash_tf32x3_kernel" in n]
        if len(pre) == len(main) == 1:
            r.update(prepass_ms=pre[0], main_kernel_ms=main[0],
                     prepass_share=pre[0] / (pre[0] + main[0]))
        else:
            r.update(prepass_ms=None, main_kernel_ms=None, prepass_share=None,
                     profiler_kernels=sorted(dev_ms))
        del scratch
    if beside:
        r["beside"] = {"route": beside, "ms": ms[beside], "ms_turns": turns[beside],
                       "max_abs_err": errs[beside]}
    return r


# ---- flash_attention's backward (phase 3b) -------------------------------

BWD_MODEL_SHAPES = {   # (B, Hq, Hkv, Sq, Skv, D), dtype, mask: a training step's layer
    "tspm_mlho": ((8, 12, 4, 256, 256, 64), "float32", dict(causal=True)),
    "gemma2_2b": ((1, 8, 4, 2048, 2048, 256), "bfloat16",
                  dict(causal=True, window=4096, softcap=50.0)),
    # zamba2-2.7b's shared attention at 1 x 4,096 tokens (phase 10 (e))
    "zamba2_2_7b": ((1, 32, 32, 4096, 4096, 160), "bfloat16", dict(causal=True)),
    # seamless-m4t-large-v2's encoder self-attention and its decoder's
    # cross-attention at 2 x (1,024 + 1,024) (phase 10 (e)): non-causal
    "seamless_enc": ((2, 16, 16, 1024, 1024, 64), "bfloat16", dict(causal=False)),
    # deepseek-moe-16b's and pixtral-12b's layers at phase 10 (e)'s batches
    # (4 x 512 tokens; 2 x (1,024 patches + 64 text tokens)): bf16 at D 128
    "deepseek_moe_16b": ((4, 16, 16, 512, 512, 128), "bfloat16", dict(causal=True)),
    "pixtral_12b": ((2, 32, 8, 1088, 1088, 128), "bfloat16", dict(causal=True)),
    # zamba2-2.7b's shared attention in float32 at phase 10 (d)'s 1 x 256
    # tokens: the ffma route at D 160
    "zamba2_2_7b_f32": ((1, 32, 32, 256, 256, 160), "float32", dict(causal=True)),
}


def flash_bwd_edge_cases():
    """(B, Hq, Hkv, Sq, Skv, D, options) of the backward's checks: one-row
    and ragged tiles (S = 1/127/128/129), Sq != Skv causal and not, every
    head width, GQA groups 1, 2, 3 and 8, windows 1 and 16, softcap 50 (with
    a window at D = 256, where the ffma route takes 32-key tiles), and rows
    that see no key (non-causal with a window, Sq > Skv).  Then the
    tensor-core routes' own edges (bfloat16 at D 64/128/256 on wgmma,
    float32 at D 64 on tf32x3; 128-row resident tiles, 32- or 64-row
    streamed tiles): at each width S = 1/63/127/128/129/1,000 and Sq != Skv
    causal and not; at D 64 a GQA group of 3 under a window of 100 with
    softcap 50; at D = 256 GQA groups 1, 2, 4 and 8, windows 1 and 300
    with softcap 50, and rows that see no key; then D 160's
    (``flash_bwd_d160_cases``).  Each case runs in float32 (the ffma
    route; tf32x3 at D 64) and bfloat16."""
    for S in (1, 127, 128, 129):
        yield 2, 4, 2, S, S, 64, dict(causal=True)
    for Sq, Skv in ((100, 260), (260, 100)):
        for causal in (True, False):
            yield 1, 4, 4, Sq, Skv, 64, dict(causal=causal)
    for D in (16, 32, 64, 128, 256):
        yield 1, 4, 2, 130, 130, D, dict(causal=True)
    for Hq, Hkv in ((8, 8), (8, 4), (6, 2), (8, 1)):
        yield 1, Hq, Hkv, 96, 96, 64, dict(causal=True)
    for window in (1, 16):
        yield 1, 2, 1, 300, 300, 64, dict(causal=True, window=window)
    yield 1, 4, 2, 200, 200, 128, dict(causal=True, softcap=50.0)
    yield 1, 4, 2, 300, 300, 256, dict(causal=True, window=64, softcap=50.0)
    yield 1, 4, 2, 96, 40, 64, dict(causal=False, window=16)
    for D in (64, 128, 256):
        for S in (1, 63, 127, 128, 129, 1000):
            yield 1, 4, 2, S, S, D, dict(causal=True)
        for Sq, Skv in ((63, 1000), (1000, 129)):
            for causal in (True, False):
                yield 1, 4, 2, Sq, Skv, D, dict(causal=causal)
    yield 1, 6, 2, 300, 300, 64, dict(causal=True, window=100, softcap=50.0)
    for Hkv in (8, 4, 2, 1):
        yield 1, 8, Hkv, 200, 200, 256, dict(causal=True)
    for window in (1, 300):
        yield 1, 4, 2, 700, 700, 256, dict(causal=True, window=window, softcap=50.0)
    yield 1, 4, 2, 96, 40, 256, dict(causal=False, window=16)
    yield from flash_bwd_d160_cases()


def flash_bwd_d160_cases():
    """D 160 (zamba2-2.7b's shared attention; three 64-column boxes on the
    wgmma route, ffma in float32): S = 1/127/128/129, Sq != Skv causal and
    not, GQA groups 1, 2, 4 and 8, windows 1 and 16, softcap 50, and rows
    that see no key."""
    for S in (1, 127, 128, 129):
        yield 1, 4, 2, S, S, 160, dict(causal=True)
    for Sq, Skv in ((63, 1000), (1000, 129)):
        for causal in (True, False):
            yield 1, 4, 2, Sq, Skv, 160, dict(causal=causal)
    for Hkv in (8, 4, 2, 1):
        yield 1, 8, Hkv, 200, 200, 160, dict(causal=True)
    for window in (1, 16):
        yield 1, 4, 2, 300, 300, 160, dict(causal=True, window=window)
    yield 1, 4, 2, 200, 200, 160, dict(causal=True, softcap=50.0)
    yield 1, 4, 2, 96, 40, 160, dict(causal=False, window=16)


def bwd_inputs(torch, dev, shape, dtype: str, seed: int):
    """q, k, v, do from a seeded generator on the card."""
    B, Hq, Hkv, Sq, Skv, D = shape
    g = torch.Generator(dev).manual_seed(seed)
    return [torch.randn(B, H, S, D, generator=g, device=dev).to(getattr(torch, dtype))
            for H, S in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv), (Hq, Sq))]


def bwd_reading(torch, got, q, k, v, o, do, kw) -> dict:
    """The backward's result ``got`` held to its limit
    (``ref.attention_bwd_limit``) beside a planted fault: the plain
    version's result with the first query row's output gradient dropped (a
    kernel that skips a row).  Per tensor: the largest |got - want64| over
    its limit (``ratio``, must be <= 1), the fault's (``fault_ratio``; one
    of the three must exceed 1), the float32 plain version's own error
    ``e32`` and |got - plain| (``max_abs_err``, plain = the float32 plain
    version rounded to the inputs' dtype, as on the CPU); at D 160 the last
    32 columns' ratio on their own (``tail_ratio``, the wgmma route's
    third, half-filled box)."""
    from repro_torch.kernels.flash_attention import ref as flash_ref

    want64, want32, e32s, limits = flash_ref.attention_bwd_limit(q, k, v, o, do, **kw)
    t64 = [t.double() for t in (q, k, v, o, do)]
    t64[4][:, :, 0] = 0
    fault = flash_ref.attention_bwd_ref(*t64, flash_ref.attention_lse_ref(*t64[:2], **kw),
                                        **kw)
    out = {}
    for name, g, w32, w64, f, e32, limit in zip(("dq", "dk", "dv"), got, want32, want64,
                                                fault, e32s, limits):
        require(g.dtype == q.dtype and g.shape == w64.shape, f"{name}: {g.dtype} {g.shape}")
        limit = torch.where(limit > 0, limit, torch.full_like(limit, 1e-300))
        diff = (g.double() - w64).abs()
        out[name] = {"ratio": (diff / limit).max().item(),
                     "tail_ratio": (diff[..., 128:] / limit[..., 128:]).max().item()
                     if g.shape[3] == 160 else None,
                     "fault_ratio": ((f - w64).abs() / limit).max().item(),
                     "e32": e32, "max_want": w64.abs().max().item(),
                     "max_diff64": diff.max().item(),
                     "max_abs_err": (g.float() - w32.to(g.dtype).float()).abs().max().item()}
        require(out[name]["ratio"] <= 1.0 and (out[name]["tail_ratio"] or 0.0) <= 1.0,
                f"flash_attention_bwd {name} beyond its limit: {json.dumps(out[name])}")
    require(max(r["fault_ratio"] for r in out.values()) > 1.0,
            f"the backward's limit passes a dropped query row: {json.dumps(out)}")
    return out


def check_flash_bwd_kernel(torch, dev) -> dict:
    """Phase 3b for ``flash_attention_bwd``: each build's registers, spill
    and shared memory (once; every kernel of the wgmma and tf32x3 routes,
    and the ffma route's at float32 D 160, must spill nothing), the kernel
    against the plain version at every edge case in both dtypes and at the
    training shapes of ``BWD_MODEL_SHAPES``, each call through the route
    ``ops.bwd_route`` names (one count a call) with the log-sum-exp the
    forward wrote, each run twice: identical bytes.  On tf32x3 a third call
    is given its scratch, which must then hold the pre-pass's plain twin
    (``ref.tf32x3_bwd_operands``, on the card) byte for byte."""
    from repro_torch.kernels.flash_attention import ops as flash_ops, ref as flash_ref

    info = {f"{dt} D={D}": flash_ops.bwd_kernel_info(getattr(torch, dt), D)
            for dt in ("float32", "bfloat16") for D in flash_ops.BWD_HEAD_DIMS}
    info["float32 D=64 ffma"] = flash_ops.bwd_kernel_info(torch.float32, 64, "ffma")
    print(f"phase 3b flash_attention_bwd builds: {json.dumps(info)}", flush=True)
    for build, kernels in info.items():
        if "bwd_wgmma" in kernels or "bwd_tf32x3" in kernels or build.endswith("D=160"):
            require(all(k["local_bytes"] == 0 for k in kernels.values()),
                    f"flash_attention_bwd spills at {build}: {kernels}")
    cases, worst, routes = [], {}, {}
    prepass = {"compared": 0, "floats": 0}

    def check(shape, dtype, kw, seed):
        q, k, v, do = bwd_inputs(torch, dev, shape, dtype, seed)
        o, lse = flash_ops.attention(q, k, v, return_lse=True, **kw)
        route = flash_ops.bwd_route(q.dtype, shape[5])
        before = flash_ops.attention_bwd.route_launches[route]
        got = flash_ops.attention_bwd(q, k, v, o, do, lse, **kw)
        again = flash_ops.attention_bwd(q, k, v, o, do, lse, **kw)
        torch.cuda.synchronize()
        require(flash_ops.attention_bwd.route_launches[route] == before + 2,
                f"{shape} {dtype}: a backward call did not launch the {route} route")
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"{shape} {dtype} {kw}: two backward runs differ")
        if route == "tf32x3":
            B, Hq, Hkv, Sq, Skv, _ = shape
            scratch = torch.full((flash_ops.bwd_scratch_elems(route, B, Hq, Sq, Hkv, Skv),),
                                 float("nan"), device=dev)
            flash_ops._backward(q, k, v, o, do, lse, scratch=scratch,
                                **{"window": None, "softcap": None, **kw})
            twin = torch.cat([t.flatten() for t in flash_ref.tf32x3_bwd_operands(
                q, k, v, o, do, lse)])
            require(torch.equal(scratch.view(torch.int32), twin.view(torch.int32)),
                    f"{shape} {kw}: the tf32x3 pre-pass differs from its plain twin")
            prepass["compared"] += 1
            prepass["floats"] += scratch.numel()
            del scratch, twin
        r = bwd_reading(torch, got, q, k, v, o, do, kw)
        for n, x in r.items():
            w = worst.setdefault(f"{route} {dtype} {n}", {"ratio": 0.0, "max_abs_err": 0.0})
            w["ratio"] = max(w["ratio"], x["ratio"])
            w["max_abs_err"] = max(w["max_abs_err"], x["max_abs_err"])
        routes[route] = routes.get(route, 0) + 1
        return route, r

    for i, (B, Hq, Hkv, Sq, Skv, D, kw) in enumerate(flash_bwd_edge_cases()):
        for dtype in ("float32", "bfloat16"):
            route, r = check((B, Hq, Hkv, Sq, Skv, D), dtype, kw, i)
            cases.append({"case": [B, Hq, Hkv, Sq, Skv, D], "kw": kw, "dtype": dtype,
                          "route": route, **{n: [round(x["ratio"], 4), round(x["fault_ratio"], 2)]
                                             for n, x in r.items()}})
            if D == 160:
                cases[-1]["tail"] = [round(x["tail_ratio"], 4) for x in r.values()]
    print(f"phase 3b flash_attention_bwd cases ([ratio to limit, fault's ratio] per "
          f"tensor): {json.dumps(cases)}", flush=True)
    models = {}
    for name, (shape, dtype, kw) in BWD_MODEL_SHAPES.items():
        models[name] = check(shape, dtype, kw, 7)[1]
    torch.cuda.empty_cache()
    require(set(routes) == set(flash_ops.BWD_ROUTES), f"the edge cases miss a route: {routes}")
    require(prepass["compared"] > 0, "no tf32x3 pre-pass was held against its twin")
    out = {"comparisons": len(cases) + len(models), "by_route": routes, "worst": worst,
           "models": models, "repeat_identical": True, "tf32x3_prepass_identical": prepass,
           "factor": flash_ref.BWD_ERR_FACTOR,
           "bf16_rel": flash_ref.BWD_BF16_REL,
           "max_abs_err": max(w["max_abs_err"] for w in worst.values()),
           "max_abs_err_by_route": {r: max(w["max_abs_err"] for k, w in worst.items()
                                           if k.startswith(r + " ")) for r in routes}}
    print(f"phase 3b flash_attention_bwd: {json.dumps(out)}", flush=True)
    return out


def time_flash_bwd(torch, dev, name: str) -> dict:
    """The backward at a model's training shape (``BWD_MODEL_SHAPES``):
    ``ops.attention_bwd`` with CUDA events (its launches and the scratch),
    given the forward's log-sum-exp, each kernel's device time from a
    profiler trace, the plain version, and
    ``scaled_dot_product_attention``'s backward at the same shape as a
    yardstick (gemma2-2b's without the softcap, which it does not take).
    Late in the smoke a trace keeps only part of the kernels' events (on
    one H100 their sum came to 29% of the CUDA-event time, the forward's
    tf32x3 pair to 43%), so each kernel's share of the sum is printed
    beside its reading.  Bound: 10*D flops a visible pair (s, dp, dv, dq,
    dk; nothing is recomputed on the bound's side), at the float32
    tensor-core rate as 3xTF32 (three TF32 products each) or the bf16 rate,
    or the bytes (q, k, v, o, do and the log-sum-exp read, dq, dk, dv
    written) over 3.35 TB/s if larger; ``bound_ffma_ms`` the same
    operations at the FFMA rate.  Where the route is tf32x3 (tspm-mlho's
    layer) the ffma route forced at the same shape (``force_route``) is
    timed in turns with it (ffma, tf32x3, tf32x3, ffma), with its device
    time by kernel and its distance from the plain version (``beside``)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as flash_ops, ref as flash_ref

    shape, dtype, kw = BWD_MODEL_SHAPES[name]
    B, Hq, Hkv, Sq, Skv, D = shape
    q, k, v, do = bwd_inputs(torch, dev, shape, dtype, 11)
    o, lse = flash_ops.attention(q, k, v, return_lse=True, **kw)
    route = flash_ops.bwd_route(q.dtype, D)
    call = lambda: flash_ops.attention_bwd(q, k, v, o, do, lse, **kw)  # noqa: E731
    ms = [cuda_ms(torch, call, 10) for _ in range(2)]
    dev_ms = kernel_device_ms(torch, call, 10)
    by_kernel = {n: sum(t for kn, t in dev_ms.items() if f"{n}_kernel" in kn)
                 for n in flash_ops.BWD_KERNELS[route]}
    plain = cuda_ms(torch, lambda: flash_ref.attention_bwd_ref(q, k, v, o, do, lse, **kw), 2)
    beside = None
    if route == "tf32x3":
        mask = {"window": None, "softcap": None, **kw}
        ffma = lambda: flash_ops._backward(q, k, v, o, do, lse, force_route="ffma",  # noqa: E731
                                           **mask)
        turns = {"ffma": [], "tf32x3": []}
        for r_, fn in (("ffma", ffma), ("tf32x3", call), ("tf32x3", call), ("ffma", ffma)):
            turns[r_].append(cuda_ms(torch, fn, 20))
        f_dev = kernel_device_ms(torch, ffma, 10)
        want32 = flash_ref.attention_bwd_ref(q, k, v, o, do, lse, **kw)
        beside = {"route": "ffma", "ms": sum(turns["ffma"]) / 2, "ms_turns": turns["ffma"],
                  "tf32x3_ms_turns": turns["tf32x3"],
                  "device_ms": {n: sum(t for kn, t in f_dev.items() if f"{n}_kernel" in kn)
                                for n in flash_ops.BWD_KERNELS["ffma"]},
                  "max_abs_err": max((g - w).abs().max().item()
                                     for g, w in zip(ffma(), want32))}
        del want32
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    so = F.scaled_dot_product_attention(qr, kr, vr, is_causal=kw["causal"], enable_gqa=True)
    lib = cuda_ms(torch, lambda: torch.autograd.grad(so, (qr, kr, vr), do,
                                                     retain_graph=True), 10)
    pairs = B * Hq * visible_pairs(Sq, Skv, kw["causal"], kw.get("window"))
    flops = 10 * D * pairs
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, o, do, lse)) \
        + sum(t.numel() * t.element_size() for t in (q, k, v))
    f32 = dtype == "float32"
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": (3 * flops / TF32_OPS_PER_S if f32 else flops / BF16_OPS_PER_S) * 1e3}
    by = max(bound, key=bound.get)
    total = sum(by_kernel.values())
    r = {"kernel_route": route, "ms": sum(ms) / len(ms), "ms_runs": ms, "device_ms": by_kernel,
         "device_share": {n: t / total if total else None for n, t in by_kernel.items()},
         "plain_ms": plain, "library_ms": lib, "library_same_function": "softcap" not in kw
         or kw["softcap"] is None, "bound_ms": bound[by], "bound_by": by,
         "bound_ffma_ms": max(bound["bytes"], flops / FP32_OPS_PER_S * 1e3),
         "visible_pairs": pairs, "beside": beside,
         "shape": f"q {[B, Hq, Sq, D]} k/v {[B, Hkv, Skv, D]} {dtype} {kw}"}
    print(f"phase 3b flash_attention_bwd timing ({name}): {json.dumps(r)}", flush=True)
    require(r["ms"] < plain, f"flash_attention_bwd at {name} is slower than its plain "
                             f"version: {r['ms']} ms against {plain} ms")
    if beside:
        require(max(beside["tf32x3_ms_turns"]) < min(beside["ms_turns"]),
                f"the tf32x3 backward at {name} is not faster than ffma in turns: "
                f"{json.dumps(beside)}")
    del q, k, v, do, o, lse, qr, kr, vr, so
    torch.cuda.empty_cache()
    return r


def lm_prompts(raw_db) -> list:
    """The first ``LM_PROMPT_LEN`` tokens of each of the first
    ``LM_REQUESTS`` Table 1 patients whose document is that long.  The
    dbmart is taken before the first-occurrence filter: after it no
    Table 1 document reaches 896 tokens (E = 304 events, 609 tokens)."""
    from repro_torch.data import tokenize

    prompts, p = [], 0
    while len(prompts) < LM_REQUESTS:
        require(p < raw_db.n_patients, "too few Table 1 documents of 896 tokens")
        docs = tokenize.patient_documents(raw_db.slice_patients(p, p + 64))
        prompts += [d[:LM_PROMPT_LEN] for d in docs if len(d) >= LM_PROMPT_LEN]
        p += 64
    return prompts[:LM_REQUESTS]


def timed_engine(torch, eng, times: dict):
    """Wrap the engine's prefill and decode steps with host clocks ended by
    a synchronize; seconds go to ``times['prefill']`` / ``times['decode']``."""
    for name in ("prefill", "decode"):
        step = getattr(eng, f"_{name}")

        def timed(*a, _step=step, _name=name):
            t0 = time.perf_counter()
            r = _step(*a)
            torch.cuda.synchronize()
            times[_name].append(time.perf_counter() - t0)
            return r
        setattr(eng, f"_{name}", timed)
    return eng


def first_wave_logits(mdl, store: list):
    """``mdl`` whose ``apply`` keeps, in ``store``, the next-token logits
    ``[B, V]`` (float32) of each step of the first wave: its prefill, then
    each decode step."""
    waves = [0]

    def apply(params, batch, mode="train", caches=None):
        logits, caches = mdl.apply(params, batch, mode=mode, caches=caches)
        waves[0] += mode == "prefill"
        if waves[0] == 1:
            store.append(logits[:, -1].float())
        return logits, caches
    return mdl._replace(apply=apply)


def serve_on(torch, mdl, params, prompts, new_tokens: int, device, batch: int,
             max_len: int, timed: bool, logits: list | None = None) -> dict:
    """One ``ServeEngine.run`` over ``prompts`` with the launch counts set
    to 0 just before and read just after; ``logits``, when given, gets
    the first wave's logits (``first_wave_logits``)."""
    from repro_torch.serving.engine import Request, ServeEngine

    if logits is not None:
        mdl = first_wave_logits(mdl, logits)
    times = {"prefill": [], "decode": []}
    eng = ServeEngine(mdl, params, batch_size=batch, max_len=max_len, device=device)
    if timed:
        timed_engine(torch, eng, times)
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid, prompt, max_new_tokens=new_tokens))
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    for name in ("_prefill", "_decode"):     # the timed wrappers hold the engine
        vars(eng).pop(name, None)
    tokens = sum(len(r) for r in results.values())
    waves = len(times["prefill"])
    return {"results": results, "launches": launches, "wall_s": wall,
            "waves": waves, "tokens": tokens, "tokens_per_s": tokens / wall,
            "prefill_s_per_wave": times["prefill"],
            "decode_ms_per_step": (sum(times["decode"]) / len(times["decode"]) * 1e3
                                   if times["decode"] else None),
            "decode_steps": len(times["decode"]),
            "peak_device_bytes": torch.cuda.max_memory_allocated()}


def same_or_near_tie(torch, mdl, cpu_params, prompts, got: dict, want: dict) -> list:
    """Card tokens must equal the CPU's; a token may differ only where the
    CPU's top-1/top-2 logit margin (teacher-forced on the CPU's tokens) is
    under ``NEAR_TIE``.  Returns the near ties found."""
    ties = []
    for rid, w in want.items():
        g = got[rid]
        n = min(len(g), len(w))
        if len(g) == len(w) and (g == w).all():
            continue
        t = int(np.argmax(g[:n] != w[:n])) if (g[:n] != w[:n]).any() else n
        seq = np.concatenate([prompts[rid], w[:-1]])[None].astype(np.int32)
        logits, _ = mdl.apply(cpu_params, {"tokens": torch.from_numpy(seq)}, mode="train")
        top2 = torch.topk(logits[0, len(prompts[rid]) - 1 + t], 2).values
        margin = float(top2[0] - top2[1])
        require(margin < NEAR_TIE, f"request {rid}: token {t} differs on the card "
                                   f"at a margin of {margin}")
        ties.append({"rid": rid, "token": t, "margin": margin})
    return ties


def request_gaps(torch, got_logits: list, want_logits: list, got: dict,
                 want: dict) -> tuple:
    """The first wave's logits stacked ``[T, B, V]`` (slot ``i`` holding
    request ``i``) and, per request, ``|got - want|`` over its compared
    steps: up to and including the step whose token first differs between
    the two runs (after it the two runs decode other inputs)."""
    G = torch.stack([t.cpu() for t in got_logits])
    W = torch.stack([t.cpu() for t in want_logits])
    T = min(len(G), len(W))
    gaps = {}
    for i, w in want.items():
        g = got[i]
        n = min(len(g), len(w), T)
        differs = np.nonzero(g[:n] != w[:n])[0]
        last = int(differs[0]) + 1 if len(differs) else n
        gaps[i] = (G[:last, i] - W[:last, i]).abs()
    return G, W, gaps


def logit_diff(torch, got_logits: list, want_logits: list, got: dict,
               want: dict) -> float:
    """Largest |got - want| of the first wave's logits (``request_gaps``)."""
    gaps = request_gaps(torch, got_logits, want_logits, got, want)[2]
    return max([0.0] + [gap.max().item() for gap in gaps.values()])


def logit_gap_report(torch, mdl, params, first, dev, card_logits, cpu_logits,
                     card_results, cpu_results) -> dict:
    """What a failed logit check reports besides the gap: where the largest
    gap lies (step, request, token id, the card's and the CPU's logit),
    each step's largest gap, whether a second card run of the first wave
    repeats the first bit for bit, and ``host_facts``."""
    G, W, gaps = request_gaps(torch, card_logits, cpu_logits, card_results, cpu_results)
    i = max(gaps, key=lambda r: gaps[r].max().item())
    step, tok = divmod(int(gaps[i].argmax()), gaps[i].shape[1])
    T = min(len(G), len(W))
    again = []
    serve_on(torch, mdl, params, first, LM_NEW_TOKENS, dev, LM_BATCH, LM_MAX_LEN,
             timed=False, logits=again)
    A = torch.stack([t.cpu() for t in again])
    return {"largest": {"step": step, "request": i, "token": tok,
                        "card": G[step, i, tok].item(), "cpu": W[step, i, tok].item()},
            "step_gaps": [float(f"{x:.3g}") for x in
                          (G[:T] - W[:T]).abs().amax(dim=(1, 2)).tolist()],
            "second_card_run_equal": A.shape == G.shape and torch.equal(A, G),
            "second_card_run_gap": ((A - G).abs().max().item()
                                    if A.shape == G.shape else None),
            "host": host_facts(torch)}


def half_split_rope(torch, apply_rope):
    """A planted fault: ``apply_rope`` on half-split pairs (x[i],
    x[i + rot/2]), PyTorch's habit, where the reference rotates the
    interleaved pairs (x[2i], x[2i + 1])."""
    def faulty(x, cos, sin, fraction=1.0):
        rot = int(x.shape[-1] * fraction) // 2 * 2
        pairs = torch.arange(rot, device=x.device).view(2, -1).t().reshape(-1)
        perm = torch.cat([pairs, torch.arange(rot, x.shape[-1], device=x.device)])
        return apply_rope(x[..., perm], cos, sin, fraction)[..., torch.argsort(perm)]
    return faulty


def logit_controls(torch, cfg, mdl, params, first, cpu_logits, cpu_results,
                   dev) -> dict:
    """Two planted deviations served on the card over the first wave, each
    held to the CPU run's logits like the sound run: the same weights in
    bfloat16, and RoPE on half-split pairs.  Each must break
    ``LM_LOGIT_TOL``, else the logit check could not tell them from a
    sound run."""
    import copy
    import dataclasses

    from repro_torch.models import layers, model as model_lib

    def reading(m, p) -> float:
        store = []
        r = serve_on(torch, m, p, first, LM_NEW_TOKENS, dev, LM_BATCH, LM_MAX_LEN,
                     timed=False, logits=store)
        return logit_diff(torch, store, cpu_logits, r["results"], cpu_results)

    out = {"bfloat16": reading(model_lib.build(dataclasses.replace(cfg, dtype="bfloat16")),
                               copy.deepcopy(params).to(torch.bfloat16))}
    apply_rope = layers.apply_rope
    layers.apply_rope = half_split_rope(torch, apply_rope)
    try:
        out["half_split_rope"] = reading(mdl, params)
    finally:
        layers.apply_rope = apply_rope
    require(min(out.values()) > LM_LOGIT_TOL,
            f"a planted deviation stays within the logit limit {LM_LOGIT_TOL}: {out}")
    return out


def check_lm_serving(torch, raw_db, dev) -> tuple[dict, dict]:
    """Phase 9: LM serving on the card.  tspm-mlho at full size (seeded
    init) serves 16 Table 1 prompts of 896 tokens, 64 new tokens each, in
    two waves of 8, flash launches = 12 layers x waves; the first wave
    equals the CPU's (plain versions, the same weights) under the near-tie
    rule, and so do its logits within ``LM_LOGIT_TOL`` (``logit_controls``
    shows the limit catches planted deviations).  Then gemma2-2b at full size (26 layers, bf16) serves 2 random
    prompts of 8,192 tokens, and the kernel is held against the plain
    version on the q/k/v of its first local and first global layer."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import attention, model as model_lib

    t_phase = time.perf_counter()
    out, timing = {}, {}
    cfg = get_config("tspm-mlho")
    mdl = model_lib.build(cfg)
    params = mdl.init(torch.Generator(dev).manual_seed(SEED))
    prompts = lm_prompts(raw_db)
    card_logits = []
    r = serve_on(torch, mdl, params, prompts, LM_NEW_TOKENS, dev, LM_BATCH,
                 LM_MAX_LEN, timed=True, logits=card_logits)
    tf32_launches = r["launches"]["flash_attention.tf32x3"]
    require(r["waves"] == 2 and r["launches"]["flash_attention"]
            == cfg.n_layers * r["waves"] == tf32_launches,
            f"tspm-mlho: {r['launches']} flash launches in {r['waves']} waves, "
            f"all on the tf32x3 route")
    ffma_launches = r["launches"]["flash_attention.ffma"]
    require(all(v == 0 for n, v in r["launches"].items()
                if not n.startswith("flash_attention") or n == "flash_attention_bwd"),
            f"serving launched a mining kernel or the backward: {r['launches']}")
    require(sorted(r["results"]) == list(range(LM_REQUESTS)), "tspm-mlho: lost requests")
    t0 = time.perf_counter()
    cpu_params = copy.deepcopy(params).to("cpu")
    first = prompts[:LM_BATCH]
    cpu_logits = []
    cpu = serve_on(torch, mdl, cpu_params, first, LM_NEW_TOKENS, "cpu", LM_BATCH,
                   LM_MAX_LEN, timed=False, logits=cpu_logits)
    ties = same_or_near_tie(torch, mdl, cpu_params, first, r["results"], cpu["results"])
    cpu_s = time.perf_counter() - t0
    first_results = {i: r["results"][i] for i in range(LM_BATCH)}
    logits_err = logit_diff(torch, card_logits, cpu_logits, first_results,
                            cpu["results"])
    controls = logit_controls(torch, cfg, mdl, params, first, cpu_logits,
                              cpu["results"], dev)
    if not (len(card_logits) == len(cpu_logits) > 1 and logits_err <= LM_LOGIT_TOL):
        report = logit_gap_report(torch, mdl, params, first, dev, card_logits,
                                  cpu_logits, first_results, cpu["results"])
        require(False, f"tspm-mlho: the card's first-wave logits differ from the "
                       f"CPU's by {logits_err} over {len(card_logits)}/"
                       f"{len(cpu_logits)} steps (limit {LM_LOGIT_TOL}); "
                       f"{json.dumps(report)}")
    out["tspm_mlho"] = {k: r[k] for k in ("launches", "wall_s", "waves", "tokens",
                                          "tokens_per_s", "prefill_s_per_wave",
                                          "decode_ms_per_step", "decode_steps",
                                          "peak_device_bytes")}
    out["tspm_mlho"].update(prompt_len=LM_PROMPT_LEN, requests=LM_REQUESTS,
                            batch=LM_BATCH, params=model_lib.param_count(params),
                            cpu_first_wave_s=cpu_s, near_ties=ties,
                            logits_max_diff=logits_err, logit_limit=LM_LOGIT_TOL,
                            logit_steps=len(card_logits),
                            max_abs_logit=max(t.abs().max().item() for t in cpu_logits),
                            planted_logit_diffs=controls,
                            distinct_first_wave_tokens=len(np.unique(np.concatenate(
                                list(first_results.values())))),
                            first_tokens=r["results"][0][:8].tolist())
    print(f"phase 9 (tspm-mlho): {json.dumps(out['tspm_mlho'])}", flush=True)
    B, S = LM_BATCH, LM_PROMPT_LEN
    gen = torch.Generator(dev).manual_seed(1)
    q = torch.randn(B, cfg.n_heads, S, cfg.hd, generator=gen, device=dev)
    k, v = (torch.randn(B, cfg.n_kv_heads, S, cfg.hd, generator=gen, device=dev)
            for _ in range(2))
    timing["tspm_mlho"] = time_flash(torch, q, k, v, causal=True, window=None,
                                     softcap=None, sdpa=True, beside="ffma")
    print(f"phase 9 (tspm_mlho attention): {json.dumps(timing['tspm_mlho'])}", flush=True)
    del params, cpu_params, q, k, v, r, cpu, card_logits, cpu_logits
    torch.cuda.empty_cache()

    gcfg = get_config("gemma2-2b")
    gmdl = model_lib.build(gcfg)
    gparams = gmdl.init(torch.Generator(dev).manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    gprompts = [rng.integers(4, gcfg.vocab_size, GEMMA_PROMPT_LEN).astype(np.int32)
                for _ in range(GEMMA_REQUESTS)]
    captured = []
    full_attention = attention.full_attention

    def capture(q, k, v, cfg, **kw):
        if len(captured) < 2:                # layer 0 is local, layer 1 global
            captured.append((q, k, v, kw["window"]))
        return full_attention(q, k, v, cfg, **kw)

    attention.full_attention = capture
    try:
        g = serve_on(torch, gmdl, gparams, gprompts, GEMMA_NEW_TOKENS, dev,
                     GEMMA_REQUESTS, GEMMA_PROMPT_LEN + GEMMA_NEW_TOKENS, timed=True)
    finally:
        attention.full_attention = full_attention
    wgmma_launches = g["launches"]["flash_attention.wgmma"]
    require(g["launches"]["flash_attention"] == gcfg.n_layers * g["waves"] == gcfg.n_layers
            == wgmma_launches,
            f"gemma2-2b: {g['launches']} flash launches, all on the wgmma route")
    require(g["launches"]["flash_attention_bwd"] == 0, "gemma2-2b: serving ran a backward")
    ffma_launches += g["launches"]["flash_attention.ffma"]
    require(all(len(t) == GEMMA_NEW_TOKENS or t[-1] == 2 for t in g["results"].values()),
            "gemma2-2b: short outputs")
    out["gemma2_2b"] = {k: g[k] for k in ("launches", "wall_s", "waves", "tokens",
                                          "tokens_per_s", "prefill_s_per_wave",
                                          "decode_ms_per_step", "decode_steps",
                                          "peak_device_bytes")}
    out["gemma2_2b"].update(prompt_len=GEMMA_PROMPT_LEN, requests=GEMMA_REQUESTS,
                            params=model_lib.param_count(gparams))
    print(f"phase 9 (gemma2-2b): {json.dumps(out['gemma2_2b'])}", flush=True)
    del gparams, g
    torch.cuda.empty_cache()
    require([c[3] for c in captured] == [gcfg.sliding_window, None],
            "gemma2-2b: the first two layers are not local, global")
    for name, (q, k, v, window) in zip(("gemma2_local", "gemma2_global"), captured):
        timing[name] = time_flash(torch, *(t.transpose(1, 2) for t in (q, k, v)),
                                  causal=True, window=window,
                                  softcap=gcfg.attn_softcap, sdpa=False)
        print(f"phase 9 ({name} layer): {json.dumps(timing[name])}", flush=True)
    del captured
    torch.cuda.empty_cache()
    out["allocated_after_bytes"] = torch.cuda.memory_allocated()
    out["phase_s"] = time.perf_counter() - t_phase
    out["flash_launches"] = {"tf32x3": tf32_launches, "wgmma": wgmma_launches,
                             "ffma": ffma_launches}
    return out, timing


# ---- phase 9 (d)-(f): the MoE and VLM families ------------------------------

MOE_CHECK_LAYERS = 2           # (d): deepseek-moe-16b's full widths at 2 layers
MOE_CHECK_BATCH, MOE_CHECK_PROMPT, MOE_CHECK_DECODE = 2, 128, 8
# (d): a routing may differ between the card and the CPU only where the
# CPU's k-th against (k+1)-th probability margin is below this
MOE_NEAR_TIE = 1e-5
# (d): max |card - CPU| of the float32 logits of the requests whose routing
# agreed in every layer (prefill and each decode step; sound runs on an
# H100 read 2.7e-6), and of the MoE layer alone (atol = rtol,
# tests/test_moe_ssm.py's 2e-4)
MOE_LOGIT_TOL = 1e-4
MOE_LAYER_TOL = 2e-4
DEEPSEEK_BATCH, DEEPSEEK_MAX_LEN = 4, 640                   # (e)
DEEPSEEK_PROMPT_LEN, DEEPSEEK_NEW_TOKENS, DEEPSEEK_REQUESTS = 512, 16, 8
UNBOUNDED_CAPACITY = 16.0      # capacity_factor at which no assignment drops
CONSIST_BATCH, CONSIST_PROMPT, CONSIST_DECODE = 2, 120, 8   # (e)'s consistency check
PIXTRAL_REQUESTS, PIXTRAL_TEXT, PIXTRAL_DECODE = 2, 64, 8   # (f)
# (e), (f): prefill + decode logits against the train-mode forward's at the
# same positions.  (e) holds deepseek-moe-16b's weights made float32 to
# tests/test_archs_smoke.py's 2e-3 (atol = rtol) on the requests whose
# routing agreed on both paths: in bfloat16 the two paths' roundings flip
# experts at margins up to ~2e-2 in every request (on an H100: 182 of
# 7,168 token-layers, a relative RMS of 0.109, 89% equal argmaxes), so
# bfloat16 is read, not held.  (f) (dense) holds pixtral-12b's bfloat16
# logits to a largest relative RMS of a row, |got - want|_2 / |want|_2, of
# BF16_CONSIST_REL (0.0188 read on an H100); the rows held to the
# positions one later (a planted off-by-one) must break it
CONSIST_TOL = 2e-3
BF16_CONSIST_REL = 0.05
PHASE9_MEMORY_SLACK = 1 << 30  # allocated after (d)-(f) within this of before


class RouteLog:
    """While entered, ``models.moe.route`` also records each call: its
    ``Routing`` (``full``), or its token count and the number of its
    dropped assignments (a device scalar, read after the run), for the
    first ``first`` calls."""

    def __init__(self, full: bool = True, first: int | None = None):
        self.full, self.first, self.calls = full, first, []

    def __enter__(self):
        from repro_torch.models import moe

        self._moe, self._route = moe, moe.route

        def route(p, xf, cfg):
            r = self._route(p, xf, cfg)
            if self.first is None or len(self.calls) < self.first:
                self.calls.append(r if self.full else (xf.shape[0], (~r.keep).sum()))
            return r
        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


def per_assignment(torch, r, name: str):
    """``r.keep`` / ``r.slot`` (sorted-assignment order) as ``[n, k]`` in
    the order of ``r.eid``."""
    v = getattr(r, name).cpu()
    out = torch.empty_like(v)
    out[r.order.cpu()] = v
    return out.view(r.eid.shape)


def top_k_margin(r):
    """Each token's k-th against (k+1)-th probability margin (CPU)."""
    k = r.eid.shape[1]
    top = r.probs.sort(dim=-1, descending=True).values.cpu()
    return top[:, k - 1] - top[:, k]


def routing_agreement(torch, card: list, cpu: list, seq_lens: list) -> dict:
    """Card against CPU routings of the same calls, layer by layer: ``eid``,
    ``keep`` and ``slot`` byte-equal, except where the CPU's k-th against
    (k+1)-th probability margin is below ``MOE_NEAR_TIE`` (any other
    difference raises).  A token whose ``eid`` differs shifts later ranks
    in its expert, so its call's other differences are then allowed too.
    Returns the requests (a call's token ``t`` belongs to request ``t //
    seq_len``) with any difference, the smallest margin seen and the
    differing tokens."""
    require(len(card) == len(cpu) == len(seq_lens),
            f"{len(card)} card / {len(cpu)} CPU routings for {len(seq_lens)} calls")
    bad, flips, min_margin = set(), 0, float("inf")
    for g, w, S in zip(card, cpu, seq_lens):
        margin = top_k_margin(w)
        min_margin = min(min_margin, margin.min().item())
        flipped = (g.eid.cpu() != w.eid).any(-1)
        worst = margin[flipped].max().item() if flipped.any() else None
        require(worst is None or worst < MOE_NEAR_TIE,
                f"a routing differs at a margin of {worst}")
        other = ((per_assignment(torch, g, "keep") != per_assignment(torch, w, "keep"))
                 | (per_assignment(torch, g, "slot") != per_assignment(torch, w, "slot"))
                 ).any(-1)
        require(bool(flipped.any()) or not bool(other.any()),
                "keep or slot differ with every expert id equal")
        flips += int(flipped.sum())
        bad |= {t // S for t in torch.nonzero(flipped | other).flatten().tolist()}
    return {"differing_requests": sorted(bad), "flipped_tokens": flips,
            "min_margin": min_margin}


def prefill_decode(torch, mdl, params, tokens, n_prompt: int, n_decode: int, device,
                   patches=None, max_len: int | None = None) -> dict:
    """A prefill on ``tokens[:, :n_prompt]`` (after ``patches``), then
    ``n_decode`` decode steps fed ``tokens[:, n_prompt + j]``: the
    next-token logits ``[B, 1 + n_decode, V]`` (float32), the prefill's
    seconds and flash launches (counts zeroed just before it) and each
    decode step's ms (host clocks ended by a synchronize on the card)."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    B = tokens.shape[0]
    off = 0 if patches is None else patches.shape[1]
    caches = mdl.init_caches(B, max_len or off + n_prompt + n_decode, device=device)
    batch = {"tokens": tokens[:, :n_prompt]}
    if patches is not None:
        batch["patch_embeds"] = patches
    sync()
    zero_launches()
    t0 = time.perf_counter()
    logits, caches = mdl.apply(params, batch, mode="prefill", caches=caches)
    sync()
    prefill_s = time.perf_counter() - t0
    launches = read_launches()
    out, decode_ms = [logits[:, -1].float()], []
    for j in range(n_decode):
        t0 = time.perf_counter()
        logits, caches = mdl.apply(params, {"tokens": tokens[:, n_prompt + j:n_prompt + j + 1]},
                                   mode="decode", caches=caches)
        sync()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(logits[:, 0].float())
    del caches
    return {"logits": torch.stack(out, 1), "prefill_s": prefill_s,
            "prefill_launches": launches, "decode_ms": decode_ms}


def path_routing(torch, cache_calls: list, train_calls: list, n_moe: int, B: int,
                 P: int, T: int) -> dict:
    """The prefill + decode path's routing against the train-mode
    forward's, token by token (request b, position p, MoE layer l):
    ``eid`` equal, else a flip, with the train path's k-th against (k+1)-th
    probability margin there.  The cache path's calls are the prefill's
    ``n_moe`` layers, then ``n_moe`` a decode step."""
    k = train_calls[0].eid.shape[1]
    flips, bad, worst = 0, set(), 0.0
    for layer in range(n_moe):
        tr = train_calls[layer]
        want = tr.eid.view(B, P + T, k).cpu()
        margin = top_k_margin(tr).view(B, P + T)
        got = torch.cat([cache_calls[layer].eid.view(B, P, k)] + [
            cache_calls[n_moe * (1 + j) + layer].eid.view(B, 1, k) for j in range(T)],
            dim=1).cpu()
        diff = (got != want).any(-1)
        flips += int(diff.sum())
        bad |= set(torch.nonzero(diff.any(-1)).flatten().tolist())
        if diff.any():
            worst = max(worst, margin[diff].max().item())
    return {"differing_requests": sorted(bad), "flipped_token_layers": flips,
            "token_layers": n_moe * B * (P + T), "largest_flip_margin": worst}


def consistency(torch, mdl, params, tokens, n_prompt: int, n_decode: int, dev,
                patches=None, n_moe: int = 0) -> dict:
    """The reference's prefill/decode check (tests/test_archs_smoke.py)
    on the card: prefill + decode logits against the train-mode forward's
    at the same positions (offset by the patches).  Reads the largest
    relative RMS of a row, |got - want|_2 / |want|_2, beside the same rows
    held to the positions one later (a planted off-by-one), and, with
    ``n_moe`` MoE layers, the two paths' routing (``path_routing``) and
    the elements beyond ``CONSIST_TOL`` on the requests whose routing
    agreed."""
    with RouteLog() as cache_log:
        r = prefill_decode(torch, mdl, params, tokens, n_prompt, n_decode, dev, patches)
    batch = {"tokens": tokens[:, :n_prompt + n_decode]}
    if patches is not None:
        batch["patch_embeds"] = patches
    with RouteLog() as train_log, torch.no_grad():
        full, _ = mdl.apply(params, batch, mode="train")
    a = (0 if patches is None else patches.shape[1]) + n_prompt - 1
    want = full[:, a:a + n_decode + 1].float()
    later = full[:, a + 1:a + n_decode + 1].float()
    del full
    got = r["logits"]

    def rel(g, w):
        return ((g - w).norm(dim=-1) / w.norm(dim=-1)).max().item()

    out = {"dtype": str(params.embed.table.dtype).removeprefix("torch."),
           "rows": got.shape[0] * got.shape[1], "rel_rms": rel(got, want),
           "max_abs_diff": (got - want).abs().max().item(),
           "max_abs_want": want.abs().max().item(),
           "argmax_equal": (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
           "off_by_one_rel_rms": rel(got[:, :-1], later),
           "prefill_s": r["prefill_s"], "decode_ms": r["decode_ms"],
           "prefill_launches": {k: n for k, n in r["prefill_launches"].items()
                                if k.startswith("flash_attention")}}
    kept = list(range(got.shape[0]))
    if n_moe:
        out["routing"] = path_routing(torch, cache_log.calls, train_log.calls, n_moe,
                                      tokens.shape[0], n_prompt, n_decode)
        kept = [b for b in kept if b not in out["routing"]["differing_requests"]]
    g, w = got[kept], want[kept]
    out.update(compared_requests=kept, limit=CONSIST_TOL,
               beyond_limit=int(((g - w).abs() > CONSIST_TOL + CONSIST_TOL * w.abs()).sum()))
    return out


def to_float32_(torch, module) -> None:
    """``module``'s parameters made float32 in place, one at a time, each
    old tensor's memory given back before the next (a model too large to
    hold in both dtypes at once)."""
    with torch.no_grad():
        for p in module.parameters():
            p.data = p.data.float()
            torch.cuda.empty_cache()


def check_moe_card_vs_cpu(torch, dev) -> dict:
    """Phase 9 (d): deepseek-moe-16b's full widths cut to 2 layers, in
    float32, initialised on the card and copied to the CPU: one prefill of
    2 x 128 seeded tokens and 8 decode steps on each device; every layer's
    routing compared first (``routing_agreement``), then the logits of the
    requests whose routing agreed in every call, and the first MoE layer
    alone on one input."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib, moe

    cfg = get_config("deepseek-moe-16b").replace(n_layers=MOE_CHECK_LAYERS,
                                                 dtype="float32")
    mdl = model_lib.build(cfg)
    params = mdl.init(torch.Generator(dev).manual_seed(SEED))
    cpu_params = copy.deepcopy(params).to("cpu")
    rng = np.random.default_rng(SEED)
    B, P, T = MOE_CHECK_BATCH, MOE_CHECK_PROMPT, MOE_CHECK_DECODE
    tokens = rng.integers(4, cfg.vocab_size, (B, P + T)).astype(np.int32)
    runs, logs = {}, {}
    for name, p, device in (("card", params, dev), ("cpu", cpu_params, "cpu")):
        t0 = time.perf_counter()
        with RouteLog() as log:
            runs[name] = prefill_decode(torch, mdl, p, torch.from_numpy(tokens).to(device),
                                        P, T, device)
        runs[name]["s"] = time.perf_counter() - t0
        logs[name] = log.calls
    launches = runs["card"]["prefill_launches"]
    require(launches["flash_attention"] == cfg.n_layers == launches["flash_attention.ffma"],
            f"(d): {launches}")
    seq_lens = [P] * cfg.n_layers + [1] * (cfg.n_layers * T)
    agree = routing_agreement(torch, logs["card"], logs["cpu"], seq_lens)
    kept = [b for b in range(B) if b not in agree["differing_requests"]]
    require(len(kept) >= 1, f"(d): no request's routing agreed in every layer: {agree}")
    g, w = runs["card"]["logits"].cpu()[kept], runs["cpu"]["logits"][kept]
    logits_err = (g - w).abs().max().item()
    dropped = [int((~r.keep).sum()) for r in logs["cpu"][:cfg.n_layers]]
    del logs
    # the first MoE layer alone on one input
    x = torch.from_numpy(rng.standard_normal((B, P, cfg.d_model)).astype(np.float32))
    layer = {}
    for name, p, device in (("card", params, dev), ("cpu", cpu_params, "cpu")):
        with RouteLog() as log, torch.no_grad():
            y, aux = moe.apply(p.blocks[0].ffn, x.to(device), cfg)
        layer[name] = (y.cpu(), float(aux), log.calls)
    alone = routing_agreement(torch, layer["card"][2], layer["cpu"][2], [P])
    same = [b for b in range(B) if b not in alone["differing_requests"]]
    require(len(same) >= 1, f"(d): the MoE layer's routing agreed on no request: {alone}")
    yg, yw = layer["card"][0][same], layer["cpu"][0][same]
    layer_bad = ((yg - yw).abs() > MOE_LAYER_TOL + MOE_LAYER_TOL * yw.abs()).sum().item()
    out = {"layers": cfg.n_layers, "d_model": cfg.d_model, "experts": cfg.n_experts,
           "top_k": cfg.experts_per_token, "shared": cfg.n_shared_experts,
           "params": model_lib.param_count(params), "batch": B, "prompt": P,
           "decode_steps": T, "launches": {k: launches[k] for k in (
               "flash_attention", "flash_attention.ffma")},
           "routing": agree, "compared_requests": kept, "logits_max_diff": logits_err,
           "logit_limit": MOE_LOGIT_TOL,
           "max_abs_logit": w.abs().max().item(), "prefill_dropped_by_layer": dropped,
           "card_s": runs["card"]["s"], "cpu_s": runs["cpu"]["s"],
           "layer_alone": {"routing": alone, "compared_requests": same,
                           "max_diff": (yg - yw).abs().max().item(), "beyond_limit": layer_bad,
                           "aux_card": layer["card"][1], "aux_cpu": layer["cpu"][1]}}
    print(f"phase 9 (d, deepseek-moe-16b widths at {cfg.n_layers} layers, card vs CPU): "
          f"{json.dumps(out)}", flush=True)
    require(logits_err <= MOE_LOGIT_TOL, f"(d): the logits differ by {logits_err}")
    require(layer_bad == 0 and abs(layer["card"][1] - layer["cpu"][1])
            <= 1e-6 * abs(layer["cpu"][1]), "(d): the MoE layer alone differs from the CPU's")
    del params, cpu_params, runs, layer
    return out


def check_deepseek(torch, dev) -> tuple[dict, dict]:
    """Phase 9 (e): deepseek-moe-16b at full size (28 layers, bfloat16,
    seeded init on the card) serves 8 seeded prompts of 512 tokens, 16 new
    tokens each, through ``ServeEngine(batch_size=4, max_len=640)``: two
    waves, 56 ``flash_attention`` launches all on wgmma and no backward,
    with the first prefill's dropped assignments at the config's capacity
    factor; then the consistency check at ``capacity_factor=16``, read in
    bfloat16 and held with the weights made float32 in place; and
    ``flash_attention`` timed at its prefill shape."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    cfg = get_config("deepseek-moe-16b")
    mdl = model_lib.build(cfg)
    t0 = time.perf_counter()
    params = mdl.init(torch.Generator(dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(4, cfg.vocab_size, DEEPSEEK_PROMPT_LEN).astype(np.int32)
               for _ in range(DEEPSEEK_REQUESTS)]
    with RouteLog(full=False, first=cfg.n_layers) as log:
        r = serve_on(torch, mdl, params, prompts, DEEPSEEK_NEW_TOKENS, dev, DEEPSEEK_BATCH,
                     DEEPSEEK_MAX_LEN, timed=True)
    n = DEEPSEEK_BATCH * DEEPSEEK_PROMPT_LEN
    require([c[0] for c in log.calls] == [n] * cfg.n_layers,
            f"(e): the first prefill's MoE calls took {[c[0] for c in log.calls]} tokens")
    dropped = [int(c[1]) for c in log.calls]
    launches = r["launches"]
    require(r["waves"] == 2 and launches["flash_attention"] == cfg.n_layers * 2
            == launches["flash_attention.wgmma"] and launches["flash_attention_bwd"] == 0,
            f"(e): {launches} in {r['waves']} waves")
    require(sorted(r["results"]) == list(range(DEEPSEEK_REQUESTS))
            and all(len(t) == DEEPSEEK_NEW_TOKENS or t[-1] == 2 for t in r["results"].values()),
            "(e): lost or short requests")
    out = {k: r[k] for k in ("launches", "wall_s", "waves", "tokens", "tokens_per_s",
                             "prefill_s_per_wave", "decode_ms_per_step", "decode_steps",
                             "peak_device_bytes")}
    from repro_torch.models import moe
    c = moe._capacity(n, cfg)
    out.update(params=model_lib.param_count(params), init_s=init_s,
               prompt_len=DEEPSEEK_PROMPT_LEN, requests=DEEPSEEK_REQUESTS,
               batch=DEEPSEEK_BATCH, capacity=c, capacity_factor=cfg.capacity_factor,
               first_prefill_dropped=sum(dropped), first_prefill_dropped_by_layer=dropped,
               assignments_per_layer=n * cfg.experts_per_token,
               expert_bytes_per_step=sum(int(t.numel()) * t.element_size()
                                         for name, t in params.named_parameters()
                                         if ".ffn.w_" in name),
               first_tokens=r["results"][0][:8].tolist())
    print(f"phase 9 (e, deepseek-moe-16b): {json.dumps(out)}", flush=True)
    del r
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    tokens = torch.randint(4, cfg.vocab_size, (CONSIST_BATCH, CONSIST_PROMPT + CONSIST_DECODE),
                           generator=gen, device=dev)
    unbounded = model_lib.build(cfg.replace(capacity_factor=UNBOUNDED_CAPACITY))
    args = (tokens, CONSIST_PROMPT, CONSIST_DECODE, dev)
    out["consistency_bf16"] = consistency(torch, unbounded, params, *args, n_moe=cfg.n_layers)
    print(f"phase 9 (e, bfloat16 consistency at capacity_factor={UNBOUNDED_CAPACITY}, read): "
          f"{json.dumps(out['consistency_bf16'])}", flush=True)
    to_float32_(torch, params)
    unbounded = model_lib.build(unbounded.cfg.replace(dtype="float32"))   # float32 caches
    c = out["consistency"] = consistency(torch, unbounded, params, *args, n_moe=cfg.n_layers)
    print(f"phase 9 (e, float32 consistency at capacity_factor={UNBOUNDED_CAPACITY}): "
          f"{json.dumps(c)}", flush=True)
    require(c["compared_requests"] and c["beyond_limit"] == 0
            and c["routing"]["largest_flip_margin"] < MOE_NEAR_TIE
            and c["off_by_one_rel_rms"] > BF16_CONSIST_REL,
            "(e): prefill + decode logits differ from the train-mode forward's")
    del params
    torch.cuda.empty_cache()
    B, S = DEEPSEEK_BATCH, DEEPSEEK_PROMPT_LEN
    q, k, v = (torch.randn(B, cfg.n_heads, S, cfg.hd, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    timing = time_flash(torch, q, k, v, causal=True, window=None, softcap=None, sdpa=True)
    print(f"phase 9 (deepseek-moe-16b attention): {json.dumps(timing)}", flush=True)
    return out, timing


def check_pixtral(torch, dev) -> tuple[dict, dict]:
    """Phase 9 (f): pixtral-12b at full size (40 layers, bfloat16): 2
    requests of 1,024 seeded patch embeddings and 64 seeded tokens through
    ``model.apply`` prefill (40 ``flash_attention`` launches, all wgmma, at
    GQA 32/8), then 8 decode steps, held to the train-mode forward at
    offset ``n_patches`` within ``BF16_CONSIST_REL`` (``consistency``);
    ``flash_attention`` timed at its prefill shape."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    cfg = get_config("pixtral-12b")
    mdl = model_lib.build(cfg)
    t0 = time.perf_counter()
    params = mdl.init(torch.Generator(dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    patches = torch.randn(PIXTRAL_REQUESTS, cfg.n_patches, cfg.frontend_dim, generator=gen,
                          device=dev)
    tokens = torch.randint(4, cfg.vocab_size, (PIXTRAL_REQUESTS, PIXTRAL_TEXT + PIXTRAL_DECODE),
                           generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats()
    c = consistency(torch, mdl, params, tokens, PIXTRAL_TEXT, PIXTRAL_DECODE, dev, patches)
    require(c["rel_rms"] <= BF16_CONSIST_REL < c["off_by_one_rel_rms"],
            f"(f): prefill + decode logits against the train-mode forward: {json.dumps(c)}")
    launches = c["prefill_launches"]
    require(launches["flash_attention"] == cfg.n_layers == launches["flash_attention.wgmma"]
            and launches["flash_attention_bwd"] == 0, f"(f): {launches}")
    S = cfg.n_patches + PIXTRAL_TEXT
    out = {"params": model_lib.param_count(params), "init_s": init_s,
           "requests": PIXTRAL_REQUESTS, "patches": cfg.n_patches, "text": PIXTRAL_TEXT,
           "prefill_tokens": PIXTRAL_REQUESTS * S, "prefill_s": c["prefill_s"],
           "decode_ms_per_step": sum(c["decode_ms"]) / len(c["decode_ms"]),
           "launches": {k: launches[k] for k in ("flash_attention", "flash_attention.wgmma",
                                                 "flash_attention_bwd")},
           "peak_device_bytes": torch.cuda.max_memory_allocated(), "consistency": c}
    print(f"phase 9 (f, pixtral-12b): {json.dumps(out)}", flush=True)
    del params, patches
    torch.cuda.empty_cache()
    q = torch.randn(PIXTRAL_REQUESTS, cfg.n_heads, S, cfg.hd, generator=gen,
                    device=dev).to(torch.bfloat16)
    k, v = (torch.randn(PIXTRAL_REQUESTS, cfg.n_kv_heads, S, cfg.hd, generator=gen,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    timing = time_flash(torch, q, k, v, causal=True, window=None, softcap=None, sdpa=True)
    print(f"phase 9 (pixtral-12b attention): {json.dumps(timing)}", flush=True)
    return out, timing


def check_moe_vlm(torch, dev) -> tuple[dict, dict]:
    """Phase 9 (d), (e), (f), each model freed before the next; allocated
    device memory after them within ``PHASE9_MEMORY_SLACK`` of before."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out, timing = {"d_card_vs_cpu": check_moe_card_vs_cpu(torch, dev)}, {}
    gc.collect()
    torch.cuda.empty_cache()
    out["e_deepseek"], timing["deepseek"] = check_deepseek(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    out["f_pixtral"], timing["pixtral"] = check_pixtral(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    out.update(allocated_before_bytes=before, allocated_after_bytes=after,
               phase_s=time.perf_counter() - t0)
    require(after - before <= PHASE9_MEMORY_SLACK,
            f"(d)-(f) left {after - before} B allocated")
    return out, timing


# ---- phase 9 (g)-(i): the xLSTM and hybrid (Zamba2) families -----------------

RECUR_CHECK_LAYERS = 6         # (g): zamba2-2.7b's first group, xlstm-125m's 5 mLSTM + 1 sLSTM
RECUR_CHECK_BATCH, RECUR_CHECK_PROMPT, RECUR_CHECK_DECODE = 1, 256, 8
# (g): max |card - CPU| of the float32 logits over the CPU's largest
# |logit| (prefill and each decode step): sound runs on an H100 read
# 5.8e-7 (zamba2-2.7b) and 8.0e-7 (xlstm-125m), ~150x under it
RECUR_LOGIT_REL = 1e-4
ZAMBA_BATCH, ZAMBA_MAX_LEN = 2, 4128                         # (h)
ZAMBA_PROMPT_LEN, ZAMBA_NEW_TOKENS, ZAMBA_REQUESTS = 4096, 32, 2
XLSTM_BATCH, XLSTM_MAX_LEN = 4, 2080                         # (i)
XLSTM_PROMPT_LEN, XLSTM_NEW_TOKENS, XLSTM_REQUESTS = 2048, 32, 4
# (h), (i): the consistency check's requests and prompt, shorter than the
# served prompts, and its decode steps: the prompt and the prompt plus the
# steps are multiples of ssm_chunk (128), so the prefill and the train-mode
# forward both scan in chunks of 128.  With 8 steps the train-mode forward
# takes one chunk of S (the reference's rule for S no multiple of the
# chunk): its float32 cumulative log-decays reach ~700 at 1,032 tokens
# (~0.69 a token) and lose ~700 x 2^-24 = 4e-5 in each exponent, which
# put zamba2-2.7b's float32 logits past 2e-3 + 2e-3 |want| on an H100; in
# chunks of 128 they stay under ~90
RECUR_CONSIST = {"zamba2-2.7b": (1, 1024), "xlstm-125m": (2, 512)}
RECUR_CONSIST_DECODE = 128


class WidthLog:
    """While entered, each ``flash_attention`` launch also records its head
    width (the forward's ``ops._launch``)."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops

        self._ops, self._launch, self.widths = ops, ops._launch, []

        def launch(q, *a, **kw):
            self.widths.append(int(q.shape[3]))
            return self._launch(q, *a, **kw)
        ops._launch = launch
        return self

    def __exit__(self, *exc):
        self._ops._launch = self._launch


def check_recurrent_card_vs_cpu(torch, dev) -> dict:
    """Phase 9 (g): zamba2-2.7b's and xlstm-125m's full widths cut to 6
    layers (zamba2: one group of 6 Mamba2 layers and one shared attention
    invocation at D 160, on the ffma route in float32; xlstm: 5 mLSTM and 1
    sLSTM), in float32, initialised on the card and copied to the CPU: one
    prefill of 1 x 256 seeded tokens and 8 decode steps on each device,
    logits within ``RECUR_LOGIT_REL`` of the CPU's largest."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    out = {}
    for arch in ("zamba2-2.7b", "xlstm-125m"):
        cfg = get_config(arch).replace(n_layers=RECUR_CHECK_LAYERS, dtype="float32")
        mdl = model_lib.build(cfg)
        params = mdl.init(torch.Generator(dev).manual_seed(SEED))
        cpu_params = copy.deepcopy(params).to("cpu")
        rng = np.random.default_rng(SEED)
        B, P, T = RECUR_CHECK_BATCH, RECUR_CHECK_PROMPT, RECUR_CHECK_DECODE
        tokens = rng.integers(4, cfg.vocab_size, (B, P + T)).astype(np.int32)
        runs = {}
        for name, p, device in (("card", params, dev), ("cpu", cpu_params, "cpu")):
            t0 = time.perf_counter()
            with WidthLog() as widths:
                runs[name] = prefill_decode(torch, mdl, p, torch.from_numpy(tokens).to(device),
                                            P, T, device)
            runs[name].update(s=time.perf_counter() - t0, widths=widths.widths)
        launches = runs["card"]["prefill_launches"]
        attn = 1 if cfg.family == "hybrid" else 0
        require(launches["flash_attention"] == attn == launches["flash_attention.ffma"]
                and runs["card"]["widths"] == [160] * attn and not runs["cpu"]["widths"],
                f"(g) {arch}: {launches}, widths {runs['card']['widths']}")
        g, w = runs["card"]["logits"].cpu(), runs["cpu"]["logits"]
        diff, top = (g - w).abs().max().item(), w.abs().max().item()
        out[arch] = {"layers": cfg.n_layers, "d_model": cfg.d_model,
                     "params": model_lib.param_count(params), "batch": B, "prompt": P,
                     "decode_steps": T, "launches": {k: launches[k] for k in (
                         "flash_attention", "flash_attention.ffma")},
                     "logits_max_diff": diff, "max_abs_logit": top, "rel": diff / top,
                     "limit_rel": RECUR_LOGIT_REL, "card_s": runs["card"]["s"],
                     "cpu_s": runs["cpu"]["s"]}
        print(f"phase 9 (g, {arch} widths at {cfg.n_layers} layers, card vs CPU): "
              f"{json.dumps(out[arch])}", flush=True)
        require(diff <= RECUR_LOGIT_REL * top, f"(g) {arch}: the logits differ by {diff}")
        del params, cpu_params, runs
    return out


def serve_recurrent(torch, dev, arch: str, batch: int, max_len: int, prompt_len: int,
                    new_tokens: int, requests: int) -> tuple[dict, object, object]:
    """``arch`` at full size (bfloat16, seeded init on the card) serves
    ``requests`` seeded prompts through ``ServeEngine``, the launch counts
    zeroed just before ``run`` (``serve_on``) and each flash launch's head
    width recorded -> (readings, model, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    cfg = get_config(arch)
    mdl = model_lib.build(cfg)
    t0 = time.perf_counter()
    params = mdl.init(torch.Generator(dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(4, cfg.vocab_size, prompt_len).astype(np.int32)
               for _ in range(requests)]
    with WidthLog() as widths:
        r = serve_on(torch, mdl, params, prompts, new_tokens, dev, batch, max_len, timed=True)
    require(sorted(r["results"]) == list(range(requests))
            and all(len(t) == new_tokens or t[-1] == 2 for t in r["results"].values()),
            f"{arch}: lost or short requests")
    out = {k: r[k] for k in ("launches", "wall_s", "waves", "tokens", "tokens_per_s",
                             "prefill_s_per_wave", "decode_ms_per_step", "decode_steps",
                             "peak_device_bytes")}
    out.update(params=model_lib.param_count(params), init_s=init_s, prompt_len=prompt_len,
               requests=requests, batch=batch, widths=sorted(set(widths.widths)),
               width_launches=len(widths.widths), first_tokens=r["results"][0][:8].tolist())
    return out, mdl, params


def recurrent_consistency(torch, dev, arch: str, mdl, params, out: dict) -> None:
    """The reference's prefill/decode check (``consistency``) on ``arch``'s
    full-size model: read in bfloat16, then held with the weights made
    float32 in place within ``CONSIST_TOL`` (and the off-by-one rows beyond
    ``BF16_CONSIST_REL``); readings go to ``out``."""
    from repro_torch.models import model as model_lib

    B, P = RECUR_CONSIST[arch]
    gen = torch.Generator(dev).manual_seed(SEED + 3)
    tokens = torch.randint(4, mdl.cfg.vocab_size, (B, P + RECUR_CONSIST_DECODE),
                           generator=gen, device=dev)
    args = (tokens, P, RECUR_CONSIST_DECODE, dev)
    out["consistency_bf16"] = consistency(torch, mdl, params, *args)
    print(f"phase 9 ({arch}, bfloat16 consistency, read): "
          f"{json.dumps(out['consistency_bf16'])}", flush=True)
    to_float32_(torch, params)
    c = out["consistency"] = consistency(
        torch, model_lib.build(mdl.cfg.replace(dtype="float32")), params, *args)
    print(f"phase 9 ({arch}, float32 consistency): {json.dumps(c)}", flush=True)
    require(c["beyond_limit"] == 0 and c["off_by_one_rel_rms"] > BF16_CONSIST_REL,
            f"{arch}: prefill + decode logits differ from the train-mode forward's")


def check_zamba(torch, dev) -> tuple[dict, dict]:
    """Phase 9 (h): zamba2-2.7b at full size (54 Mamba2 layers in 9 groups,
    2 shared attention blocks of 32 heads x 160, bfloat16) serves 2 seeded
    prompts of 4,096 tokens, 32 new each, through ``ServeEngine(batch_size=2,
    max_len=4128)``: one wave, 9 ``flash_attention`` launches, all wgmma at D
    160, no backward; then the consistency check (``recurrent_consistency``)
    and the kernel timed at its prefill shape (wgmma, bfloat16) and at the
    float32 check's (ffma)."""
    out, mdl, params = serve_recurrent(torch, dev, "zamba2-2.7b", ZAMBA_BATCH, ZAMBA_MAX_LEN,
                                       ZAMBA_PROMPT_LEN, ZAMBA_NEW_TOKENS, ZAMBA_REQUESTS)
    cfg = mdl.cfg
    n_inv = cfg.n_layers // cfg.shared_attn_every
    launches = out["launches"]
    print(f"phase 9 (h, zamba2-2.7b): {json.dumps(out)}", flush=True)
    require(out["waves"] == 1 and launches["flash_attention"] == n_inv
            == launches["flash_attention.wgmma"] == out["width_launches"]
            and out["widths"] == [160] and launches["flash_attention_bwd"] == 0,
            f"(h): {launches}, widths {out['widths']} in {out['waves']} waves")
    recurrent_consistency(torch, dev, "zamba2-2.7b", mdl, params, out)
    del params
    torch.cuda.empty_cache()
    gen = torch.Generator(dev).manual_seed(SEED + 4)
    q, k, v = (torch.randn(ZAMBA_BATCH, cfg.n_heads, ZAMBA_PROMPT_LEN, 160, generator=gen,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    timing = {"zamba2": time_flash(torch, q, k, v, causal=True, window=None, softcap=None,
                                   sdpa=True)}
    print(f"phase 9 (zamba2-2.7b attention): {json.dumps(timing['zamba2'])}", flush=True)
    B, P = RECUR_CONSIST["zamba2-2.7b"]
    q, k, v = (torch.randn(B, cfg.n_heads, P, 160, generator=gen, device=dev)
               for _ in range(3))
    timing["zamba2_f32"] = time_flash(torch, q, k, v, causal=True, window=None, softcap=None,
                                      sdpa=True)
    print(f"phase 9 (zamba2-2.7b attention, float32): {json.dumps(timing['zamba2_f32'])}",
          flush=True)
    return out, timing


def check_xlstm(torch, dev) -> dict:
    """Phase 9 (i): xlstm-125m at full size (12 layers, 5 mLSTM + 1 sLSTM
    twice, bfloat16) serves 4 seeded prompts of 2,048 tokens, 32 new each,
    through ``ServeEngine(batch_size=4, max_len=2080)``: no
    ``flash_attention`` launch; then the consistency check."""
    out, mdl, params = serve_recurrent(torch, dev, "xlstm-125m", XLSTM_BATCH, XLSTM_MAX_LEN,
                                       XLSTM_PROMPT_LEN, XLSTM_NEW_TOKENS, XLSTM_REQUESTS)
    print(f"phase 9 (i, xlstm-125m): {json.dumps(out)}", flush=True)
    launches = out["launches"]
    require(out["waves"] == 1 and launches["flash_attention"] == 0
            and launches["flash_attention_bwd"] == 0 and not out["width_launches"],
            f"(i): {launches} in {out['waves']} waves")
    recurrent_consistency(torch, dev, "xlstm-125m", mdl, params, out)
    del params
    return out


def check_recurrent(torch, dev) -> tuple[dict, dict]:
    """Phase 9 (g), (h), (i), each model freed before the next; allocated
    device memory after them within ``PHASE9_MEMORY_SLACK`` of before."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = {"g_card_vs_cpu": check_recurrent_card_vs_cpu(torch, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    out["h_zamba2"], timing = check_zamba(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    out["i_xlstm"] = check_xlstm(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    out.update(allocated_before_bytes=before, allocated_after_bytes=after,
               phase_s=time.perf_counter() - t0)
    require(after - before <= PHASE9_MEMORY_SLACK, f"(g)-(i) left {after - before} B allocated")
    return out, timing


# ---- phase 9 (j)-(k): the encoder-decoder family (seamless-m4t-large-v2) -------

ENCDEC_ARCH = "seamless-m4t-large-v2"
# (j): full widths cut to 2 encoder + 2 decoder layers, float32: 1 request
# of 256 source frames and a 64-token target prompt, 8 decode steps
ENCDEC_CHECK_LAYERS, ENCDEC_CHECK = 2, (1, 256, 64, 8)
ENCDEC_LOGIT_REL = 1e-4        # (j): as (g)'s RECUR_LOGIT_REL
# (k): full size, bfloat16: 2 x (1,024 source frames + 64 target tokens), 32 new
ENCDEC_BATCH, ENCDEC_SRC, ENCDEC_PROMPT, ENCDEC_NEW = 2, 1024, 64, 32


def encdec_inputs(torch, cfg, dev, B: int, S_src: int, S_tgt: int, seed: int):
    """Seeded source frames ``[B, S_src, d_model]`` (normal x 0.1, as the
    reference's ``specs.train_batch``) in the model's dtype and target
    tokens ``[B, S_tgt]``, both on ``dev``."""
    from repro_torch.models import layers

    g = torch.Generator(dev).manual_seed(seed)
    src = (torch.randn(B, S_src, cfg.d_model, generator=g, device=dev) * 0.1).to(
        layers.dt(cfg))
    tokens = torch.randint(4, cfg.vocab_size, (B, S_tgt), generator=g, device=dev)
    return src, tokens


def encdec_prefill_decode(torch, mdl, params, src, tokens, n_prompt: int, n_decode: int,
                          device, greedy: bool = False) -> dict:
    """A prefill of ``src`` and ``tokens[:, :n_prompt]``, then ``n_decode``
    decode steps fed ``tokens[:, n_prompt + j]`` (``greedy``: the last
    step's argmax): next-token logits ``[B, 1 + n_decode, V]`` (float32),
    the prefill's seconds and launches (counts zeroed just before it), each
    decode step's ms and launches (host clocks ended by a synchronize on
    the card), and the tokens fed."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    B = tokens.shape[0]
    caches = mdl.init_caches(B, n_prompt + n_decode, src_len=src.shape[1], device=device)
    sync()
    zero_launches()
    t0 = time.perf_counter()
    logits, caches = mdl.apply(params, {"src_embeds": src, "tokens": tokens[:, :n_prompt]},
                               mode="prefill", caches=caches)
    sync()
    prefill_s = time.perf_counter() - t0
    launches = read_launches()
    out, decode_ms, fed = [logits[:, -1].float()], [], []
    zero_launches()
    for j in range(n_decode):
        nxt = (logits[:, -1:].argmax(-1) if greedy
               else tokens[:, n_prompt + j:n_prompt + j + 1])
        fed.append(nxt)
        t0 = time.perf_counter()
        logits, caches = mdl.apply(params, {"tokens": nxt}, mode="decode", caches=caches)
        sync()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(logits[:, 0].float())
    decode_launches = read_launches()
    del caches
    return {"logits": torch.stack(out, 1), "prefill_s": prefill_s,
            "prefill_launches": launches, "decode_ms": decode_ms,
            "decode_launches": decode_launches,
            "fed": torch.cat(fed, 1) if fed else tokens[:, :0]}


def check_encdec_card_vs_cpu(torch, dev) -> dict:
    """Phase 9 (j): seamless-m4t-large-v2's full widths (d 1,024, 16 heads
    of 64, d_ff 8,192, vocab 256,206, tied) cut to 2 encoder and 2 decoder
    layers, in float32, initialised on the card and copied to the CPU: one
    prefill of 1 x (256 source frames + 64 target tokens) and 8 decode
    steps on each device, logits within ``ENCDEC_LOGIT_REL`` of the CPU's
    largest; the prefill launches the encoder's and the decoder's self-
    and cross-attention once a layer each (tf32x3 in float32 at D 64).
    Then, on the card, prefill + decode logits against the train-mode
    forward at the same positions (the reference's
    test_prefill_decode_consistency) within ``CONSIST_TOL``, a limit the
    off-by-one rows must break."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    n = ENCDEC_CHECK_LAYERS
    cfg = get_config(ENCDEC_ARCH).replace(n_layers=2 * n, n_enc_layers=n, n_dec_layers=n,
                                          dtype="float32")
    mdl = model_lib.build(cfg)
    params = mdl.init(torch.Generator(dev).manual_seed(SEED))
    cpu_params = copy.deepcopy(params).to("cpu")
    B, S_src, P, T = ENCDEC_CHECK
    src, tokens = encdec_inputs(torch, cfg, dev, B, S_src, P + T, SEED + 5)
    runs = {}
    for name, p, device in (("card", params, dev), ("cpu", cpu_params, "cpu")):
        t0 = time.perf_counter()
        runs[name] = encdec_prefill_decode(torch, mdl, p, src.to(device), tokens.to(device),
                                           P, T, device)
        runs[name]["s"] = time.perf_counter() - t0
    launches = runs["card"]["prefill_launches"]
    g, w = runs["card"]["logits"].cpu(), runs["cpu"]["logits"]
    diff, top = (g - w).abs().max().item(), w.abs().max().item()
    with torch.no_grad():
        full, _ = mdl.apply(params, {"src_embeds": src, "tokens": tokens}, mode="train")
    want = full[:, P - 1:P + T].float()
    later = full[:, P:P + T].float()
    del full
    got = runs["card"]["logits"]

    def rel(a, b):
        return ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()

    out = {"layers": f"{n} + {n}", "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": model_lib.param_count(params), "batch": B, "source": S_src,
           "prompt": P, "decode_steps": T,
           "launches": {k: launches[k] for k in ("flash_attention", "flash_attention.tf32x3")},
           "decode_launches": runs["card"]["decode_launches"]["flash_attention"],
           "logits_max_diff": diff, "max_abs_logit": top, "rel": diff / top,
           "limit_rel": ENCDEC_LOGIT_REL, "card_s": runs["card"]["s"], "cpu_s": runs["cpu"]["s"],
           "consistency": {"rel_rms": rel(got, want),
                           "max_abs_diff": (got - want).abs().max().item(),
                           "off_by_one_rel_rms": rel(got[:, :-1], later), "limit": CONSIST_TOL,
                           "beyond_limit": int(((got - want).abs()
                                                > CONSIST_TOL + CONSIST_TOL * want.abs()).sum())}}
    print(f"phase 9 (j, {ENCDEC_ARCH} widths at {n} + {n} layers, card vs CPU): "
          f"{json.dumps(out)}", flush=True)
    require(launches["flash_attention"] == attention_calls(cfg)
            == launches["flash_attention.tf32x3"]
            and out["decode_launches"] == 0, f"(j): {launches}, decode {out['decode_launches']}")
    require(diff <= ENCDEC_LOGIT_REL * top, f"(j): the logits differ by {diff}")
    c = out["consistency"]
    require(c["beyond_limit"] == 0 and c["off_by_one_rel_rms"] > BF16_CONSIST_REL,
            f"(j): prefill + decode logits differ from the train-mode forward's: {c}")
    del params, cpu_params, runs
    return out


def check_encdec_serving(torch, dev) -> tuple[dict, dict]:
    """Phase 9 (k): seamless-m4t-large-v2 at full size (24 encoder and 24
    decoder layers, bf16, seeded init on the card, nothing cut): 2 requests
    of 1,024 seeded source frames and 64 target tokens through
    ``model.apply`` prefill (72 ``flash_attention`` launches, all wgmma at D
    64: 24 encoder self-attentions, 24 causal decoder self-attentions and
    24 cross-attentions of 64 queries over 1,024 keys), then 32 greedy
    decode steps (each recomputes every layer's cross-attention keys and
    values from the memory, as the reference; its one query row takes
    ``blocked_sdpa``: no launch); prefill s, decode ms a step, tokens/s and
    peak device memory; then the kernel timed at the encoder's and the
    cross-attention's prefill shapes beside its bound, its plain version and
    ``scaled_dot_product_attention``."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    cfg = get_config(ENCDEC_ARCH)
    mdl = model_lib.build(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = mdl.init(torch.Generator(dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S, P, T = ENCDEC_BATCH, ENCDEC_SRC, ENCDEC_PROMPT, ENCDEC_NEW
    src, tokens = encdec_inputs(torch, cfg, dev, B, S, P, SEED + 6)
    with WidthLog() as widths:
        r = encdec_prefill_decode(torch, mdl, params, src, tokens, P, T, dev, greedy=True)
    launches = r["prefill_launches"]
    decode_s = sum(r["decode_ms"]) / 1e3
    out = {"params": model_lib.param_count(params), "init_s": init_s, "batch": B, "source": S,
           "prompt": P, "new_tokens": T, "prefill_s": r["prefill_s"],
           "decode_ms_per_step": sum(r["decode_ms"]) / T,
           "decode_ms": r["decode_ms"], "tokens_per_s": B * T / decode_s,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "launches": {k: launches[k] for k in ("flash_attention", "flash_attention.wgmma",
                                                 "flash_attention_bwd")},
           "decode_launches": r["decode_launches"]["flash_attention"],
           "widths": sorted(set(widths.widths)), "width_launches": len(widths.widths),
           "finite": bool(torch.isfinite(r["logits"]).all()),
           "first_tokens": r["fed"][0, :8].tolist()}
    print(f"phase 9 (k, {ENCDEC_ARCH}): {json.dumps(out)}", flush=True)
    require(launches["flash_attention"] == attention_calls(cfg)
            == launches["flash_attention.wgmma"]
            and out["decode_launches"] == 0 and out["widths"] == [64]
            and launches["flash_attention_bwd"] == 0,
            f"(k): prefill {launches}, decode {out['decode_launches']}, widths {out['widths']}")
    require(out["finite"], "(k): the logits are not finite")
    del params, r
    torch.cuda.empty_cache()
    gen = torch.Generator(dev).manual_seed(SEED + 7)
    q, k, v = (torch.randn(B, cfg.n_heads, S, cfg.hd, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    timing = {"seamless_enc": time_flash(torch, q, k, v, causal=False, window=None,
                                         softcap=None, sdpa=True)}
    print(f"phase 9 ({ENCDEC_ARCH} encoder attention): {json.dumps(timing['seamless_enc'])}",
          flush=True)
    timing["seamless_cross"] = time_flash(torch, q[:, :, :P], k, v, causal=False, window=None,
                                          softcap=None, sdpa=True)
    print(f"phase 9 ({ENCDEC_ARCH} cross-attention): "
          f"{json.dumps(timing['seamless_cross'])}", flush=True)
    return out, timing


def check_encdec(torch, dev) -> tuple[dict, dict]:
    """Phase 9 (j), (k), each model freed before the next; allocated
    device memory after them within ``PHASE9_MEMORY_SLACK`` of before."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = {"j_card_vs_cpu": check_encdec_card_vs_cpu(torch, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    out["k_serving"], timing = check_encdec_serving(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    out.update(allocated_before_bytes=before, allocated_after_bytes=after,
               phase_s=time.perf_counter() - t0)
    require(after - before <= PHASE9_MEMORY_SLACK, f"(j)-(k) left {after - before} B allocated")
    return out, timing


# ---- phase 10: training -----------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_PATIENTS = 8, 256, 512   # examples/train_lm_torch.py --full
# (b): 50 + 50 steps (150 + 150 until phase 10 (d)-(e) needed the room)
TRAIN_STEPS, TRAIN_STOP = 100, 50
TRAIN_CHECK_LAYERS, TRAIN_CHECK_STEPS = 2, 3           # (a): tspm-mlho cut to 2 layers
# (a)'s limits, card against CPU: each step's loss, ce and grad norm within
# TRAIN_RTOL relative, and step 1's gradient of each parameter within
# TRAIN_GRAD_SHARE of that parameter's largest |g| on the CPU.  Set from
# the first card run (H100 80GB HBM3, 700 W): 1.2e-7 and 1.4e-6 at most,
# so each limit is ~100x its reading (another host CPU rounds its own way)
TRAIN_RTOL = 1e-5
TRAIN_GRAD_SHARE = 1e-4
TRAIN_CKPT_EVERY = 25      # (b)'s stop/resume runs: one periodic save each
GEMMA_TRAIN_SEQ, GEMMA_TRAIN_STEPS, GEMMA_TRAIN_LR = 2048, 3, 1e-4


def train_batches(n: int):
    """The launcher's data (``launch/train.py`` at ``--full``'s sizes):
    ``TRAIN_PATIENTS`` synthetic patients, packed into ``TRAIN_SEQ``-token
    rows, ``n`` batches of ``TRAIN_BATCH`` from the seed; and the corpus's
    vocabulary."""
    from repro_torch.data import dbmart, synthea, tokenize

    pats, dates, phx, _ = synthea.generate_cohort(n_patients=TRAIN_PATIENTS,
                                                  avg_events=40, seed=SEED)
    corpus = tokenize.pack_corpus(dbmart.from_rows(pats, dates, phx), seq_len=TRAIN_SEQ)
    it = tokenize.lm_batches(corpus, TRAIN_BATCH, seed=SEED)
    return [next(it) for _ in range(n)], corpus.vocab_size


def check_train_card_vs_cpu(torch, dev) -> dict:
    """Phase 10 (a): tspm-mlho at full width cut to 2 layers, initialised
    on the CPU and copied to the card; step 1's gradients (one loss and
    backward on each), then 3 train steps on each from the same state, with
    the launch counts zeroed just before the card's work and read after."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.training import optimizer as opt_lib, train_loop

    batches, vocab = train_batches(TRAIN_CHECK_STEPS)
    cfg = get_config("tspm-mlho").replace(n_layers=TRAIN_CHECK_LAYERS)
    cfg = cfg.replace(vocab_size=max(cfg.vocab_size, vocab))
    mdl = model_lib.build(cfg)
    cpu = train_loop.init_state(mdl, torch.Generator("cpu").manual_seed(SEED))
    params = copy.deepcopy(cpu.params).to(dev)
    card = train_loop.TrainState(params, opt_lib.init(dict(params.named_parameters())))
    loss_fn = train_loop.make_loss_fn(mdl)

    def grads(model, device):
        names, ps = zip(*model.named_parameters())
        loss, _ = loss_fn(model, {k: torch.as_tensor(v, device=device)
                                  for k, v in batches[0].items()})
        return dict(zip(names, torch.autograd.grad(loss, ps)))

    zero_launches()
    t0 = time.perf_counter()
    g_card = grads(card.params, dev)
    torch.cuda.synchronize()
    g_cpu = grads(cpu.params, "cpu")
    share = {n: ((g_card[n].cpu() - g).abs().max() / g.abs().max()).item()
             for n, g in g_cpu.items()}
    del g_card, g_cpu
    opt_cfg = opt_lib.OptConfig(peak_lr=1e-3, warmup_steps=20, decay_steps=TRAIN_STEPS)
    step = train_loop.make_train_step(mdl, opt_cfg)
    steps = []
    for b in batches:
        card, mc = step(card, b)
        cpu, mp = step(cpu, b)
        steps.append({k: {"card": float(mc[k]), "cpu": float(mp[k]),
                          "rel": abs(float(mc[k]) - float(mp[k])) / abs(float(mp[k]))}
                      for k in ("loss", "ce", "grad_norm")})
    launches = read_launches()
    out = {"layers": cfg.n_layers, "d_model": cfg.d_model, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": steps, "grad_share_max": max(share.values()),
           "grad_share_worst": max(share, key=share.get), "rtol": TRAIN_RTOL,
           "grad_share_limit": TRAIN_GRAD_SHARE, "s": time.perf_counter() - t0,
           "launches": {k: launches[k] for k in ("flash_attention", "flash_attention_bwd",
                                                 "flash_attention_bwd.tf32x3")}}
    print(f"phase 10 (a, card vs CPU): {json.dumps(out)}", flush=True)
    require(all(m["rel"] <= TRAIN_RTOL for s in steps for m in s.values()),
            "phase 10 (a): a step's loss, ce or grad norm differs from the CPU's")
    require(out["grad_share_max"] <= TRAIN_GRAD_SHARE,
            f"phase 10 (a): step 1's gradient of {out['grad_share_worst']} differs")
    passes = 1 + TRAIN_CHECK_STEPS                    # the gradient pass + the steps
    require(launches["flash_attention_bwd"] == cfg.n_layers * passes
            == launches["flash_attention"] == launches["flash_attention_bwd.tf32x3"],
            f"phase 10 (a): {launches} attention launches on the card")
    del card, cpu, params
    torch.cuda.empty_cache()
    return out


def run_train_launcher(extra: list, timeout: int = 400) -> dict:
    """``python -m repro_torch.launch.train --arch tspm-mlho`` at
    ``--full``'s sizes in its own process on the card, with ``extra``;
    returns its logged ce values, throughput line, digests and wall."""
    import re

    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--arch", "tspm-mlho", "--batch", str(TRAIN_BATCH),
                           "--seq", str(TRAIN_SEQ), "--patients", str(TRAIN_PATIENTS),
                           *extra], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)
    require(proc.returncode == 0, f"launch.train {extra} exited {proc.returncode}: "
                                  f"{proc.stdout[-1500:]} {proc.stderr[-2500:]}")
    text = proc.stdout
    m = re.search(r"throughput on (\S+): mean step (\S+)s, tokens/s (\S+), "
                  r"peak_device_bytes (\S+), flash_attention launches (\d+), "
                  r"flash_attention_bwd launches (\d+) \(ffma (\d+), wgmma (\d+), "
                  r"tf32x3 (\d+)\)", text)
    require(m is not None, f"launch.train printed no throughput line: {text[-1500:]}")
    return {"s": time.perf_counter() - t0, "device": m.group(1),
            "step_s": float(m.group(2)), "tokens_per_s": float(m.group(3)),
            "peak_device_bytes": None if m.group(4) == "None" else int(m.group(4)),
            "flash_attention": int(m.group(5)), "flash_attention_bwd": int(m.group(6)),
            **{f"flash_attention_bwd.{r}": int(m.group(7 + i))
               for i, r in enumerate(("ffma", "wgmma", "tf32x3"))},
            "ce": [float(x) for x in re.findall(r"^step \d+: loss=\S+ ce=(\S+)", text, re.M)],
            "saved": re.findall(r"^checkpoint (\S+) state_digest=([0-9a-f]{64})$", text, re.M),
            "resumed": re.findall(r"^resumed from (\S+) at step (\d+)$", text, re.M),
            "restored": re.findall(r"^restored state_digest=([0-9a-f]{64})$", text, re.M),
            "lines": [ln for ln in text.splitlines()
                      if ln.startswith(("corpus", "model", "done", "throughput"))]}


def check_train_launcher(tmp_root: str) -> dict:
    """Phase 10 (b): the launcher trains full-width tspm-mlho with
    ``--ckpt-dir``, stopping at step 50; a rerun resumes at step 50 from
    a state whose digest equals the one saved and trains to step 100.  The
    two runs' 100 steps log falling ce and launch the backward 12 times a
    step, all on the tf32x3 route."""
    n_layers = 12
    ckpt = os.path.join(tmp_root, "train_ckpt")
    every = ["--ckpt-every", str(TRAIN_CKPT_EVERY)]
    stopped = run_train_launcher(["--steps", str(TRAIN_STOP), "--ckpt-dir", ckpt, *every])
    resumed = run_train_launcher(["--steps", str(TRAIN_STEPS), "--ckpt-dir", ckpt, *every])
    runs = {"stopped": stopped, "resumed": resumed}
    print(f"phase 10 (b, launch.train stopped at {TRAIN_STOP}, resumed to {TRAIN_STEPS}): "
          f"{json.dumps(runs)}", flush=True)
    saved_path, saved_digest = stopped["saved"][-1]
    require(saved_path.endswith(f"step_{TRAIN_STOP:08d}"), f"phase 10 (b): saved {saved_path}")
    require(resumed["resumed"] == [(saved_path, str(TRAIN_STOP))]
            and resumed["restored"] == [saved_digest],
            f"phase 10 (b): the rerun did not resume from the saved state: {resumed}")
    ce = stopped["ce"] + resumed["ce"]
    require(len(ce) >= 10 and ce[-1] < ce[0] and sum(ce[-3:]) < sum(ce[:3]),
            f"phase 10 (b): ce does not fall: {ce}")
    for name, r, steps in (("stopped", stopped, TRAIN_STOP),
                           ("resumed", resumed, TRAIN_STEPS - TRAIN_STOP)):
        require(r["flash_attention_bwd"] == n_layers * steps == r["flash_attention"]
                == r["flash_attention_bwd.tf32x3"],
                f"phase 10 (b): the {name} run's launches {r}")
    return {**runs, "launches": {k: stopped[k] + resumed[k]
                                 for k in ("flash_attention", "flash_attention_bwd",
                                           "flash_attention_bwd.tf32x3")}}


def check_gemma_training(torch, dev) -> dict:
    """Phase 10 (c): gemma2-2b at full width (26 layers, bf16 parameters,
    float32 moments) takes 3 steps on one batch of 1 x 2,048 random tokens,
    every block checkpointed (``remat="dots"``, ``torch.utils.checkpoint``);
    the loss must be finite and fall, with 26 backward launches a step, all
    on the wgmma route."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.training import optimizer as opt_lib, train_loop

    cfg = get_config("gemma2-2b")
    require(cfg.remat == "dots", "gemma2-2b's config no longer checkpoints")
    mdl = model_lib.build(cfg)
    state = train_loop.init_state(mdl, torch.Generator(dev).manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    toks = rng.integers(4, cfg.vocab_size, (1, GEMMA_TRAIN_SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": np.ones((1, GEMMA_TRAIN_SEQ), bool)}
    step = train_loop.make_train_step(mdl, opt_lib.OptConfig(
        peak_lr=GEMMA_TRAIN_LR, warmup_steps=0, decay_steps=100))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    losses, times = [], []
    for _ in range(GEMMA_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    launches = read_launches()
    out = {"params": model_lib.param_count(state.params), "losses": losses,
           "step_s": times, "tokens_per_s": GEMMA_TRAIN_SEQ / (sum(times[1:]) / (len(times) - 1)),
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "launches": {k: launches[k] for k in ("flash_attention", "flash_attention_bwd",
                                                 "flash_attention.wgmma",
                                                 "flash_attention_bwd.wgmma")}}
    print(f"phase 10 (c, gemma2-2b): {json.dumps(out)}", flush=True)
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"phase 10 (c): gemma2-2b's loss is not finite and falling: {losses}")
    require(launches["flash_attention_bwd"] == launches["flash_attention_bwd.wgmma"]
            == cfg.n_layers * GEMMA_TRAIN_STEPS, f"phase 10 (c): {launches}")
    del state
    torch.cuda.empty_cache()
    return out


# ---- phase 10 (d)-(e): training the MoE, VLM, xLSTM, hybrid and encdec families --

# (d): each family's full widths cut to its smallest whole unit of depth,
# float32, remat off (it recomputes the same values; (e) runs it): arch ->
# (config changes, batch, tokens (a VLM: patches + text, an encoder-
# decoder: source frames + target tokens))
FAMILY_CHECK = {
    "deepseek-moe-16b": ({"n_layers": 2}, 1, 256),
    "pixtral-12b": ({"n_layers": 2}, 1, (128, 128)),
    "xlstm-125m": ({"n_layers": 6}, 1, 256),          # 5 mLSTM + 1 sLSTM
    "zamba2-2.7b": ({"n_layers": 6}, 1, 256),         # one group: 6 Mamba2 + 1 shared
    ENCDEC_ARCH: ({"n_layers": 4, "n_enc_layers": 2, "n_dec_layers": 2}, 1, (128, 128)),
}
# (e): 3 steps each in bf16 with the config's remat: arch -> (config
# changes, batch, tokens); deepseek-moe-16b and pixtral-12b keep their
# widths and cut their depth to 4 layers, so that the step (parameters,
# gradients and float32 moments of ~2.4-2.8 B parameters) peaks under
# FAMILY_PEAK_LIMIT; the others run at full size
FAMILY_TRAIN = {
    "zamba2-2.7b": ({}, 1, 4096),
    ENCDEC_ARCH: ({}, 2, (1024, 1024)),
    "xlstm-125m": ({}, 2, 1024),
    "deepseek-moe-16b": ({"n_layers": 4}, 4, 512),
    "pixtral-12b": ({"n_layers": 4}, 2, (1024, 64)),
}
FAMILY_TRAIN_STEPS, FAMILY_TRAIN_LR = 3, 1e-4
FAMILY_PEAK_LIMIT = 60e9


def attention_calls(cfg) -> int:
    """``flash_attention`` calls in a full-sequence forward of ``cfg``: one
    a layer; a hybrid's one a shared invocation, an xLSTM's none, an
    encoder-decoder's one an encoder layer and two a decoder layer (self-
    and cross-attention)."""
    return {"hybrid": cfg.n_layers // max(cfg.shared_attn_every, 1), "xlstm": 0,
            "encdec": cfg.n_enc_layers + 2 * cfg.n_dec_layers}.get(cfg.family, cfg.n_layers)


def family_batch(torch, cfg, dev, B: int, seq, seed: int) -> dict:
    """A seeded training batch for ``cfg``'s family on ``dev``, shaped as
    the reference's ``launch/specs.train_batch`` shapes it: tokens,
    next-token labels and a full mask; a VLM's ``seq = (patches, text)``
    puts projected patches before the text, its labels covering both; an
    encoder-decoder's ``seq = (source, target)`` gives source frames and
    target tokens."""
    from repro_torch.models import layers

    g = torch.Generator(dev).manual_seed(seed)
    pre, text = seq if isinstance(seq, tuple) else (0, seq)
    toks = torch.randint(4, cfg.vocab_size, (B, text + 1), generator=g, device=dev)
    n_labels = text + (pre if cfg.family == "vlm" else 0)
    batch = {"tokens": toks[:, :-1],
             "labels": torch.randint(4, cfg.vocab_size, (B, n_labels), generator=g, device=dev)
             if cfg.family == "vlm" else toks[:, 1:],
             "loss_mask": torch.ones(B, n_labels, dtype=torch.bool, device=dev)}
    width = {"vlm": cfg.frontend_dim, "encdec": cfg.d_model}.get(cfg.family)
    if width:
        key = "patch_embeds" if cfg.family == "vlm" else "src_embeds"
        batch[key] = (torch.randn(B, pre, width, generator=g, device=dev) * 0.1).to(
            layers.dt(cfg))
    return batch


def check_family_train_card_vs_cpu(torch, dev) -> dict:
    """Phase 10 (d): for each family of ``FAMILY_CHECK`` at full widths cut
    in depth, float32, initialised on the card and copied to the CPU, step
    1's loss, ce and aux within ``TRAIN_RTOL`` and every parameter's
    gradient within ``TRAIN_GRAD_SHARE`` of its largest |g| on the CPU
    (phase 10 (a)'s bar); deepseek-moe-16b's routing byte-equal on both
    devices; the card's attention launches counted, each backward on the
    route ``ops.bwd_route`` names for float32 at the layer's head width
    (zamba2-2.7b's shared attention: ffma at D 160; deepseek-moe-16b and
    pixtral-12b: ffma at D 128; the seamless encoder-decoder: tf32x3 at D
    64)."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import model as model_lib
    from repro_torch.training import train_loop

    out = {}
    for arch, (change, B, seq) in FAMILY_CHECK.items():
        cfg = get_config(arch).replace(dtype="float32", remat="none", **change)
        mdl = model_lib.build(cfg)
        loss_fn = train_loop.make_loss_fn(mdl)
        card = train_loop.trainable(mdl.init(torch.Generator(dev).manual_seed(SEED)))
        cpu = copy.deepcopy(card).to("cpu")
        batch = family_batch(torch, cfg, dev, B, seq, SEED + 8)
        runs = {}
        zero_launches()
        for name, model, device in (("card", card, dev), ("cpu", cpu, "cpu")):
            t0 = time.perf_counter()
            with RouteLog() as routes:
                loss, metrics = loss_fn(model, {k: v.to(device) for k, v in batch.items()})
                names, ps = zip(*model.named_parameters())
                grads = torch.autograd.grad(loss, ps, materialize_grads=True)
            runs[name] = {"loss": float(loss.detach()), "ce": float(metrics["ce"]),
                          "aux": float(metrics["aux"]), "grads": dict(zip(names, grads)),
                          "eid": [r.eid.cpu() for r in routes.calls],
                          "s": time.perf_counter() - t0}
            if name == "card":
                torch.cuda.synchronize()
                launches = read_launches()
        c, p = runs["card"], runs["cpu"]
        share = {n: ((g.cpu() - p["grads"][n]).abs().max()
                     / p["grads"][n].abs().max().clamp_min(1e-30)).item()
                 for n, g in c["grads"].items()}
        rel = {k: abs(c[k] - p[k]) / max(abs(p[k]), 1e-30) for k in ("loss", "ce", "aux")}
        out[arch] = {"config": change, "batch": B, "seq": seq,
                     "params": model_lib.param_count(card),
                     "loss": {"card": c["loss"], "cpu": p["loss"]}, "rel": rel,
                     "grad_share_max": max(share.values()),
                     "grad_share_worst": max(share, key=share.get),
                     "routing_equal": len(c["eid"]) == len(p["eid"]) and all(
                         torch.equal(a, b) for a, b in zip(c["eid"], p["eid"])),
                     "routed_layers": len(c["eid"]), "card_s": c["s"], "cpu_s": p["s"],
                     "launches": {k: n for k, n in launches.items()
                                  if k.startswith("flash_attention") and n}}
        print(f"phase 10 (d, {arch} card vs CPU): {json.dumps(out[arch])}", flush=True)
        require(all(r <= TRAIN_RTOL for k, r in rel.items() if p[k] != 0 or c[k] != 0),
                f"phase 10 (d) {arch}: loss, ce or aux differ: {rel}")
        require(out[arch]["grad_share_max"] <= TRAIN_GRAD_SHARE,
                f"phase 10 (d) {arch}: the gradient of {out[arch]['grad_share_worst']} differs")
        require(out[arch]["routing_equal"] and (len(c["eid"]) > 0) == bool(cfg.n_experts),
                f"phase 10 (d) {arch}: the routing differs between the devices")
        n_attn = attention_calls(cfg)
        hd = 2 * cfg.d_model // cfg.n_heads if cfg.family == "hybrid" else cfg.hd
        route = flash_ops.bwd_route(torch.float32, hd) if n_attn else "ffma"
        out[arch]["bwd_route"] = route
        require(launches["flash_attention"] == launches["flash_attention_bwd"] == n_attn
                == launches[f"flash_attention_bwd.{route}"],
                f"phase 10 (d) {arch}: {launches}, want {n_attn} backward launches on {route}")
        del card, cpu, runs, c, p, batch
        torch.cuda.empty_cache()
    return out


def check_family_training(torch, dev) -> dict:
    """Phase 10 (e): each model of ``FAMILY_TRAIN`` (bf16 parameters,
    float32 moments, the config's remat) takes ``FAMILY_TRAIN_STEPS``
    steps on one seeded batch, the launch counts zeroed just before the
    first step and read after the last: each step's loss finite, its
    gradient norm finite and above 0, the backward launched once a
    attention a step on the route ``ops.bwd_route`` names (zamba2-2.7b: 9
    shared invocations at D 160 on wgmma; seamless-m4t-large-v2: 72 at D
    64; xlstm-125m: none); step s, tokens/s (the steps after the first)
    and peak device memory (under ``FAMILY_PEAK_LIMIT`` where the depth
    was cut)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import model as model_lib
    from repro_torch.training import optimizer as opt_lib, train_loop

    out = {}
    for arch, (change, B, seq) in FAMILY_TRAIN.items():
        cfg = get_config(arch).replace(**change)
        mdl = model_lib.build(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = train_loop.init_state(mdl, torch.Generator(dev).manual_seed(SEED))
        batch = family_batch(torch, cfg, dev, B, seq, SEED + 9)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        step = train_loop.make_train_step(mdl, opt_lib.OptConfig(
            peak_lr=FAMILY_TRAIN_LR, warmup_steps=0, decay_steps=100))
        zero_launches()
        losses, norms, times = [], [], []
        for _ in range(FAMILY_TRAIN_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        launches = read_launches()
        tokens = B * sum(seq) if isinstance(seq, tuple) else B * seq
        n_attn = attention_calls(cfg)
        hd = 2 * cfg.d_model // cfg.n_heads if cfg.family == "hybrid" else cfg.hd
        route = flash_ops.bwd_route(torch.bfloat16, hd) if n_attn else None
        out[arch] = {"config": change, "layers": cfg.n_layers, "batch": B, "seq": seq,
                     "params": model_lib.param_count(state.params), "remat": cfg.remat,
                     "init_s": init_s, "step_s": times,
                     "tokens_per_s": tokens / (sum(times[1:]) / (len(times) - 1)),
                     "peak_device_bytes": torch.cuda.max_memory_allocated(),
                     "losses": losses, "grad_norms": norms, "head_dim": hd,
                     "bwd_route": route,
                     "launches": {k: n for k, n in launches.items()
                                  if k.startswith("flash_attention") and n}}
        print(f"phase 10 (e, {arch}): {json.dumps(out[arch])}", flush=True)
        require(all(np.isfinite(losses)) and all(np.isfinite(norms)) and min(norms) > 0,
                f"phase 10 (e) {arch}: losses {losses}, gradient norms {norms}")
        bwd = n_attn * FAMILY_TRAIN_STEPS
        require(launches["flash_attention_bwd"] == bwd
                and (not bwd or launches[f"flash_attention_bwd.{route}"] == bwd),
                f"phase 10 (e) {arch}: {launches}, want {bwd} backward launches on {route}")
        require(not change or out[arch]["peak_device_bytes"] < FAMILY_PEAK_LIMIT,
                f"phase 10 (e) {arch}: peak {out[arch]['peak_device_bytes']} B")
        del state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---- phase 11: the dry run on the card ----------------------------------------

# the limits of the fake step's predictions against the real step's readings:
# the traced peak over the measured one, and analysis/costmodel's FLOPs over
# the counted ones (tests/test_costmodel.py's bands, by shape kind).  The
# peak's band is set from the first card runs, where gemma2-2b's step read
# 0.99598 (twice), zamba2-2.7b's 2 x 4,096 prefill 0.99561 and
# pixtral-12b's prefill 0.99999998 (NVIDIA H100 80GB HBM3, 700.00 W); the
# 0.4% the training step's trace misses is not located yet
DRY_PEAK_RATIO = (0.95, 1.05)
DRY_FLOP_BANDS = {"train": (0.75, 1.45), "prefill": (0.75, 1.45), "decode": (0.5, 2.0)}
# (a): cells the smoke also runs for real, at their config and shape.
# zamba2-2.7b's 2 x 4,096 prefill (phase 9 (h)) traced in 66.6 s on the
# card (54 Mamba2 layers x 16 scan chunks of eager ops), over phase 11's
# share of the smoke's time: pixtral-12b's wave stands in for it
DRY_CELLS = {
    "gemma2-2b": ("train", 1, GEMMA_TRAIN_SEQ),            # phase 10 (c), remat
    "pixtral-12b": ("prefill", PIXTRAL_REQUESTS, 1024 + PIXTRAL_TEXT),   # 9 (f)'s prefill
}
DRY_DECODE_SHAPE = "decode_32k"          # (b): every assigned arch on the card's route


def real_step(torch, arch: str, shape, dev) -> dict:
    """The cell's step for real on the card (seeded weights, the concrete
    batch of ``launch/specs`` and fresh caches already on the card): its
    inputs' device bytes and its peak (from a reset just before the step),
    both above what was allocated before the inputs, and
    ``FlopCounterMode``'s count of the step; then the step's seconds,
    timed twice more without the counter (a prefill on fresh caches each
    time, made outside the timing)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    from repro_torch.models import model as model_lib
    from repro_torch.training import optimizer as opt_lib, train_loop

    cfg = get_config(arch)
    mdl = model_lib.build(cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(dev).manual_seed(SEED)
    batch = {k: v.to(dev) for k, v in specs.train_batch(cfg, shape, concrete=True,
                                                        seed=SEED).items()}
    held = {}
    if shape.kind == "train":
        state = train_loop.init_state(mdl, gen)
        step = train_loop.make_train_step(mdl, opt_lib.OptConfig())

        def run():
            step(state, batch)
    else:
        params = mdl.init(gen)
        for k in ("labels", "loss_mask"):
            batch.pop(k)

        def run():
            mdl.apply(params, batch, mode=shape.kind, caches=held.pop("caches"))

    def prepare():
        if shape.kind != "train":
            held["caches"] = mdl.init_caches(shape.global_batch, shape.seq_len, device=dev)
        torch.cuda.synchronize()

    prepare()
    args = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with FlopCounterMode(display=False) as counter:
        run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = read_launches()
    times = []
    for _ in range(2):
        prepare()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    del batch, run
    gc_free(torch)
    return {"argument_bytes": args, "peak_bytes": peak, "flops": counter.get_total_flops(),
            "step_s": times, "launches": {k: launches[k] for k in
                                          ("flash_attention", "flash_attention_bwd")}}


def gc_free(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def check_dry_run(torch, dev) -> dict:
    """Phase 11: the dry run (``launch/dryrun``) on fake ``cuda`` tensors,
    through the attention ops' fake implementations.  (a) For each of
    ``DRY_CELLS`` the fake step's traced peak against the real step's
    ``max_memory_allocated`` (both above what was allocated before the
    step's inputs) within ``DRY_PEAK_RATIO``, its ``FlopCounterMode`` count
    equal to the real step's, ``costmodel.step_flops`` over that count
    within the reference's band, and ``mfu``, the model FLOPs over the
    measured step seconds times the bf16 peak; (b) ``run_cell`` for every
    assigned arch at ``decode_32k``: each must trace (``ok``), and the
    report's tables are printed."""
    from repro_torch.analysis import costmodel, report
    from repro_torch.analysis import roofline as rl
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    gc_free(torch)
    out = {"cells": {}}
    for arch, (kind, B, S) in DRY_CELLS.items():
        shape = ShapeConfig(f"{kind}_{B}x{S}", S, B, kind)
        fake = dryrun.trace_cell(arch, shape, device=dev)
        real = real_step(torch, arch, shape, dev)
        cfg = fake["cfg"]
        _, active = rl.count_params(cfg)
        embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
        step_s = min(real["step_s"])
        r = {"shape": f"{B} x {S} {kind}", "trace_s": fake["trace_s"],
             "predicted_peak_bytes": fake["peak_bytes"], "measured_peak_bytes": real["peak_bytes"],
             "peak_ratio": fake["peak_bytes"] / real["peak_bytes"],
             "predicted_argument_bytes": fake["argument_bytes"],
             "measured_argument_bytes": real["argument_bytes"],
             "fake_flops": fake["flops"], "real_flops": real["flops"],
             "step_flops_over_counted": costmodel.step_flops(cfg, shape) / fake["flops"],
             "step_s": real["step_s"],
             "mfu": rl.model_flops(cfg, shape, active, embed) / (step_s * rl.PEAK_FLOPS),
             "launches": real["launches"]}
        out["cells"][arch] = r
        print(f"phase 11 (a, {arch} {r['shape']}): {json.dumps(r)}", flush=True)
        lo, hi = DRY_PEAK_RATIO
        require(lo <= r["peak_ratio"] <= hi,
                f"phase 11 (a) {arch}: predicted peak {fake['peak_bytes']} B against "
                f"measured {real['peak_bytes']} B")
        require(fake["flops"] == real["flops"],
                f"phase 11 (a) {arch}: fake step counts {fake['flops']} FLOPs, the real "
                f"step {real['flops']}")
        lo, hi = DRY_FLOP_BANDS[kind]
        require(lo < r["step_flops_over_counted"] < hi,
                f"phase 11 (a) {arch}: step_flops / counted {r['step_flops_over_counted']}")
        require(real["launches"]["flash_attention"] > 0, f"phase 11 (a) {arch}: {real}")
    with tempfile.TemporaryDirectory(prefix="tspm_dryrun_") as tmp:
        t0 = time.perf_counter()
        recs = [dryrun.run_cell(arch, DRY_DECODE_SHAPE, False, tmp, device=dev)
                for arch in dryrun.ASSIGNED]
        out["decode_s"] = time.perf_counter() - t0
    out["decode"] = {r["arch"]: {k: r.get(k) for k in ("status", "counted_flops", "t_lower_s",
                                                       "fits_device_memory", "error")}
                     for r in recs}
    print(f"phase 11 (b, {DRY_DECODE_SHAPE} on fake cuda tensors): "
          f"{json.dumps(out['decode'])}", flush=True)
    print(f"phase 11 (b) roofline:\n{report.roofline_table(recs)}", flush=True)
    print(f"phase 11 (b) dry run:\n{report.dryrun_table(recs)}", flush=True)
    failed = [r["arch"] for r in recs if r["status"] != "ok"]
    require(not failed, f"phase 11 (b): {failed} did not trace: "
                        f"{[r.get('traceback') for r in recs if r['status'] != 'ok']}")
    return out


MESH_CELLS = (("gemma2-2b", "train_4k", "pod16x16"),           # phase 12 (a)
              ("deepseek-moe-16b", "prefill_32k", "pod2x16x16"))  # its MoE layers take EP
MESH_REF_ROWS = 4              # (b): batch rows a forward reference computes at once


def check_local_shapes(torch, arch: str, shape: str, mesh_tag: str, dev) -> int:
    """Every parameter of ``arch`` placed on the production mesh (fake
    ``cuda`` tensors) has the local shape ``NamedSharding.shard_shape`` of
    its sanitized spec gives; -> the parameters checked."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun, mesh as mesh_lib
    from repro_torch.models import model as model_lib

    with mesh_lib.production_mesh(multi_pod=dryrun.MESHES[mesh_tag], device=dev) as mesh, \
            FakeTensorMode():
        params, pspecs = model_lib.abstract_init(model_lib.build(dryrun.get_config(arch)),
                                                 dev)
        named = dict(params.named_parameters())
        shardings = sharding.param_shardings(mesh, pspecs, named)
        sharding.distribute_module(params, shardings)
        for name, p in params.named_parameters():
            want = shardings[name].shard_shape(named[name].shape)
            require(tuple(p.to_local().shape) == want,
                    f"phase 12 (a) {arch} {name}: local {tuple(p.to_local().shape)}, "
                    f"shard_shape {want} of {shardings[name].spec}")
    return len(named)


def check_mesh_attention(torch, dev, cases: list) -> list:
    """Phase 12 (b): both flash kernels launched at the local q/k/v shapes
    rank 0's attention op saw in (a)'s trace, on seeded inputs; every
    batch row of ``o`` held against ``attention_ref`` with phase 3b's limit
    (``MESH_REF_ROWS`` rows a reference), and the first and last rows of
    dq, dk, dv against the backward's limit (``ref.attention_bwd_limit``,
    beside a planted fault)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops, ref as flash_ref

    out = []
    for i, c in enumerate(cases):
        (B, Hq, Sq, D), (_, Hkv, Skv, _) = c["q"], c["k"]
        kw = dict(causal=c["causal"], window=c["window"], softcap=c["softcap"])
        q, k, v, do = bwd_inputs(torch, dev, (B, Hq, Hkv, Sq, Skv, D), c["dtype"], 30 + i)
        o, lse = flash_ops.attention(q, k, v, return_lse=True, **kw)
        dq, dk, dv = flash_ops.attention_bwd(q, k, v, o, do, lse, **kw)
        torch.cuda.synchronize()
        fwd = max(flash_err(torch, o[r:r + MESH_REF_ROWS], flash_ref.attention_ref(
            *(t[r:r + MESH_REF_ROWS] for t in (q, k, v)), **kw), c["dtype"])
            for r in range(0, B, MESH_REF_ROWS))
        ends = torch.tensor(sorted({0, B - 1}), device=q.device)
        bwd = bwd_reading(torch, [g.index_select(0, ends) for g in (dq, dk, dv)],
                          *(t.index_select(0, ends) for t in (q, k, v, o, do)), kw)
        out.append({"q": c["q"], "k": c["k"], "dtype": c["dtype"], **kw, "calls": c["calls"],
                    "route": flash_ops.route(q.dtype, D),
                    "bwd_route": flash_ops.bwd_route(q.dtype, D), "fwd_rows": B,
                    "fwd_max_abs_err": fwd, "bwd_rows": ends.tolist(),
                    "bwd": {g: {"ratio": r["ratio"], "fault_ratio": r["fault_ratio"],
                                "max_abs_err": r["max_abs_err"]} for g, r in bwd.items()}})
        del q, k, v, do, o, lse, dq, dk, dv
        gc_free(torch)
    return out


def check_production_meshes(torch, dev) -> dict:
    """Phase 12: the dry run on the reference's production meshes, on fake
    ``cuda`` tensors over a fake process group.  (a) ``MESH_CELLS`` traced
    with ``run_cell``: each ``ok`` with collective bytes, every parameter's
    local shape its sanitized spec's shard shape; the per-rank peak,
    ``fits``, the collective bytes by kind, ``t_collective`` and the trace
    seconds printed; nothing launches (fake tensors).  (b)
    ``check_mesh_attention`` at gemma2-2b's local attention shapes."""
    from repro_torch.analysis import report
    from repro_torch.launch import dryrun

    gc_free(torch)
    out = {"cells": {}}
    recs = []
    with tempfile.TemporaryDirectory(prefix="tspm_mesh_") as tmp:
        for arch, shape, mesh_tag in MESH_CELLS:
            zero_launches()
            rec = dryrun.run_cell(arch, shape, False, tmp, device=dev, mesh=mesh_tag)
            launched = read_launches()
            require(rec["status"] == "ok",
                    f"phase 12 (a) {arch} {shape} {mesh_tag}: {rec.get('traceback')}")
            rf, mem = rec["roofline"], rec["memory_analysis"]
            require(rf["coll_bytes"] > 0, f"phase 12 (a) {arch}: no collective: {rf}")
            require(not any(launched.values()),
                    f"phase 12 (a) {arch}: a fake trace launched {launched}")
            r = {"mesh": mesh_tag, "chips": rec["chips"], "trace_s": rec["t_lower_s"],
                 "peak_bytes_per_rank": mem["peak_size_in_bytes"],
                 "argument_bytes_per_rank": mem["argument_size_in_bytes"],
                 "fits_device_memory": rec["fits_device_memory"],
                 "coll_breakdown": rf["coll_breakdown"], "coll_bytes": rf["coll_bytes"],
                 "t_collective_s": rf["t_collective_s"], "dominant": rf["dominant"],
                 "counted_flops_per_rank": rec["counted_flops"],
                 "attention_local": rec["attention_local"],
                 "params_checked": check_local_shapes(torch, arch, shape, mesh_tag, dev)}
            out["cells"][f"{arch} {shape}"] = r
            recs.append(rec)
            print(f"phase 12 (a, {arch} {shape} on {mesh_tag}): {json.dumps(r)}", flush=True)
    print(f"phase 12 (a) per rank:\n{report.mesh_table(recs)}", flush=True)
    cases = out["cells"][f"{MESH_CELLS[0][0]} {MESH_CELLS[0][1]}"]["attention_local"]
    require(cases, "phase 12 (a): gemma2-2b's trace saw no attention op")
    out["b_attention"] = check_mesh_attention(torch, dev, cases)
    print(f"phase 12 (b, flash kernels at the local shapes): "
          f"{json.dumps(out['b_attention'])}", flush=True)
    return out


# ---- phase 13: a real process group of four ranks on the card -------------------

MESH_WORLD = 4                 # ranks, every one on cuda:0, joined over gloo
MESH_WORLD_LIMIT_S = 400       # the world's own time limit: a rank that hangs fails the phase
MESH_CONVERGE_STEPS = 300      # (e): the reference's drill
MESH_GRAD_STEPS = 3            # (a): the checked step, a timed one and a profiled one
COLLECTIVE_OPS = ("c10d", "gloo", "wait_tensor", "all_reduce", "all_gather", "reduce_scatter",
                  "allreduce", "allgather", "broadcast", "barrier")


def bytes_equal(torch, a, b) -> bool:
    """Whether two tensors hold the same dtype, shape and bytes."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def collective_seconds(prof) -> float:
    """Host seconds inside collective ops (their self CPU time, the wait
    included) of a ``torch.profiler`` run."""
    return sum(e.self_cpu_time_total for e in prof.key_averages()
               if any(k in e.key.lower() for k in COLLECTIVE_OPS)) / 1e6


def mesh_state_tree(torch, model, seed: int) -> dict:
    """A full train state as a plain host tree (``train_loop.state_tree``'s
    layout): ``model``'s parameters and moments drawn from ``seed``, so
    that no leaf is all zeros, step 1."""
    from repro_torch.training import optimizer as opt_lib, train_loop

    gen = torch.Generator("cpu").manual_seed(seed)
    params = {n: p.detach() for n, p in model.named_parameters()}
    mu = {n: torch.randn(p.shape, generator=gen) * 1e-3 for n, p in params.items()}
    nu = {n: torch.rand(p.shape, generator=gen) * 1e-6 for n, p in params.items()}
    step = torch.tensor(1, dtype=torch.int32)
    return train_loop.TrainState(params, opt_lib.OptState(mu, nu, step))


def mesh_world_rank(rank: int, world: int, tmp: str, layers) -> None:
    """Phase 13, one rank of a ``world``-rank ``gloo`` group whose ranks all
    use ``cuda:0``; each mesh is a ``DeviceMesh`` of type ``cuda``.  Rank 0
    holds the comparisons (a failed one raises, and the parent raises with
    its traceback); every rank writes its readings to ``tmp``."""
    sys.path.insert(0, str(SRC))
    import copy
    import faulthandler

    import torch
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs import get_config
    from repro_torch.core import mining, sparsity
    from repro_torch.data import pipeline
    from repro_torch.distributed import compression, sharding
    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.launch.mesh import gloo_cuda_all_gather, make_test_mesh
    from repro_torch.models import layers as layers_lib, model as model_lib
    from repro_torch.training import checkpoint, elastic, train_loop

    faulthandler.enable()          # a rank that crashes prints where
    all_gather = gloo_cuda_all_gather()   # noqa: F841 (registered while it lives)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world)
    out = {"rank": rank}
    t_rank = time.perf_counter()
    try:
        # (a) tspm-mlho, one train step's loss and gradients on a 2 x 2 mesh
        batches, vocab = train_batches(1)
        cfg = get_config("tspm-mlho")
        cfg = cfg.replace(vocab_size=max(cfg.vocab_size, vocab),
                          **({"n_layers": layers} if layers else {}))
        mdl = model_lib.build(cfg)
        base = mdl.init(torch.Generator("cpu").manual_seed(SEED), "cpu")
        loss_fn = train_loop.make_loss_fn(mdl)

        def loss_and_grads(model, batch):
            names, ps = zip(*model.named_parameters())
            loss, _ = loss_fn(model, batch)
            return loss, dict(zip(names, torch.autograd.grad(loss, ps)))

        if rank == 0:
            one = train_loop.trainable(copy.deepcopy(base).to(dev))
            ref_loss, ref_grads = loss_and_grads(
                one, {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()})
            ref_loss = float(ref_loss)
            del one
        named = dict(base.named_parameters())
        specs = layers_lib.param_specs(base)
        specs = {n: specs[n] for n in named}
        mesh = make_test_mesh((2, 2), ("data", "model"), device="cuda")
        module = train_loop.trainable(copy.deepcopy(base).to(dev))
        sharding.distribute_module(module, sharding.param_shardings(mesh, specs, named))
        batch = pipeline.shard_batch(batches[0], mesh)
        steps = []
        for i in range(MESH_GRAD_STEPS):
            profiled = i == MESH_GRAD_STEPS - 1
            if i == 0:
                zero_launches()
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) \
                if profiled else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if prof:
                prof.__enter__()
            with sharding.axis_rules(mesh):
                loss, grads = loss_and_grads(module, batch)
            torch.cuda.synchronize()
            if prof:
                prof.__exit__(None, None, None)
            steps.append({"s": time.perf_counter() - t0,
                          **({"collective_s": collective_seconds(prof)} if prof else {})})
            if i == 0:
                launches = read_launches()
                first = (loss, grads)
        loss, grads = first
        out["a"] = {"layers": cfg.n_layers, "d_model": cfg.d_model, "mesh": [2, 2],
                    "batch": list(batches[0]["tokens"].shape), "steps": steps,
                    "launches": {k: v for k, v in launches.items()
                                 if k.startswith("flash_attention") and v}}
        require(launches["flash_attention"] > 0 and launches["flash_attention_bwd"] > 0,
                f"phase 13 (a) rank {rank}: attention launches {launches}")
        full_loss = float(loss.detach().full_tensor() if isinstance(loss, DTensor) else loss)
        share = {}
        for n, g in grads.items():
            full = g.full_tensor()
            if rank == 0:
                share[n] = ((full - ref_grads[n]).abs().max() / ref_grads[n].abs().max()).item()
        if rank == 0:
            rel = abs(full_loss - ref_loss) / abs(ref_loss)
            worst = max(share, key=share.get)
            out["a"].update(loss=full_loss, loss_one_process=ref_loss, loss_rel=rel,
                            grad_share_max=share[worst], grad_share_worst=worst)
            require(rel <= TRAIN_RTOL, f"phase 13 (a): loss {full_loss} vs {ref_loss}")
            require(share[worst] <= TRAIN_GRAD_SHARE,
                    f"phase 13 (a): the gradient of {worst} differs by {share[worst]}")
            del ref_grads

        # (b) the int8 compressed mean of the local gradients over 'data'
        local = {n: g.to_local() for n, g in grads.items()}
        group = mesh.get_group("data")
        n_data = dist.get_world_size(group)
        t0 = time.perf_counter()
        with sharding.axis_rules(mesh):
            mean, err = compression.tree_compressed_psum_mean(local, "data")
        torch.cuda.synchronize()
        b_s = time.perf_counter() - t0
        worst_ratio = 0.0
        for n, g in local.items():
            exact = funcol.all_reduce(g, "sum", group) / n_data
            gmax = funcol.all_reduce(g.abs().amax(), "max", group)
            scale = torch.clamp(gmax, min=1e-12) / 127.0
            q = compression.quantize(g, scale)
            require(bytes_equal(torch, err[n], g - q.to(torch.float32) * scale),
                    f"phase 13 (b) rank {rank}: the error of {n} is not g - q * scale")
            ratio = ((mean[n] - exact).abs().max() / (scale / 2)).item()
            worst_ratio = max(worst_ratio, ratio)
            # half a step, and the float32 rounding of the two sums
            require(ratio <= 1 + 2 ** -10, f"phase 13 (b) rank {rank}: {n}'s mean is "
                    f"{ratio} half-steps from the exact mean")
        out["b"] = {"leaves": len(local), "s": b_s, "worst_half_steps": worst_ratio}
        del grads, local, mean, err, module, first, loss, batch

        # (c) the elastic drill: the full state from the 2 x 2 mesh through a
        # checkpoint onto the 1 x 2 mesh of ranks 0-1
        tree = mesh_state_tree(torch, base, SEED + 1)
        sp = train_loop.state_pspecs(specs)
        t0 = time.perf_counter()
        placed = elastic.reshard(tree, mesh, sp)
        path = checkpoint.save(f"{tmp}/ckpt", 1, placed)
        del placed
        restored, _ = checkpoint.restore(path, tree)
        small = make_test_mesh((1, 2), ("data", "model"), device="cuda", ranks=[0, 1])
        resharded = elastic.reshard(restored, small, sp)
        leaves = tree_leaves(resharded)
        if rank < 2:
            same = [bytes_equal(torch, x.full_tensor().cpu(), t)
                    for x, t in zip(leaves, tree_leaves(tree))]
            require(all(same), f"phase 13 (c) rank {rank}: {same.count(False)} leaves differ")
        else:
            require(all(x.to_local().numel() == 0 for x in leaves),
                    f"phase 13 (c) rank {rank}: holds a shard of the 1 x 2 mesh")
        torch.cuda.synchronize()
        out["c"] = {"leaves": len(leaves), "s": time.perf_counter() - t0,
                    "state_bytes": sum(t.numel() * t.element_size()
                                       for t in tree_leaves(tree)),
                    "new_mesh_ranks": small.mesh.flatten().tolist()}
        del tree, restored, resharded, leaves, base

        # (d) the Table 1 cohort's hash screen, patient-sharded
        z = np.load(f"{tmp}/cohort.npz")
        idx = np.sort(np.asarray(pipeline.balance_buckets(z["nevents"], world)[rank]))
        e = max(int(z["nevents"][idx].max(initial=0)), 1)
        data_mesh = make_test_mesh((world,), ("data",), device="cuda")
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mined = mining.mine(*(torch.as_tensor(z[k][idx, :e], device=dev)
                              for k in ("phenx", "date")),
                            torch.as_tensor(z["nevents"][idx], device=dev))
        with sharding.axis_rules(data_mesh):
            keep = sparsity.screen_hash(mined.seq, mined.mask, THRESHOLD, H_DEFAULT,
                                        axis_names=("data",))
            kept = int(funcol.all_reduce(keep.sum(), "sum", data_mesh.get_group("data")))
        torch.cuda.synchronize()
        d_s = time.perf_counter() - t0
        d_launches = read_launches()
        table = funcol.all_reduce(
            sparsity.local_bucket_counts(mined.seq, mined.mask, H_DEFAULT), "sum",
            data_mesh.get_group("data")).cpu().numpy()
        out["d"] = {"patients": len(idx), "max_events": e, "s": d_s, "kept_rows": kept,
                    "launches": {k: d_launches[k] for k in ("tspm_pairgen", "seq_hist")}}
        if rank == 0:
            want = np.load(f"{tmp}/table.npy")
            require(table.dtype == want.dtype and table.tobytes() == want.tobytes(),
                    "phase 13 (d): the all-reduced table differs from the one-process table")
            require(kept == int(z["kept"]),
                    f"phase 13 (d): {kept} rows kept, one process keeps {int(z['kept'])}")
        del mined, keep

        # (e) the reference's convergence drill
        pod = make_test_mesh((world,), ("pod",), device="cuda")
        rng = np.random.default_rng(0)
        X = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32)).to(dev)
        y = X @ torch.from_numpy(rng.standard_normal(16).astype(np.float32)).to(dev)
        row = P("pod", None)
        Xd = sharding.distribute(X, NamedSharding(pod, row))
        yd = sharding.distribute(y, NamedSharding(pod, P("pod")))
        err = sharding.distribute(torch.zeros(world, 16, device=dev), NamedSharding(pod, row))

        def step(w, Xs, ys, err):
            g = 2 * Xs.T @ (Xs @ w - ys) / ys.numel()
            g_mean, new_err = compression.compressed_psum_mean(g, "pod", err[0])
            return g_mean, new_err[None]

        w = torch.zeros(16, device=dev)
        t0 = time.perf_counter()
        with sharding.axis_rules(pod):
            for _ in range(MESH_CONVERGE_STEPS):
                g_mean, err = sharding.local_call(step, (w, Xd, yd, err),
                                                  (None, row, P("pod"), row),
                                                  (P(None), row), ((16,), (world, 16)))
                w = w - 0.1 * g_mean.to_local()
        mse = float(((X @ w - y) ** 2).mean())
        out["e"] = {"steps": MESH_CONVERGE_STEPS, "mse": mse, "s": time.perf_counter() - t0}
        require(mse < 1e-3, f"phase 13 (e) rank {rank}: final MSE {mse}")
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        out["rank_s"] = time.perf_counter() - t_rank
        with open(f"{tmp}/rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def check_mesh_world(torch, dev, cohort_npz: str, layers=None) -> dict:
    """Phase 13: ``MESH_WORLD`` processes spawned on ``cuda:0``, joined over
    ``gloo`` (``mesh_world_rank``): (a) tspm-mlho's step on a 2 x 2 mesh
    against one process, (b) the compressed mean of its local gradients,
    (c) the elastic drill at full size, (d) the Table 1 hash screen
    patient-sharded against the one-process table computed here first,
    (e) the convergence drill.  The world has its own time limit."""
    import torch.multiprocessing as tmp_mp

    from repro_torch.core import mining, sparsity

    t_phase = time.perf_counter()
    gc_free(torch)
    z = dict(np.load(cohort_npz))
    with tempfile.TemporaryDirectory(prefix="tspm_world_") as tmp:
        mined = mining.mine(*(torch.as_tensor(z[k], device=dev)
                              for k in ("phenx", "date", "nevents")))
        table = sparsity.local_bucket_counts(mined.seq, mined.mask, H_DEFAULT)
        kept = int(sparsity.screen_hash(mined.seq, mined.mask, THRESHOLD, H_DEFAULT).sum())
        np.save(f"{tmp}/table.npy", table.cpu().numpy())
        np.savez(f"{tmp}/cohort.npz", **z, kept=kept)
        del mined, table
        gc_free(torch)
        t0 = time.perf_counter()
        ctx = tmp_mp.start_processes(mesh_world_rank, args=(MESH_WORLD, tmp, layers),
                                     nprocs=MESH_WORLD, join=False, start_method="spawn")
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > MESH_WORLD_LIMIT_S:
                for p in ctx.processes:
                    p.kill()
                raise RuntimeError(f"phase 13: the {MESH_WORLD}-rank world ran past "
                                   f"{MESH_WORLD_LIMIT_S} s and was killed")
        world_s = time.perf_counter() - t0
        ranks = []
        for r in range(MESH_WORLD):
            with open(f"{tmp}/rank{r}.json") as f:
                ranks.append(json.load(f))
    out = {"world": MESH_WORLD, "device": "cuda:0 for every rank", "backend": "gloo",
           "one_process_kept_rows": kept, "world_s": world_s, "ranks": ranks,
           "peak_device_bytes_by_rank": [r["peak_device_bytes"] for r in ranks],
           "a_step_s": [r["a"]["steps"] for r in ranks],
           "d_s": [r["d"]["s"] for r in ranks],
           "launches": {k: sum(r["a"]["launches"].get(k, 0) + r["d"]["launches"].get(k, 0)
                               for r in ranks)
                        for k in ("tspm_pairgen", "seq_hist", "flash_attention.tf32x3",
                                  "flash_attention_bwd.tf32x3")},
           "phase_s": time.perf_counter() - t_phase}
    for r in ranks:
        print(f"phase 13 rank {r['rank']}: {json.dumps(r)}", flush=True)
    print(f"phase 13 (a) step s by rank (the last step profiled, its host seconds in "
          f"collective ops): {json.dumps(out['a_step_s'])}", flush=True)
    print(f"phase 13 (d) s by rank: {json.dumps(out['d_s'])}; peak device bytes by rank: "
          f"{json.dumps(out['peak_device_bytes_by_rank'])}", flush=True)
    print(f"phase 13 ({MESH_WORLD} ranks over gloo on one card): wall {out['phase_s']:.1f} s, "
          f"the world {world_s:.1f} s, launches {json.dumps(out['launches'])}; "
          f"nvidia-smi: {smi()}", flush=True)
    return out


def flash_rows(routes: dict, lm: dict, timing: dict) -> list:
    """The ``kernels`` line's rows of ``flash_attention``'s three routes:
    tf32x3 at tspm-mlho's shape (float32) and ffma timed in turns with it
    at the same shape (and alone at float32 D 160, zamba2-2.7b's float32
    check), wgmma at gemma2-2b's global layer (bfloat16; both layers and
    the deepseek-moe-16b, pixtral-12b and zamba2-2.7b (D 160) prefill shapes
    beside it); launches from the serving runs (the full-size models serve on
    tf32x3 and wgmma; ffma's are phase 9 (d)'s float32 D 128 prefill and
    (g)'s float32 D 160 prefill),
    max_abs_err over the route's edge cases (``routes``, phase 3b) and
    timed shapes."""
    t = timing["tspm_mlho"]
    ffma = {**t, **t["beside"], "note": "it serves float32 at D 16/32/128/160/256 and "
            "bfloat16 at D 16/32 (phase 9 (d)'s float32 D 128 prefill and (g)'s float32 "
            "D 160 prefill launch it); timed in turns with tf32x3 at tspm-mlho's shape, "
            "and alone at D 160 (float32_d160)"}
    tf32x3 = {**t, "ms_turns_ffma": t["beside"]["ms_turns"]}
    beside = {"wgmma": ("deepseek", "pixtral", "zamba2", "seamless_enc", "seamless_cross"),
              "ffma": ("zamba2_f32",)}
    rows = []
    for route, t, extra in (
            ("tf32x3", tf32x3, {k: tf32x3.get(k) for k in (
                "bound_ffma_ms", "prepass_ms", "main_kernel_ms", "prepass_share",
                "ms_turns", "ms_turns_ffma", "profiler_kernels")}),
            ("ffma", ffma, {**{k: ffma[k] for k in ("bound_ffma_ms", "ms_turns", "note")},
                            "float32_d160": timing["zamba2_f32"]}),
            ("wgmma", timing["gemma2_global"],
             {"library": "flex_attention: card_probe.py flex (a compiled yardstick, "
                         "kept out of this script)",
              **{n: timing[n] for n in ("gemma2_local", "gemma2_global", "deepseek",
                                        "pixtral", "zamba2", "seamless_enc",
                                        "seamless_cross")}})):
        rows.append({"name": f"flash_attention_{route}", "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention/flash.py:24",
                     "launches": lm["flash_launches"][route],
                     "max_abs_err": max([routes[route]["max_abs_err"], t["max_abs_err"]] + [
                         timing[n]["max_abs_err"] for n in beside.get(route, ())]),
                     "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "ms_lse": None if route == "ffma" else t["ms_lse"],
                     "shape": t["shape"], **extra})
    return rows


def flash_bwd_rows(bwd: dict, timing: dict, train: dict) -> list:
    """The ``kernels`` line's rows of ``flash_attention_bwd``, one a route:
    tf32x3 timed at tspm-mlho's training shape with launches from the
    launcher's 100 tspm-mlho steps (phase 10 (b)'s two runs) and phase 10
    (d)'s float32 families at D 64 (the seamless encoder-decoder); ffma
    timed at the same shape forced (``force_route``, in turns with
    tf32x3) and at zamba2-2.7b's float32 D 160, with launches from phase
    10 (d)'s float32 families at D 128 and 160; wgmma at gemma2-2b's, with
    zamba2-2.7b's (D 160), seamless-m4t-large-v2's encoder (D 64,
    non-causal), deepseek-moe-16b's and pixtral-12b's (D 128) beside it,
    launches from phase 10 (c)'s and (e)'s steps; max_abs_err over phase
    3b's comparisons on the route against the plain version (and, for
    ffma, its forced run at tspm-mlho's shape)."""
    def family(phase, key):
        return sum(r["launches"].get(key, 0) for r in train[phase].values())

    tspm = timing["tspm_mlho"]
    beside = tspm["beside"]
    require(beside is not None and beside["route"] == "ffma",
            f"tspm-mlho's backward took {tspm['kernel_route']}")
    ffma = {"kernel_route": "ffma", "ms": beside["ms"], "device_ms": beside["device_ms"],
            "device_share": None, "shape": tspm["shape"] + " (force_route)",
            **{k: tspm[k] for k in ("plain_ms", "bound_ms", "bound_by", "library_ms",
                                    "library_same_function", "bound_ffma_ms")}}
    notes = {
        "tf32x3": "the gradient of that kernel at float32 D 64 on TF32 tensor cores (3xTF32): "
                  "a pre-pass splitting q, do, k, v and the transposed q, do, k into TF32 hi + "
                  "lo, then one launch of dK, dV and dQ CTAs; no atomics",
        "ffma": "the gradient of that kernel on FFMA: a delta pre-pass, a dq and a dk/dv "
                "kernel; no atomics",
        "wgmma": "the gradient of that kernel in bf16: a delta pre-pass and one launch of dK, "
                 "dV and dQ CTAs; no atomics"}
    rows = []
    for route, t, launches, extra in (
            ("tf32x3", tspm, train["b_launcher"]["launches"]["flash_attention_bwd.tf32x3"]
             + train["a_card_vs_cpu"]["launches"]["flash_attention_bwd.tf32x3"]
             + family("d_card_vs_cpu", "flash_attention_bwd.tf32x3"), {}),
            ("ffma", ffma, family("d_card_vs_cpu", "flash_attention_bwd.ffma"),
             {"ms_turns": beside["ms_turns"], "tf32x3_ms_turns": beside["tf32x3_ms_turns"],
              "zamba2_2_7b_f32": timing["zamba2_2_7b_f32"]}),
            ("wgmma", timing["gemma2_2b"],
             train["c_gemma2_2b"]["launches"]["flash_attention_bwd.wgmma"]
             + family("e_families", "flash_attention_bwd.wgmma"),
             {n: timing[n] for n in ("zamba2_2_7b", "seamless_enc", "deepseek_moe_16b",
                                     "pixtral_12b")})):
        require(t["kernel_route"] == route, f"{route}'s timing took {t['kernel_route']}")
        err = bwd["max_abs_err_by_route"][route]
        if route == "ffma":
            err = max(err, beside["max_abs_err"])
        rows.append({"name": f"flash_attention_bwd_{route}", "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
                     "replaces": "src/repro/kernels/flash_attention/flash.py:24",
                     "note": notes[route] + " (jax.grad through the Pallas kernel fails)",
                     "launches": launches, "max_abs_err": err,
                     "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "library_same_function": t["library_same_function"],
                     "bound_ffma_ms": t["bound_ffma_ms"], "device_ms": t["device_ms"],
                     "device_share": t["device_share"], "shape": t["shape"], **extra})
    return rows


def main() -> int:
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    name, card = torch.cuda.get_device_name(0), smi()
    print(f"device: {name} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {json.dumps(host_facts(torch))}", flush=True)
    t0 = time.perf_counter()
    per_source = _build.build_all(COUNT_PROBE_BUILDS)
    print(f"phase 2: built {sorted(per_source)} in {time.perf_counter() - t0:.1f} s "
          f"({json.dumps(per_source)})", flush=True)

    dev = torch.device("cuda", 0)
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        """Seconds since the previous lap, kept under ``name``."""
        now = time.perf_counter()
        laps[name], t_lap[0] = now - t_lap[0], now

    err = check_kernels(torch, dev)
    lap("3_kernel_checks")
    t0 = time.perf_counter()
    raw = make_raw_cohort()
    db = make_cohort(raw=raw)
    print(f"cohort: {db.n_patients} patients, E={db.max_events}, "
          f"{db.total_events} events, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    work = tempfile.TemporaryDirectory(prefix="tspm_smoke_")
    cohort_npz = os.path.join(work.name, "table1.npz")   # phase 13's ranks read it
    np.savez(cohort_npz, phenx=db.phenx, date=db.date, nevents=db.nevents)
    lap("table1_cohort")
    main_path, hash_session = check_main_path(torch, db, dev)
    lap("4_main_path")
    main_path["static_serving"] = check_static_serving(torch, hash_session, db, dev)
    del hash_session
    lap("4c_static_serving")
    files_vs_chunked = check_files_vs_chunked(torch, db, dev)
    lap("4b_chunked_files")
    card_vs_cpu = check_card_vs_cpu(torch, db, dev)
    lap("5_card_vs_cpu")
    hist_paths, kernels = time_kernels(torch, db, dev, err,
                                       main_path["hash"]["launches"])
    fused_t1 = time_fused(torch, db, dev, err)
    fused_t1_launches = fused_fit_launches(torch, db, dev)
    phases = time_fit_phases(torch, db, dev)
    lap("6_timing")
    phases.update(canonicalize_s=main_path["hash"]["canonicalize_s"],
                  fit_s=main_path["hash"]["fit_s"],
                  screen_collect_s=main_path["hash"]["screen_collect_s"])
    stream, delta_launches = check_stream(torch, db, dev)
    lap("8_stream")
    with tempfile.TemporaryDirectory(prefix="tspm_launcher_") as tmp:
        stream["launcher"] = check_launcher(tmp)
    lap("8_launcher")
    stream["serving_launchers"] = check_serving_launchers()
    lap("serving_launchers")
    delta_t = time_delta(torch, db, dev, err)
    kernels.append(kernel_row(
        "tspm_delta", "src/repro/kernels/tspm_delta/delta.py:32", delta_launches, err,
        delta_t["ms"], delta_t["plain_ms"], delta_t["bound"], None, delta_t["shape"]))
    kernels[-1].update({k: delta_t[k] for k in ("wrapper_ms", "device_ms",
                                                "device_ms_by_kernel", "device_bound_share")})
    print(f"seq_hist at the stream's largest tick: {json.dumps(delta_t['hist_tick'])}",
          flush=True)
    kernels[1]["tick"] = delta_t["hist_tick"]
    del db
    lap("6_delta_timing")

    # phase 7's fits plan their chunks against what is allocated at their
    # start: nothing of the phases before may linger, and unreachable
    # sessions in reference cycles (a live session and its server) hold
    # the card until the collector runs
    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"allocated before phase 7: {held} B, {torch.cuda.memory_allocated()} B after "
          f"collecting garbage", flush=True)
    t0 = time.perf_counter()
    db2 = make_cohort(TABLE2_PATIENTS, TABLE2_EVENTS)
    print(f"cohort: {db2.n_patients} patients, E={db2.max_events}, "
          f"{db2.total_events} events, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    lap("table2_cohort")
    table2, fused_launches = check_table2(torch, db2, dev)
    fused_t2 = time_fused(torch, db2, dev, err)
    lap("7_table2")
    # last: the first matmul (attention_ref's einsum, the LM's linears)
    # leaves cuBLAS's workspace allocated, which would count in the mining
    # fits' peaks against their budgets
    before = torch.cuda.memory_allocated()
    flash, n_flash, bf16_readings, flash_routes = check_flash_kernel(torch, dev)
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - before
    print(f"phase 3b: {n_flash} flash_attention comparisons within tolerance (max "
          f"|diff| {json.dumps(flash)}; by route {json.dumps(flash_routes)}); {left} B "
          f"stay allocated after them", flush=True)
    print(f"phase 3b bfloat16 readings: {json.dumps(bf16_readings)}", flush=True)
    bwd = check_flash_bwd_kernel(torch, dev)
    bwd_t = {name: time_flash_bwd(torch, dev, name) for name in BWD_MODEL_SHAPES}
    lap("3b_flash_checks")
    lm, flash_t = check_lm_serving(torch, raw, dev)
    del raw
    lap("9_lm_serving")
    lm["moe_vlm"], moe_t = check_moe_vlm(torch, dev)
    flash_t.update(moe_t)
    lm["flash_launches"]["wgmma"] += sum(
        lm["moe_vlm"][n]["launches"]["flash_attention.wgmma"] for n in ("e_deepseek", "f_pixtral"))
    lm["flash_launches"]["ffma"] += lm["moe_vlm"]["d_card_vs_cpu"]["launches"][
        "flash_attention.ffma"]
    lap("9def_moe_vlm")
    lm["recurrent"], rec_t = check_recurrent(torch, dev)
    flash_t.update(rec_t)
    lm["flash_launches"]["wgmma"] += lm["recurrent"]["h_zamba2"]["launches"][
        "flash_attention.wgmma"]
    lm["flash_launches"]["ffma"] += lm["recurrent"]["g_card_vs_cpu"]["zamba2-2.7b"][
        "launches"]["flash_attention.ffma"]
    lap("9ghi_recurrent")
    lm["encdec"], encdec_t = check_encdec(torch, dev)
    flash_t.update(encdec_t)
    lm["flash_launches"]["wgmma"] += lm["encdec"]["k_serving"]["launches"][
        "flash_attention.wgmma"]
    lm["flash_launches"]["tf32x3"] += lm["encdec"]["j_card_vs_cpu"]["launches"][
        "flash_attention.tf32x3"]
    lap("9jk_encdec")
    gc.collect()
    torch.cuda.empty_cache()
    train = {"a_card_vs_cpu": check_train_card_vs_cpu(torch, dev)}
    lap("10a_train_card_vs_cpu")
    with tempfile.TemporaryDirectory(prefix="tspm_train_") as tmp:
        train["b_launcher"] = check_train_launcher(tmp)
    lap("10b_train_launcher")
    train["c_gemma2_2b"] = check_gemma_training(torch, dev)
    lap("10c_train_gemma2_2b")
    train["d_card_vs_cpu"] = check_family_train_card_vs_cpu(torch, dev)
    lap("10d_families_card_vs_cpu")
    train["e_families"] = check_family_training(torch, dev)
    lap("10e_train_families")
    dry_run = check_dry_run(torch, dev)
    lap("11_dry_run")
    dry_run["production_meshes"] = check_production_meshes(torch, dev)
    lap("12_production_meshes")
    world = check_mesh_world(torch, dev, cohort_npz)
    work.cleanup()
    lap("13_mesh_world")
    for row, key in ((kernels[0], "tspm_pairgen"), (kernels[1], "seq_hist")):
        row["launches"] += world["launches"][key]
        row["launches_phase13"] = world["launches"][key]
    kernels.append(kernel_row(
        "tspm_fused", "src/repro/kernels/tspm_fused/fused.py:134", fused_launches,
        err, fused_t2["ms"], fused_t2["plain_ms"], fused_t2["bound"], None,
        fused_t2["shape"]))
    fused_keys = ("dedup_pairs", "operations", "rounds", "old_ms", "ms_turns", "old_ms_turns",
                  "stage_device_ms", "device_ms_by_kernel",
                  "counted_adds_per_s", "old_adds_per_s", "bound_adds_per_s")
    kernels[-1].update({k: fused_t2[k] for k in fused_keys})
    kernels[-1]["table1"] = {"ms": fused_t1["ms"], "plain_ms": fused_t1["plain_ms"],
                             "bound_ms": max(fused_t1["bound"].values()),
                             "launches": fused_t1_launches, "shape": fused_t1["shape"],
                             **{k: fused_t1[k] for k in fused_keys}}
    kernels += flash_rows(flash_routes, lm, flash_t)
    kernels += flash_bwd_rows(bwd, bwd_t, train)
    for row in kernels:
        key = {"flash_attention_tf32x3": "flash_attention.tf32x3",
               "flash_attention_bwd_tf32x3": "flash_attention_bwd.tf32x3"}.get(row["name"])
        if key:
            row["launches"] += world["launches"][key]
            row["launches_phase13"] = world["launches"][key]
    print(json.dumps({"fit_phases": phases, "main_path": main_path,
                      "files_vs_chunked": files_vs_chunked, "card_vs_cpu": card_vs_cpu,
                      "seq_hist_paths": hist_paths, "table2": table2, "stream": stream,
                      "lm_serving": lm, "training": train, "dry_run": dry_run,
                      "mesh_world": world, "phase_s": laps,
                      "wall_s": time.perf_counter() - t_start}),
          flush=True)
    print(f"phase seconds: {json.dumps(laps)}", flush=True)
    print(f"nvidia-smi: {smi()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
