#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

Phases (any failure ends the run with a non-zero exit):

1. build     compile ``src/repro_torch/kernels/csrc/*.cu`` with nvcc;
2. fold      the reservoir-fold kernel against its plain version,
             bitwise, at the main path's shape ([6, 1,048,576] ring,
             524,288-item chunks): filling, replacement, all-masked and
             ragged chunks, and a sequence of four replacement chunks
             into one ring (bitwise after each, the kernel's scratch
             clean after each); then its times at a replacement chunk,
             its kernels and memsets per call, and its bound from the
             bytes the function needs at that chunk; then the call
             batched over W·K folds (``fold_batches``: ``[W, K, ...]``
             folds of ``[W, M]`` items, the masked ingest's one call a
             chunk, the reference's nested vmap of its kernel): 1, 2 and
             the paper's 4 x 2 folds of [3, 262,144] at 131,072 items a
             shard, the sliding deployment's 4 x 60 of [64, 512] at
             8,192, and the parted form at 1,025 strata, one and two
             payload leaves, folds in replacement, filling and all
             masked: every fold bit for bit the batched plain version's
             and its own unbatched call's, one call counted, the scratch
             clean, 2 or 4 kernels and no memset whatever W·K is
             (``chiprun_out/chip_smoke_fold_batches.json``);
3. stats     the stats kernel against its plain version on [6 x 1,048,576]
             slots: the emission's input, all masked, views that start
             off a 16-byte boundary, 512 random strata over a ragged M
             (counts bit for bit, sums within rtol, the same bits on a
             second call, the tickets 0 after it), the emission's s2
             against float64; then its times at the emission's input
             (``stats_timing``), one kernel and no memset per call, and
             its bound from the bytes the function needs there;
4. main      ``PipelinedExecutor`` on the card: the paper's §5.1 Gaussian
             stream (3 strata), a 10 s window sliding by 5 s, 1,048,576
             items per event-time second, sampling fraction 0.6
             (capacity = N_max = 1,048,576 per stratum per interval),
             24 chunks of 0.5 s, an emission every 4 chunks, queries
             sum / mean / count(x > 5000); every answer must lie within
             3 sigma of the exact float64 value. The 24-chunk window is
             then run again on fresh state (``WINDOWS`` in all) and the
             median and spread of its items/s are printed.

5. one_shot  the one-shot ingest kernel against its plain version,
             bitwise on every output field, at [2, 3, 1,048,576] and
             524,288-item chunks: filling, replacement (counts above
             random capacities), a frontier crossing an interval boundary
             with every slot reset, late items, an all-masked chunk, a
             ragged one, and a sequence of four replacement chunks
             through one carried state; a payload of two leaves
             (``{"val": f32, "key": i32}``, the reference's pytree
             payloads) on the replacement, crossing and late cases, bit
             for bit the plain version and the one-leaf call; then, as
             for the fold, its times, kernels, memsets and bound at a
             replacement chunk in which every masked-in item is live,
             and its device time with one leaf and with two in turns;
             then the call batched over W shards (``[W, ...]`` tensors,
             the reference's vmapped kernel): at W = 1, 2 and 4, in the
             small form on the paper's 4 workers' [4, 2, 3, 262,144]
             ring and in the parted form on the sliding deployment's
             [4, 60, 64, 512], shards all masked, late, crossing and
             steady, every field bit for bit the batched plain version's
             twice, one call counted, the scratch clean, 3 or 5 kernels
             and no memset whatever W is; then one batched call (B)
             against W unbatched calls (A) in turns A B B A at the
             paper's ring with [4, 131,072] items and the sliding ring
             with [4, 8,192] and [4, 131,072], beside the bound W times
             a shard's bytes (``chiprun_out/
             chip_smoke_one_shot_shards.json``);
6. paths     the same deployment on a disordered stream (30% of items
             shifted back by U(0, 0.75) s): (a) pipelined fused, (b)
             pipelined onekernel, (c) batched onekernel, (d) pipelined
             masked, all on cadence, and (e) pipelined and (f) batched
             onekernel under watermark emission. (b)-(d) end in (a)'s
             state bit for bit and (b), (c) emit (a)'s emissions; (e) and
             (f) close the same intervals once each with the same answers;
             every answer lies within 3 sigma of the exact value over the
             items the script itself finds accepted; (d) makes one fold
             call a chunk, batched over its K slots.
7. weighted_hist
             the weighted-histogram kernel against its plain version at
             the emission's shape ([6 x 1,048,576] slots): uniform, log2
             and narrow edges (a later refinement round: most items
             outside), all masked, collapsed edges, values on the edges,
             ragged M, the largest G*B (counts bit for bit, mass within
             rtol of f64, the same bits on a second call, the tickets 0
             after it); then its times at the uniform, log2 and narrow
             inputs (``whist_timing``), one kernel and no memset per
             call, and each bound from the bytes the function needs;
8. nonlinear the paper's §6.1 network-traffic deployment (NetFlow stream,
             3 protocols) at phase main's ring size, 12 chunks, with sum,
             per-protocol and session sums, both quantile methods, a
             per-protocol quantile, a log2 histogram, top-8 heavy hitters
             and distinct count: (1) pipelined fused, (2) pipelined
             onekernel, (3) batched onekernel on cadence, (4) pipelined
             onekernel on the watermark. (2), (3) end in (1)'s state and
             answers bit for bit; every answer is checked against the
             exact window the script keeps on the card; the emission
             latency of this registry and of phase main's.
9. recovery  exactly-once recovery at phase main's width: (a) pipelined
             fused on cadence, (b) pipelined onekernel on the watermark
             (phase paths' disordered stream), (c) batched onekernel on
             cadence, each with a checkpoint every 5 chunks (inside the
             4-chunk emission periods) and one at offset 0, killed after
             chunks 6, 12 and 21 (only the payload's bytes survive),
             restored into an executor built with another key and
             replayed from the payload's offset: the deduped emissions
             and the final state bit for bit the uninterrupted run's;
             then the payload's bytes, a capture's device-to-host copy
             and serialization, a restore's deserialization and
             host-to-device copy, the replay times and items/s of (a)
             with no checkpointer, every 4 chunks and every chunk, in
             turns; save and restore events in
             ``chiprun_out/chip_smoke_recovery_events.jsonl``, reduced by
             ``obs.export.checkpoint_stats``; and phase nonlinear's path
             (2) killed after chunk 6, its emissions bit for bit.
10. sharded  the paper's §5.1 deployment with its 4 workers on the card
             (``num_shards=4``, ``placement="vmap"``): per-shard capacity
             = N_max = 262,144, ring [4, 2, 3, 262,144] f32 (phase main's
             bytes), chunks [4, 131,072] from ``stamp_sharded`` at
             262,144 items/s per shard. (a) pipelined fused on cadence:
             every answer within 3 sigma, ingested = accepted + dropped,
             all 24 x 524,288 items ingested; one emission of the
             histogram queries at W = 4; (b) the ingest alone: the
             W = 4 state bit for bit four W = 1 states (each its shard's
             rows, key ``split(key, 4)[w]``, capacity 262,144), one fold
             launch per chunk; (c) on a disordered sharded stream,
             pipelined fused, masked and onekernel on cadence bit for bit
             equal, batched onekernel and pipelined fused on the
             watermark too, with the launches per chunk (fold 1, the
             masked path's one call over the W x K folds; one-shot 1: one
             call over the W shards) and stats per emission (2). In (a),
             (b) and (c) every kernel call is held to its plain version on
             clones of its inputs (``HeldToPlain``): the fold over the
             24 cells of [24, 262,144] with 524,288 items and over the
             masked path's [4, 2, 3, 262,144] folds, the one-shot on the
             [4, 2, 3, 262,144] ring with [4, 131,072] items, stats at
             G = 24 and
             the histogram at G x B = 24 x 32 over the merged view;
             (d) items/s of W = 4 beside phase main's W = 1 in turns (5
             windows each), device activities and host torch ops per
             ingest chunk of both, one emission's ms at W = 4; (e) recovery at W = 4 killed after
             chunks 6 and 21, bitwise; (f) the mesh line (no NCCL is
             run). Figures in ``chiprun_out/chip_smoke_sharded.json``.
11. rescale  restore-time elastic rescale at full width: 24 chunks in
             segments of 1, 4 and 1 shards (8 chunks each; ring
             [2, 3, 1,048,576] at W = 1, [4, 2, 3, 262,144] at W = 4), on
             (a) pipelined fused on cadence over the in-order streams and
             (b) batched onekernel on the watermark over the disordered
             ones. At each boundary the batched executor flushes, the
             executor is captured, ``checkpoint.migrate`` re-packs the
             payload for the next width's shard count and slot width, and
             it is serialized, deserialized and restored into the next
             width's executor; the invariants hold there (Σ counts per
             cell, taken <= capacity <= N_max, Σ watermark and device
             counters, the occupancy gauge). Every answer lies within 3
             sigma of the exact value over the items the script itself
             finds accepted (per shard, with the frontiers pooled as
             ``migrate`` pools them). With a checkpoint every 3 chunks,
             kills after chunks 5, 8, 9, 16, 17 and 23 recover (replay at
             the payload's width, every later rescale re-done) to the
             uninterrupted schedule's emissions and final state bit for
             bit. One fold or one-shot call per chunk at W = 1 and 4.
             ``HeldToPlain`` holds every kernel call of the
             uninterrupted and checkpointed runs and of each recovery,
             which then runs again unheld for its restore and replay
             times; two timed runs (unheld) give each boundary's payload
             bytes and capture / migrate / to_bytes / from_bytes / restore
             ms and each segment's items/s; the mesh line (no NCCL is
             run).
             Figures in ``chiprun_out/chip_smoke_rescale.json``.
12. systems  the paper's five-system comparison (§5), each system built
             from the port's modules as ``benchmarks/systems.py`` builds
             it from the reference's (``five_systems``): native,
             oasrs_batched, oasrs_pipelined (one fold per lane), srs and
             sts. (a) fig7b's window at the reference's own width: 65,536
             items of the skewed Gaussian stream (aggregator seed 4),
             fraction 0.4, lane 256; native within ANSWER_RTOL of the f64
             sum, the others within 3 sigma, SRS selecting exactly k and
             STS exactly ceil(0.4 C_i) per stratum. (b) one 10 s window
             of the §5.1 stream at RATE: 20 chunks of M from
             ``ReplayableStream``, 10,485,760 items, fraction 0.6
             (capacity 2,097,152 per stratum), lane 65,536 (160 folds);
             SRS is held to 3 sigma around the f64 sum scaled by its own
             count estimate (the reference's f32 running sum of the
             weights, which drifts at this width). In (a) and (b) one
             window of each system has every fold and stats call held to
             its plain version, its launches per window checked, then
             SYS_RUNS windows of each are timed in turns
             (``replay.measure_window_program``); (b) also records each
             system's device activities and busy share (profiler; the
             pipelined system traced on a tenth of its window) and
             the OASRS/native, OASRS/SRS and OASRS/STS ratios. (c) the
             substrate: ``chunk_at`` twice bit for bit, ``range(7, 24)``
             against ``prefix(24)[7:]`` with disorder and a key gap, ms
             per generated chunk, and a ``MeteredStream`` over a 24-chunk
             pipelined run (its summary the exact count and span, no
             device-to-host read while it meters). (d)
             ``oasrs.update_stream`` of 1,024 items on the card (no read
             back to the host), bit for bit the same call on the CPU. Figures in
             ``chiprun_out/chip_smoke_systems.json``.
13. serve    ``phi4-mini-3.8b`` at full width in bf16 served by
             ``serve_step.Server`` with StreamApprox telemetry (its
             docstring); ``chiprun_out/chip_smoke_serve.json``.
14. train    ``launch/train.train`` on ``phi4-mini-3.8b`` at full width in
             bf16 with the reference CLI's defaults (20 steps, batch 8 of
             windows of 16 sequences of 128 tokens, 8 domains): every
             fold held to its plain version (20 launches at [8, 4]), each
             window's sample bit for bit a CPU run, step 1's loss against
             its f32 recomputation, an AdamW slice against the formula,
             the loss falling; step ms, tokens/s, the optimizer's device
             ms, peak memory, busy share, host ops and the bound; then
             the resume path at the smoke config (the restored state bit
             for bit the saved one, the resumed losses against the
             uninterrupted run's). ``chiprun_out/chip_smoke_train.json``.
15. families the families beyond dense at full width in bf16:
             ``xlstm-350m`` (ssm), ``granite-moe-3b-a800m`` (moe),
             ``recurrentgemma-9b`` (hybrid), ``seamless-m4t-large-v2``
             (encdec, 24 + 24 layers) and ``internvl2-76b`` (vlm, 16 of
             its 80 layers). Each is served by phase serve's own path
             (``serve_model``: ``init_params(PRNGKey(0))`` on the card,
             two leaves' first draws against the CPU's;
             ``Server.generate`` of 8 prompts of 2,048 tokens, 512 for
             the xLSTM, with 2,048 frames each for encdec and 256 patches
             for vlm, for 16 steps, 4 tenants, every fold and stats
             call held to its plain version, the telemetry read back and
             checked; the loop timed, each figure beside its bound; (c)
             decode steps 1, 2, 3 and 16 against a prefill over prompt +
             t tokens, logits and every state leaf, logged in bf16 and
             gated on an f32 copy, internvl2-76b's of its first 2
             layers; for moe also the dispatch at the served capacity
             and at one where experts overflow against a plain plan and
             loop), then trained by phase train's path at its defaults
             (recurrentgemma-9b and xlstm-350m at 6 blocks, internvl2-76b
             at 2 layers, full width; encdec and vlm batches carry their
             step's frames or patches beside the sampled tokens).
             ``chiprun_out/chip_smoke_families.json``.
16. dryrun   the multi-pod dry-run tooling (``launch/specs``,
             ``launch/dryrun``, ``distributed/compression``): (a) in a
             subprocess on the host, ``run_cell`` of phi4-mini-3.8b's
             train_4k, prefill_32k and decode_32k on the (16, 16) fake
             mesh, every record OK and its argument bytes equal to the
             shard bytes worked out from ``param_specs`` and the input
             shapes alone; (b) meanwhile rank 0 of that fake group runs
             the same three programs on the card, at full width in bf16,
             its shards of seeded random inputs on a ``cuda`` mesh (the
             fake group moves no data): per program its local ops and
             collectives counted, wall ms, the profiler's device-busy ms,
             peak memory, every output finite and of its shape, the
             roofline's compute and memory terms at the H100 figures;
             (c) ``psum_bf16``, ``psum_int8`` and
             ``hierarchical_grad_sync`` on a one-rank ``pod × data``
             mesh, NCCL on the card, bit for bit the same calls over
             gloo on the CPU. ``chiprun_out/chip_smoke_dryrun.json``.
17. payloads (a) the fold kernel on payload trees at the main path's
             chunk (524,288 items into [6, 1,048,576] cells): ``{"val":
             f32, "key": i32}`` and ten leaves (``f32 [3]``, bf16, bool,
             i64, six f32), a replacement and a filling chunk, every leaf
             and the counts bit for bit the plain version's, the scratch
             clean after every call; the device and event times of the
             scalar call and both trees in turns (2, 2 and 3 kernels per
             call, no memset), each beside its bound; (b) the six
             examples ``examples/torch_*.py`` at their default sizes on
             the card, each one's wall time and last estimate line, their
             launches counted in the kernels' JSON line.
             ``chiprun_out/chip_smoke_payloads.json``,
             ``chiprun_out/chip_smoke_examples.txt``.
18. large_keys
             the four kernels past the key counts a block's shared
             memory holds, where each takes its large-key form: the fold
             at 1,025, 15,360 and 262,144 cells, the one-shot at K·S =
             1,025, 60 x 64 and 4 x 65,536, the stats at 513, 15,360 and
             262,144 rows and the histogram at 97 x 33, 15,360 x 32 and
             262,144 x 32 keys (the main path's 524,288-item chunks, the
             stress's 4,194,304), each against its plain version (the
             fold and one-shot bit for bit; counts bit for bit and sums
             within rtol, the same bits twice), the scratch clean, then
             timed: device ms, kernels per call, bound by bytes; the
             stats and histogram cases also through their row form (the
             [G, N] view, one launch) against its plain version, the row
             and parted forms in turns (R P P R) with each one's bound,
             and the library call at the same size; each stats and
             histogram case also with ids drawn at random (the parted
             form beside the library call on those ids); every parted
             call in the plan's launches and no memset;
             ``query.exact_stats`` and STS's ``baselines.sample_stats``
             at S = 65,536 over 4,194,304 items, each held to its plain
             version, in the parted form; then a one-minute
             window sliding every second over 64 sub-streams on 4 shards
             (K = 60, S = 64, W = 4, N_max = 512 a shard) through the
             pipelined fused and onekernel paths for two emissions (sum,
             mean, count and a hist median), each held to one fused run
             on the CPU, its stats and histogram launches all of the row
             form, one fold or one-shot call per chunk of 4 shards, its
             launches counted in the JSON line, one emission's
             evaluation in turns with the flat route (R F F R).
             ``chiprun_out/chip_smoke_large_keys.json``.

Every stream is the reference's: ``StreamAggregator`` draws, ids and
event times bit for bit (phases paths' and sharded's disorder is drawn
from a seeded ``torch.Generator``).

Then it prints the kernels' JSON line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py [--seed N]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.launch.mesh import H100_SXM5  # noqa: E402  (the checkout's)

HBM_BYTES_PER_S = H100_SXM5.hbm_bytes_per_s   # H100 SXM data sheet
BF16_OPS_PER_S = H100_SXM5.peak_flops_bf16
F32_OPS_PER_S = 67e12              # H100 SXM f32 outside the tensor cores

K, S = 2, 3                        # ring intervals, strata
N_MAX = 1_048_576                  # capacity per stratum per interval
M = 524_288                        # items per chunk (0.5 s of events)
RATE = 1_048_576.0                 # items per event-time second
SPAN, LATENESS = 5.0, 0.5          # 10 s window sliding by 5 s
ONE_SHOT_KW = dict(span=SPAN, allowed_lateness=LATENESS)
CHUNKS, EMIT_EVERY = 24, 4
WINDOWS = 7                        # timed runs of the 24-chunk window
PATH_WINDOWS = 3                   # timed runs of each path in phase paths
SHIFT_P, SHIFT_MAX = 0.3, 0.75     # disorder: share shifted back, by U(0, s)
# The disordered stream starts a quarter second into event time. Were its
# chunk boundaries on interval boundaries, the watermark before the chunk
# after a crossing would trail the boundary by under one item's spacing
# (the lateness equals the chunk span), and no item could be late.
DISORDER_T0 = 0.25
THRESHOLD = 5000.0                 # count(x > 5000)
NL_CHUNKS = 12                     # phase nonlinear: 6 s of events
NL_QS = (0.5, 0.9, 0.99)           # merged quantile levels
NL_KEY_QS = (0.5, 0.99)            # per-protocol quantile levels
LOG2_EDGES = tuple(float(2 ** i) for i in range(25))   # 2^0 ... 2^24
SESSION_GAP = 5.0                  # one interval
TOP_K = 8
Q_SLACK = 0.005                    # quantile ranks checked at q ± 0.005
REFINE_BINS, REFINE_STEPS = 32, 4  # quantile_refine's defaults
HIST_LAUNCHES = 1 + len(NL_QS) * REFINE_STEPS   # weighted_hist/emission
LATENCY_REPS = 3                   # timed evaluations per registry
TIMING_SEED = 14                   # inputs of every kernel's timing
PROFILE_TRIES = 10                 # traces of one window, as needed
DRYRUN_HOST_TIMEOUT_S = 600        # phase dryrun (a)'s subprocess
STATS_RTOL = 1e-5                  # kernel vs the plain version's f32 sums
S2_RTOL = 1e-3                     # f32 s2 (three digits cancel) vs f64
ANSWER_RTOL = 1e-5                 # f32 rounding beside the 3-sigma bound
RECOVERY_EVERY = 5                 # checkpoint cadence: inside periods of 4
RECOVERY_CRASHES = (6, 12, 21)     # chunks pushed before each crash
RECOVERY_REPS = 3                  # timed captures/restores, runs per cadence
W_SHARDS = 4                       # phase sharded: the paper's 4 workers
M_SHARD = M // W_SHARDS            # items per shard per chunk
RATE_SHARD = RATE / W_SHARDS       # items per event-time second per shard
N_SHARD = -(-N_MAX // W_SHARDS)    # split_capacity(N_MAX, 4) = N_max
SHARDED_WINDOWS = 5                # timed windows of W = 1 and W = 4, in turns
SHARDED_CRASHES = (6, 21)          # phase sharded: chunks before each crash
RESCALE_SEGMENTS = ((1, 8), (W_SHARDS, 8), (1, 8))   # (W, chunks): 1->4->1
RESCALE_EVERY = 3                  # phase rescale: checkpoint cadence
RESCALE_CRASHES = (5, 8, 9, 16, 17, 23)   # before, at, after each boundary
RESCALE_TIMED = 2                  # timed runs of each rescaled schedule
SYSTEMS = ("native", "oasrs_batched", "oasrs_pipelined", "srs", "sts")
SYS_A = dict(items=65_536, fraction=0.4, lane=256, seed=4)   # fig7b
SYS_B = dict(chunks=20, fraction=0.6, lane=65_536)   # one 10 s window
SYS_RUNS = 5                       # timed runs of each system, in turns
SYS_REPLAY = 24                    # phase systems (c): chunks replayed
SYS_ITEMS_D = 1_024                # phase systems (d): items one by one
SERVE_ARCH = "phi4-mini-3.8b"      # phase serve: full config, bf16
SERVE_REQUESTS = 8
SERVE_PROMPT = 2_048               # two 1,024-query blocks of attention
SERVE_STEPS = 16
SERVE_TENANTS = 4
SERVE_CAPACITY = 256               # > 8 x 16 records: every one is kept
SERVE_BITS_CHECKED = 1 << 20       # init elements checked against the CPU
SERVE_CACHE_BATCH = 2              # requests of the cache-consistency check
SERVE_LOGIT_ATOL = 0.125           # decode vs prefill logits, bf16 model
SERVE_CACHE_RTOL = 2.0 ** -5       # decode vs prefill K/V, of max |K/V|
SERVE_PREFILLS = 3                 # timed prefills
TRAIN_ARCH = "phi4-mini-3.8b"      # phase train: full config, bf16
TRAIN_STEPS = 20                   # launch/train's defaults: 20 steps,
TRAIN_BATCH = 8                    # batch 8 of 16 sequences per window
TRAIN_SEQ = 128                    # (fraction 0.5), 128 tokens, 8 domains
TRAIN_DOMAINS = 8
TRAIN_FRACTION = 0.5
TRAIN_PROFILED_STEP = 15           # the step traced for busy share, ops
TRAIN_CHECKED_STEP = 3             # the step whose AdamW slice is checked
TRAIN_SLICE = 4096                 # elements of that slice
TRAIN_LEAF = "dense_layers.mlp.w_in"   # the largest leaves
TRAIN_LOSS_RTOL = 2e-2             # step 1's bf16 loss vs the f32 one
TRAIN_ADAM_RTOL = 1e-6             # the slice vs the functional formula
TRAIN_RESUME_RTOL = 1e-3           # resumed losses vs uninterrupted, smoke
FAMILY_ARCHS = ("xlstm-350m", "granite-moe-3b-a800m", "recurrentgemma-9b",
                "seamless-m4t-large-v2", "internvl2-76b")
# The xLSTM's serving prompt: its prefill is a Python loop over time
# (24 blocks x 2,048 steps, ~1.1 M host torch ops, 8.4-15.2 s at 8 x 2,048
# on an H100 80GB HBM3 at 700 W), and a serve pass runs 1 + SERVE_PREFILLS
# + len(FAMILY_CACHE_STEPS) of them.
FAMILY_SSM_PROMPT = 512
FAMILY_CACHE_STEPS = (1, 2, 3, SERVE_STEPS)   # decode steps of (c) checked
# (c): the MoE dispatch is also checked at this capacity factor, where
# experts overflow: at the served 1.25 a 2,048-token row of
# granite-moe-3b-a800m dropped none of its 16,384 assignments on an H100.
MOE_TIGHT_CAPACITY = 1.0
# Layers (blocks) trained at full width, and why: recurrentgemma-9b's AdamW
# state for its 38 blocks (~14 B per parameter, ~146 GB) exceeds the card
# (two periods of (rec, rec, attn) keep every block kind); so would
# internvl2-76b's for 3 of its 80 layers (1.711 GB a layer in bf16);
# xlstm-350m's 20 steps took 171 s of the script at 24 blocks, and 6 (three
# (mLSTM, sLSTM) periods) keep every block kind.
FAMILY_TRAIN_LAYERS = {
    "recurrentgemma-9b": (6, "the AdamW state of all would exceed the "
                          "card"),
    "xlstm-350m": (6, "three (mLSTM, sLSTM) periods: the time limit of the "
                   "whole script"),
    "internvl2-76b": (2, "the AdamW state of 3 layers (~14 B per "
                      "parameter) would exceed the card"),
}
# Layers served at full width: internvl2-76b's 80 layers are 141 GB of
# bf16 weights; 16 are 31.6 GB. Its decode-vs-prefill gate (c) runs on an
# f32 copy of its first FAMILY_GATE_LAYERS (the training depth): an f32
# copy of the 16 served would not fit beside them.
FAMILY_SERVE_LAYERS = {"internvl2-76b": 16}
FAMILY_GATE_LAYERS = {"internvl2-76b": 2}
# The frontend stubs' inputs drawn in phase families' training: one key,
# folded with the step.
FRONTEND_KEY = 0x46524F4E
# Families whose training step is not traced: xlstm-350m's step is
# ~340,000 host torch ops (its time loop), and a trace of one took 126 s
# on an H100 80GB HBM3 at 700 W (busy 0.201 of the step).
FAMILY_UNTRACED = ("xlstm-350m",)
# Per family, a large leaf: its first draws checked against the CPU's
# (serving) and its AdamW slice checked against the formula (training).
FAMILY_LEAF = {"xlstm-350m": "blocks.0.w_up",
               "granite-moe-3b-a800m": "moe_layers.moe.w_in",
               "recurrentgemma-9b": "blocks.0.mlp.w_in",
               "seamless-m4t-large-v2": "decoder.mlp.w_in",
               "internvl2-76b": "dense_layers.mlp.w_in"}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, torch, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_profile(fn, torch, reps: int = 10) -> dict:
    """Per call of ``fn``, from a ``torch.profiler`` trace of ``reps``
    calls: ``{name: (device ms, launches)}`` of each kernel and memset.
    ``fn`` launches the same work every call, so each name's count is a
    whole multiple of the calls traced; the tracer now and then drops
    events at the start of a trace (a window with no device activity,
    or the first 55 events of every window, whatever its length), so
    each window follows a warm-up step of as many calls that the trace
    discards (``torch.profiler.schedule``); a window that still lost
    events is profiled again with twice the calls, up to
    ``PROFILE_TRIES`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for t in range(PROFILE_TRIES):
        calls = reps << min(t, 4)
        split = {}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):          # the warm-up step, then the window
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        for e in prof.events():
            # the step's own span on the card is no launch
            if e.device_type == DeviceType.CUDA and \
                    not e.name.startswith("ProfilerStep"):
                name = ("memset" if "Memset" in e.name else e.name.replace(
                    "(anonymous namespace)::", "").split("(")[0])
                us, n = split.get(name, (0.0, 0))
                split[name] = (us + e.time_range.elapsed_us(), n + 1)
        if split and all(n % calls == 0 for _, n in split.values()):
            break
        log(f"[profile] trace of {calls} calls dropped device events "
            f"({', '.join(f'{k} x{n}' for k, (_, n) in split.items())}); "
            f"profiling again")
    return {k: (us / calls / 1e3, n / calls)
            for k, (us, n) in split.items()}


def log_launches(tag: str, prof: dict) -> tuple:
    """Log the kernels and memsets per call of a profile; returns them."""
    memsets = sum(n for k, (_, n) in prof.items() if k == "memset")
    kernels = sum(n for k, (_, n) in prof.items() if k != "memset")
    names = ", ".join(f"{k} x{n:g}" for k, (_, n) in sorted(prof.items()))
    log(f"[{tag}] per call: {kernels:g} kernels, {memsets:g} memsets "
        f"({names}); device ms {sum(v[0] for v in prof.values()):.4f}")
    return kernels, memsets


def small_form(kernel: str, prof: dict) -> None:
    """Log a profile's kernels and memsets per call; fail unless they are
    the small-key form's (SMALL_FORM_LAUNCHES, no memset)."""
    if log_launches(kernel, prof) != (SMALL_FORM_LAUNCHES[kernel], 0):
        fail(f"{kernel}: not the small form's {SMALL_FORM_LAUNCHES[kernel]} "
             "kernels and no memset per call")


def one_launch(tag: str, prof: dict) -> None:
    """Log a profile's kernels and memsets per call; fail unless they are
    one kernel and no memset."""
    if log_launches(tag, prof) != (1, 0):
        fail(f"{tag}: not one kernel and no memset per call")


def claim_tiles(m: int) -> int:
    """Tiles (blocks of each launch) of a fold or one-shot call."""
    from repro_torch.kernels import _build, _workspace
    return _workspace.tiles(_build.build().lib, m)


def listed_items(torch, m: int, cells: int = 0) -> int:
    """Accepted items of the last fold or one-shot call of ``m`` items
    over ``cells`` cells: the entries of the per-warp lists its claim
    pass wrote (over the parted form's claim grid past 1,024 cells)."""
    from repro_torch.kernels import _build, _workspace
    from repro_torch.kernels.reservoir import MAX_STRATA
    dev = torch.device("cuda", torch.cuda.current_device())
    ws = _workspace.get(dev, torch.cuda.current_stream(dev).cuda_stream)
    lists = _build.build().lib.sa_fold_tile_lists()
    tiles = (_workspace.parted_plan(cells, m).claim_grid
             if cells > MAX_STRATA else claim_tiles(m))
    return int(ws.list_n[:tiles * lists].sum())


def workspace_clean(torch) -> bool:
    """The kernels' kept scratch is as the next call needs it: the winner
    table all -1, the look-back words, the counters, the tickets and the
    parted forms' totals and tickets all 0."""
    from repro_torch.kernels import _workspace
    dev = torch.device("cuda", torch.cuda.current_device())
    ws = _workspace.get(dev, torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    return bool((ws.winner == -1).all()) and not any(
        bool(t.any()) for t in (ws.status, ws.counters, ws.tickets,
                                ws.part_zeroed))


def log_split(tag: str, split: dict, event_ms: float) -> None:
    total = sum(split.values())
    parts = ", ".join(f"{k} {v:.4f}" for k, v in
                      sorted(split.items(), key=lambda kv: -kv[1]))
    log(f"[{tag}] device ms per call (profiler): {parts}; sum {total:.4f} "
        f"of {event_ms:.4f} ms by events around back-to-back calls")


def phase_build():
    from repro_torch.kernels import _build
    lib = _build.build()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_build.log").write_text(lib.log)
    log(f"[build] {lib.path.name} in {lib.build_seconds:.2f} s "
        f"(ptxas log in chiprun_out/chip_smoke_build.log)")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


def fold_inputs(torch, gen, m, cells, counts, capacity, mask_p=0.97):
    dev = gen.device
    return dict(
        stratum_ids=torch.randint(0, cells, (m,), generator=gen, device=dev,
                                  dtype=torch.int32),
        payload=torch.randn(m, generator=gen, device=dev) * 100.0,
        u_accept=torch.rand(m, generator=gen, device=dev),
        u_slot=torch.rand(m, generator=gen, device=dev),
        mask=torch.rand(m, generator=gen, device=dev) < mask_p,
        counts=counts, capacity=capacity)


def phase_fold(torch, gen):
    from repro_torch.kernels import ref, reservoir
    dev = gen.device
    cells = K * S
    i32 = dict(dtype=torch.int32, device=dev)
    full = torch.full((cells,), N_MAX, **i32)
    cases = {
        "filling": fold_inputs(torch, gen, M, cells,
                               torch.zeros(cells, **i32), full),
        "replacement": fold_inputs(
            torch, gen, M, cells,
            torch.randint(2_000_000, 3_000_000, (cells,), generator=gen,
                          **i32),
            torch.randint(1, N_MAX + 1, (cells,), generator=gen, **i32)),
        "all_masked": fold_inputs(torch, gen, M, cells,
                                  torch.zeros(cells, **i32), full,
                                  mask_p=0.0),
        "ragged": fold_inputs(torch, gen, M - 77, cells,
                              torch.full((cells,), N_MAX - M // 20, **i32),
                              full),
    }
    worst = 0.0
    for name, inp in cases.items():
        start = torch.randn((cells, N_MAX), generator=gen, device=dev)
        v_kernel, v_plain = start.clone(), start.clone()
        c_kernel = reservoir.reservoir_fold(values=v_kernel, **inp)
        c_plain = ref.reservoir_fold(values=v_plain, **inp)
        torch.cuda.synchronize()
        same = (torch.equal(v_kernel.view(torch.int32),
                            v_plain.view(torch.int32))
                and torch.equal(c_kernel, c_plain))
        err = float((v_kernel - v_plain).abs().max())
        worst = max(worst, err)
        changed = int((v_kernel != start).sum())
        log(f"[fold] {name}: M={inp['stratum_ids'].numel()} bitwise="
            f"{same} cells_changed={changed} counts={c_kernel.tolist()}")
        if not same:
            fail(f"fold kernel differs from its plain version ({name})")

    if not workspace_clean(torch):
        fail("fold kernel left its winner table or look-back words dirty")

    # Four successive replacement chunks into one ring, each on the counts
    # the last one left.
    rep = cases["replacement"]
    start = torch.randn((cells, N_MAX), generator=gen, device=dev)
    v_kernel, v_plain = start.clone(), start.clone()
    c_kernel = c_plain = rep["counts"]
    for i in range(4):
        inp = fold_inputs(torch, gen, M, cells, c_kernel, rep["capacity"])
        c_kernel = reservoir.reservoir_fold(values=v_kernel, **inp)
        c_plain = ref.reservoir_fold(values=v_plain, **dict(inp,
                                                           counts=c_plain))
        same = (same_bits(torch, v_kernel, v_plain)
                and torch.equal(c_kernel, c_plain))
        clean = workspace_clean(torch)
        log(f"[fold] sequence chunk {i}: bitwise={same} scratch clean="
            f"{clean} counts={c_kernel.tolist()}")
        if not (same and clean):
            fail(f"fold kernel differs from its plain version (sequence "
                 f"chunk {i}) or left its scratch dirty")

    t = fold_timing(torch, dev)
    need = fold_need(torch, t["inputs"])
    n_ops = 12 * M                     # ~a dozen integer/f32 ops per item
    bound = max(need["bytes"] / HBM_BYTES_PER_S,
                n_ops / F32_OPS_PER_S) * 1e3
    log(f"[fold] replacement chunk: kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, bound {bound:.4f} ms ({need['bytes']} B "
        f"the function needs: {need['live']} live, {need['tested']} past "
        f"capacity, {need['accepted']} accepted, {need['won']} cells won)")
    log_split("fold", {k: v[0] for k, v in t["prof"].items()}, t["ms"])
    small_form("fold", t["prof"])
    fold_batches(torch, gen)
    return dict(max_abs_err=worst, ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=bound,
                bound_by="bytes" if need["bytes"] / HBM_BYTES_PER_S
                >= n_ops / F32_OPS_PER_S else "operations", library_ms=None)


def fold_timing(torch, dev, seed: int = TIMING_SEED) -> dict:
    """Times the fold at the main path's steady state, a replacement
    chunk (counts 2-3 M above random capacities), made from ``seed``:
    CUDA events around back-to-back calls, the plain version, and the
    profiler's kernels and memsets per call. Only the wrapper and the
    plain version are called, so the same inputs time any tree's kernel.
    ``counts`` is not updated in place, so every call does the same work.
    """
    from repro_torch.kernels import ref, reservoir
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cells = K * S
    i32 = dict(dtype=torch.int32, device=dev)
    inp = fold_inputs(
        torch, gen, M, cells,
        torch.randint(2_000_000, 3_000_000, (cells,), generator=gen, **i32),
        torch.randint(1, N_MAX + 1, (cells,), generator=gen, **i32))
    ring = torch.randn((cells, N_MAX), generator=gen, device=dev)
    ms = time_ms(lambda: reservoir.reservoir_fold(values=ring, **inp), torch)
    plain_ms = time_ms(lambda: ref.reservoir_fold(values=ring, **inp),
                       torch, reps=5, warm=1)
    prof = device_profile(
        lambda: reservoir.reservoir_fold(values=ring, **inp), torch)
    return dict(ms=ms, plain_ms=plain_ms, prof=prof, inputs=inp)


def item_needs(torch, base, new_counts, capacity) -> dict:
    """Of a fold's live items: ``live``, ``fill`` (arrival index within
    capacity: accepted into slot c - 1, no uniform read) and ``tested``
    (past capacity: u_accept read), from the counts before and after."""
    base, new, cap = (t.long() for t in (base, new_counts, capacity))
    fill = int((torch.minimum(new, cap) - base).clamp(min=0).sum())
    live = int((new - base).sum())
    return dict(live=live, fill=fill, tested=live - fill)


def fold_need(torch, inp, n_max: int = N_MAX) -> dict:
    """Bytes the fold of ``inp`` into a ring of ``n_max`` slots a stratum
    must move, from one probe call of the kernel: the mask of every item;
    the stratum of each live item; u_accept of each item past capacity;
    u_slot of each such item accepted; the payload and the ring word of
    each cell won; counts in and out and capacity. Scattered words count
    at their 4 bytes, though DRAM moves a 32-byte sector for each."""
    from repro_torch.kernels import reservoir
    m = inp["stratum_ids"].numel()
    cells = inp["counts"].numel()
    probe = torch.full((cells, n_max), float("nan"),
                       device=inp["counts"].device)
    new_counts = reservoir.reservoir_fold(values=probe, **inp)
    won = int((~torch.isnan(probe)).sum())
    accepted = listed_items(torch, m, cells)
    need = item_needs(torch, inp["counts"], new_counts, inp["capacity"])
    nbytes = (m + 4 * need["live"] + 4 * need["tested"]
              + 4 * (accepted - need["fill"]) + 8 * won + 12 * cells)
    return dict(need, bytes=nbytes, accepted=accepted, won=won)


def stats_inputs(torch, gen, case):
    """Inputs of one stats call, ``(x, sid, mask, S)``. ``"emission"``:
    the emission's shared stats pass over the flattened ``[6 x 1,048,576]``
    ring (row ids as strata, a per-row sample size as the slot mask), the
    paper's §5.1 Gaussian sub-streams; ``"all_masked"``: the same with
    every slot masked out; ``"offset"``: the same slots seen through views
    that start 1 (values, mask) and 2 (strata) elements into their
    buffers; ``"max_strata"``: ``MAX_STRATA`` random strata over a ragged
    M."""
    from repro_torch.kernels.stratified_stats import MAX_STRATA
    dev = gen.device
    g = K * S
    mus = torch.tensor([10.0, 1000.0, 10000.0] * K, device=dev)
    sgs = torch.tensor([5.0, 50.0, 500.0] * K, device=dev)
    vals = (mus[:, None] + sgs[:, None]
            * torch.randn((g, N_MAX), generator=gen, device=dev))
    taken = torch.randint(N_MAX // 2, N_MAX + 1, (g,), generator=gen,
                          device=dev)
    slots = torch.arange(N_MAX, device=dev)
    mask = (slots[None, :] < taken[:, None]).reshape(-1)
    x = vals.reshape(-1)
    sid = torch.arange(g, dtype=torch.int32, device=dev)[:, None].expand(
        g, N_MAX).reshape(-1)
    if case == "all_masked":
        mask = torch.zeros_like(mask)
    elif case == "offset":
        x = torch.cat([x[:1], x])[1:]
        mask = torch.cat([mask[:1], mask])[1:]
        sid = torch.cat([sid[:2], sid])[2:]
    elif case == "max_strata":
        m = g * N_MAX - 77
        g = MAX_STRATA
        x, mask = x[:m], mask[:m]
        sid = torch.randint(0, g, (m,), generator=gen, device=dev,
                            dtype=torch.int32)
    return x, sid, mask, g


def phase_stats(torch, gen):
    """The stats kernel against its plain version in every case of
    ``stats_inputs`` (counts bit for bit, sums within STATS_RTOL of the
    plain version's f32 sums in XLA's order, the same bits on a second
    call, the tickets 0 after it), the s2 of the emission's input against
    float64, then its times at the emission's input (``stats_timing``)."""
    from repro_torch.kernels import ref, stratified_stats as sk
    dev = gen.device
    worst = 0.0
    for case in ("emission", "all_masked", "offset", "max_strata"):
        x, sid, mask, g = stats_inputs(torch, gen, case)
        kc, ks, kq = sk.stratified_stats(x, sid, mask, g)
        pc, ps, pq = ref.stratified_stats(x, sid, mask, g)
        again = sk.stratified_stats(x, sid, mask, g)
        torch.cuda.synchronize()
        rel_s = float(((ks - ps).abs() / ps.abs().clamp(min=1e-30)).max())
        rel_q = float(((kq - pq).abs() / pq.abs().clamp(min=1e-30)).max())
        worst = max(worst, float((ks - ps).abs().max()),
                    float((kq - pq).abs().max()))
        same = all(same_bits(torch, a, b)
                   for a, b in zip(again, (kc, ks, kq)))
        clean = workspace_clean(torch)
        log(f"[stats] {case}: M={x.numel()} S={g} counts bitwise="
            f"{torch.equal(kc, pc)} sums rel err {rel_s:.3e}, sumsqs rel "
            f"err {rel_q:.3e} (rtol {STATS_RTOL}) second call same bits="
            f"{same} tickets clean={clean} live {int(kc.sum())}")
        if not torch.equal(kc, pc):
            fail(f"stats counts differ ({case}): {kc.tolist()[:8]} vs "
                 f"{pc.tolist()[:8]}")
        if rel_s > STATS_RTOL or rel_q > STATS_RTOL:
            fail(f"stats sums outside rtol ({case})")
        if not same:
            fail(f"stats kernel is not deterministic from call to call "
                 f"({case})")
        if not clean:
            fail(f"stats kernel left a ticket dirty ({case})")
        if case == "all_masked" and float(kc.sum()) != 0.0:
            fail("all-masked stats call counted items")
        if case == "emission":
            # s2 from the kernel's f32 moments against float64.
            from repro_torch.core.error import StratumStats
            taken = kc.to(torch.int32)
            s2 = StratumStats(counts=taken, taken=taken, sums=ks,
                              sumsqs=kq).s2().double()
            xd = torch.where(mask, x.double(), 0.0).reshape(g, N_MAX)
            live = mask.reshape(g, N_MAX)
            mean = xd.sum(1) / taken
            s2_ref = ((xd - mean[:, None]) ** 2 * live).sum(1) / (taken - 1)
            rel_s2 = float(((s2 - s2_ref).abs() / s2_ref).max())
            log(f"[stats] emission: s2 rel err vs f64 {rel_s2:.3e} (rtol "
                f"{S2_RTOL})")
            if rel_s2 > S2_RTOL:
                fail("stats s2 outside rtol of float64")

    t = stats_timing(torch, dev)
    need = stats_need(torch, *t["inputs"])
    bound = max(need["bytes"] / HBM_BYTES_PER_S,
                need["ops"] / F32_OPS_PER_S) * 1e3
    log(f"[stats] emission [{K * S} x {N_MAX}]: kernel {t['ms']:.4f} ms, "
        f"plain {t['plain_ms']:.4f} ms, index_add_ {t['library_ms']:.4f} "
        f"ms, bound {bound:.4f} ms ({need['bytes']} B the function needs: "
        f"{need['slots']} mask bytes, {need['live']} live slots x 8 B, "
        f"{need['strata']} strata x 12 B)")
    log_split("stats", {k: v[0] for k, v in t["prof"].items()}, t["ms"])
    one_launch("stats", t["prof"])
    return dict(max_abs_err=worst, ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=bound,
                bound_by="bytes" if need["bytes"] / HBM_BYTES_PER_S
                >= need["ops"] / F32_OPS_PER_S else "operations",
                library_ms=t["library_ms"])


def stats_timing(torch, dev, seed: int = TIMING_SEED) -> dict:
    """Times the stats kernel at the emission's input made from ``seed``
    (``stats_inputs``' ``"emission"``): CUDA events around back-to-back
    calls, the plain version, one ``index_add_`` of the same moments, and
    the profiler's kernels and memsets per call. Only the wrapper and the
    plain version are called, so the same inputs time any tree's kernel.
    """
    from repro_torch.kernels import ref, stratified_stats as sk
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x, sid, mask, g = stats_inputs(torch, gen, "emission")
    ms = time_ms(lambda: sk.stratified_stats(x, sid, mask, g), torch)
    plain_ms = time_ms(lambda: ref.stratified_stats(x, sid, mask, g), torch,
                       reps=5, warm=1)
    stacked = torch.stack([mask.float(), torch.where(mask, x, 0.0),
                           torch.where(mask, x * x, 0.0)], dim=1)
    acc = torch.zeros((g, 3), device=dev)
    library_ms = time_ms(lambda: acc.zero_().index_add_(0, sid, stacked),
                         torch)
    prof = device_profile(lambda: sk.stratified_stats(x, sid, mask, g),
                          torch)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, prof=prof,
                inputs=(x, sid, mask, g))


def stats_need(torch, x, sid, mask, g) -> dict:
    """Bytes the stats pass of ``(x, sid, mask)`` over ``g`` strata must
    move: every mask byte, the value and stratum id of each live slot, and
    the three f32 outputs per stratum; and its operations (a multiply and
    three adds per live slot)."""
    slots = x.numel()
    live = int(mask.sum())
    return dict(bytes=slots + 8 * live + 12 * g, ops=4 * live, slots=slots,
                live=live, strata=g)


def live_intervals(em) -> list:
    """The intervals a cadence emission's merged window holds."""
    return [i for i in range(em.open_interval - K + 1,
                             em.open_interval + 1) if i >= 0]


def check_answers(tag, em, intervals, exact_at) -> None:
    """Every answer within 3 sigma (+ f32 rounding) of the exact float64
    value over ``intervals`` of the snapshot ``exact_at``."""
    cnt, tot, big = (float(exact_at[f][intervals].sum()) for f in range(3))
    want = {"sum": tot, "mean": tot / cnt, "count": big}
    for name, est in em.results.items():
        v, var = float(est.value), float(est.variance)
        sigma = math.sqrt(max(var, 0.0))
        err_ = abs(v - want[name])
        ok = err_ <= 3 * sigma + ANSWER_RTOL * abs(want[name])
        log(f"[{tag}] emission {em.index} (interval {em.interval}) {name}: "
            f"{v:.9g} exact {want[name]:.9g} |err| {err_:.4g} sigma "
            f"{sigma:.4g} {'ok' if ok else 'OUTSIDE 3 sigma'}")
        if not ok:
            fail(f"{tag} emission {em.index} {name} outside its 3-sigma "
                 "bound")


def make_stream(torch, seed: int, dev):
    """The §5.1 Gaussian stream (the reference's draws: aggregator seed
    ``seed``), stamped in order, made on the card in bulk (set-up), with
    the exact per-interval float64 aggregates."""
    from repro_torch.runtime.records import stamp
    from repro_torch.runtime.watermark import interval_of
    from repro_torch.stream import GaussianSource, StreamAggregator
    agg = StreamAggregator(GaussianSource(), seed=seed, device=dev)
    n_iv = int(CHUNKS * M / RATE // SPAN) + 1
    chunks, exact = [], []
    acc = torch.zeros((3, n_iv, S), dtype=torch.float64, device=dev)
    for e in range(CHUNKS):
        c = agg.interval_chunk(e, M)
        vals, sid = c.values, c.stratum_ids
        ch = stamp(vals, sid, e * M / RATE, RATE)
        chunks.append(ch)
        cell = interval_of(ch.times, SPAN).long() * S + sid.long()
        v = vals.double()
        acc[0].view(-1).index_add_(0, cell, torch.ones_like(v))
        acc[1].view(-1).index_add_(0, cell, v)
        acc[2].view(-1).index_add_(0, cell, (v > THRESHOLD).double())
        exact.append(acc.clone())
    return chunks, exact


def phase_main(torch, seed: int, dev):
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.runtime.executor import PipelinedExecutor, _ingest_chunk
    chunks, exact = make_stream(torch, seed, dev)
    cfg, reg = main_config()
    ex = PipelinedExecutor(cfg, reg, prng.PRNGKey(seed), device=dev)
    ex.run(chunks[:EMIT_EVERY])            # warm-up (allocator, caches)
    ex.reset(prng.PRNGKey(seed))
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    emissions = ex.run(chunks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()

    if launches["reservoir_fold"] == 0 or launches["stratified_stats"] == 0:
        fail(f"main path did not run both kernels: {launches}")
    if len(emissions) != CHUNKS // EMIT_EVERY:
        fail(f"{len(emissions)} emissions, expected {CHUNKS // EMIT_EVERY}")
    for em in emissions:
        check_answers("main", em, live_intervals(em),
                      exact[(em.index + 1) * EMIT_EVERY - 1])
    m = ex.state.metrics
    ing, acc_, drop = (t.tolist() for t in (m.ingested, m.accepted,
                                            m.dropped))
    log(f"[main] ingested {ing} accepted {acc_} dropped {drop} late "
        f"{m.late.tolist()} replaced {m.replaced.tolist()}")
    if any(i != a + d for i, a, d in zip(ing, acc_, drop)):
        fail("ingested != accepted + dropped")
    if sum(ing) != CHUNKS * M:
        fail(f"ingested {sum(ing)} of {CHUNKS * M} items")

    # The same window again on fresh state: the spread of the host clock.
    walls = [wall]
    for _ in range(WINDOWS - 1):
        ex.reset(prng.PRNGKey(seed))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.run(chunks)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    rates = sorted(CHUNKS * M / w for w in walls)

    # Ingest alone on a fresh state, then emissions alone (host clock
    # around work that ends in a synchronise).
    ex.reset(prng.PRNGKey(seed))
    state = ex.state
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for ch in chunks:
        state = _ingest_chunk(cfg, state, ch)
    torch.cuda.synchronize()
    ingest_ms = (time.perf_counter() - t1) / CHUNKS * 1e3
    ex.state = state
    t2 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        ex._chunks_since_emit = 1
        ex._emit_now()
    emit_ms = (time.perf_counter() - t2) / reps * 1e3
    items = CHUNKS * M
    med = rates[len(rates) // 2]
    log(f"[main] {items} items per window, {WINDOWS} windows: median "
        f"{med:.6g} items/s end to end ({items / med / CHUNKS * 1e3:.4f} ms "
        f"per chunk with emissions), min {rates[0]:.6g}, max "
        f"{rates[-1]:.6g}; all {[round(r) for r in rates]}")
    log(f"[main] ingest alone {ingest_ms:.4f} ms per chunk; one emission "
        f"{emit_ms:.4f} ms")
    log(f"[main] launches on the main path: {launches}")
    return launches


def phase_profile(torch, seed: int, dev) -> None:
    """``torch.profiler`` over 8 chunks (2 emissions) of the main path:
    device busy share, kernels per chunk, device time by kernel name.
    The full table goes to chiprun_out/chip_smoke_profile.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import prng
    from repro_torch.runtime.executor import PipelinedExecutor, RuntimeConfig
    from repro_torch.runtime.registry import QueryRegistry
    chunks, _ = make_stream(torch, seed, dev)
    cfg = RuntimeConfig(num_strata=S, capacity=N_MAX, num_intervals=K,
                        interval_span=SPAN, allowed_lateness=LATENESS,
                        emit_every=EMIT_EVERY)
    reg = (QueryRegistry().register("sum", "sum").register("mean", "mean")
           .register("count", "count", predicate=lambda x: x > THRESHOLD))
    ex = PipelinedExecutor(cfg, reg, prng.PRNGKey(seed), device=dev)
    ex.run(chunks[:EMIT_EVERY])
    ex.reset(prng.PRNGKey(seed))
    n = 2 * EMIT_EVERY
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.run(chunks[:n])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=80)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_profile.txt").write_text(table)
    log(f"[profile] {n} chunks: wall {wall_us / 1e3:.4f} ms (profiler on), "
        f"device busy {busy / 1e3:.4f} ms = {busy / wall_us:.4f} of wall, "
        f"{len(spans) / n:.1f} device activities per chunk")
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"[profile]   {t / 1e3:9.4f} ms {c:6d}x  {name[:90]}")


def one_shot_case(torch, gen, m, *, counts, capacity, adopt, slot_interval,
                  max_time, open_interval, t_lo, t_hi, mask_p=0.97,
                  n_max=N_MAX):
    """Full-shape inputs of one one-shot call: ``(items, state)``, the
    ring ``[K, S, n_max]`` for ``[K, S]`` counts."""
    dev = gen.device
    i32 = dict(dtype=torch.int32, device=dev)
    k, s = counts.shape

    def rand(n):
        return torch.rand(n, generator=gen, device=dev)
    items = dict(
        times=t_lo + (t_hi - t_lo) * rand(m),
        stratum_ids=torch.randint(0, s, (m,), generator=gen, **i32),
        payload=torch.randn(m, generator=gen, device=dev) * 100.0,
        mask=rand(m) < mask_p, u_accept=rand(m), u_slot=rand(m))
    state = dict(
        max_time=torch.tensor(max_time, dtype=torch.float32, device=dev),
        open_interval=torch.tensor(open_interval, **i32),
        on_time=torch.tensor(5, **i32), late=torch.tensor(7, **i32),
        dropped=torch.tensor(11, **i32), chunks=torch.tensor(3, **i32),
        items=torch.tensor(99, **i32),
        slot_interval=torch.tensor(slot_interval, **i32), adopt=adopt,
        counts=counts, capacity=capacity,
        values=torch.randn((k, s, n_max), generator=gen, device=dev),
        counters=torch.randint(0, 1000, (6, s), generator=gen, **i32))
    return items, state


def same_bits(torch, a, b) -> bool:
    """Equal bit for bit (f32 and bf16 compared as their integer
    words)."""
    words = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if a.dtype in words and b.dtype == a.dtype:
        a, b = (t.reshape(-1).view(words[a.dtype]) for t in (a, b))
    return bool(torch.equal(a, b))


def phase_one_shot(torch, gen):
    """The one-shot kernel against its plain version at full shape (span
    5, lateness 0.5). With K = 2 a chunk that moves the newest interval
    cannot also hold late items (late means older than the pre-chunk
    newest interval, live means at most one older than the post-chunk
    one), so the frontier crossing and the late items are two cases."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.one_shot import one_shot_ingest
    dev = gen.device
    i32 = dict(dtype=torch.int32, device=dev)
    full = torch.full((K, S), N_MAX, **i32)
    adopt_full = torch.full((S,), N_MAX, **i32)

    def below(lo):
        return torch.randint(lo, N_MAX, (S,), generator=gen, **i32)
    cases = {
        "filling": one_shot_case(
            torch, gen, M, counts=torch.zeros((K, S), **i32), capacity=full,
            adopt=adopt_full, slot_interval=[0, -1], max_time=1.0,
            open_interval=0, t_lo=0.6, t_hi=4.9),
        "replacement": one_shot_case(
            torch, gen, M,
            counts=torch.randint(2_000_000, 3_000_000, (K, S),
                                 generator=gen, **i32),
            capacity=torch.randint(1, N_MAX + 1, (K, S), generator=gen,
                                   **i32),
            adopt=below(1), slot_interval=[0, 1], max_time=6.0,
            open_interval=1, t_lo=5.6, t_hi=9.9),
        "crossing": one_shot_case(
            torch, gen, M,
            counts=torch.randint(0, 500_000, (K, S), generator=gen, **i32),
            capacity=full, adopt=below(N_MAX // 4), slot_interval=[-4, -3],
            max_time=9.9, open_interval=1, t_lo=9.0, t_hi=10.6),
        "late": one_shot_case(
            torch, gen, M,
            counts=torch.randint(0, 3_000_000, (K, S), generator=gen,
                                 **i32),
            capacity=full, adopt=below(N_MAX // 4), slot_interval=[2, 1],
            max_time=10.3, open_interval=2, t_lo=9.0, t_hi=11.0),
        "all_masked": one_shot_case(
            torch, gen, M, counts=torch.zeros((K, S), **i32), capacity=full,
            adopt=adopt_full, slot_interval=[0, -1], max_time=1.0,
            open_interval=0, t_lo=0.6, t_hi=4.9, mask_p=0.0),
        "ragged": one_shot_case(
            torch, gen, M - 77,
            counts=torch.full((K, S), N_MAX - M // 20, **i32),
            capacity=full, adopt=adopt_full, slot_interval=[0, 1],
            max_time=6.0, open_interval=1, t_lo=5.2, t_hi=9.9),
    }
    kw = ONE_SHOT_KW
    fields = ("values", "counts", "capacity", "slot_interval", "max_time",
              "open_interval", "on_time", "late", "dropped", "chunks",
              "items", "counters")
    worst = 0.0
    for name, (items, state) in cases.items():
        sk = {k: v.clone() for k, v in state.items()}
        sp = {k: v.clone() for k, v in state.items()}
        one_shot_ingest(**items, **kw, **sk)
        ref.one_shot_ingest(**items, **kw, **sp)
        torch.cuda.synchronize()
        bad = [f for f in fields if not same_bits(torch, sk[f], sp[f])]
        worst = max(worst, float((sk["values"] - sp["values"]).abs().max()))
        d = {f: int(sk[f]) - int(state[f])
             for f in ("on_time", "late", "dropped", "items")}
        resets = int((sk["slot_interval"] != state["slot_interval"]).sum())
        log(f"[one_shot] {name}: M={items['times'].numel()} bitwise="
            f"{not bad} added {d} slots reset {resets} open "
            f"{int(state['open_interval'])}->{int(sk['open_interval'])} "
            f"counts {sk['counts'].view(-1).tolist()}")
        if bad:
            fail(f"one-shot kernel differs from its plain version ({name}): "
                 f"{bad}")
        if name == "crossing" and (resets != K or d["dropped"] == 0):
            fail("crossing case did not reset every slot and drop items")
        if name == "late" and (d["late"] == 0 or d["dropped"] == 0):
            fail("late case has no late or no dropped items")

    if not workspace_clean(torch):
        fail("one-shot kernel left its winner table or look-back words "
             "dirty")

    # Four successive replacement chunks through one carried state, in
    # event-time order (1.2 s each) inside interval 1.
    rep_state = cases["replacement"][1]
    sk = {k: v.clone() for k, v in rep_state.items()}
    sp = {k: v.clone() for k, v in rep_state.items()}
    for i in range(4):
        items = one_shot_case(
            torch, gen, M, counts=sk["counts"], capacity=sk["capacity"],
            adopt=sk["adopt"], slot_interval=[0, 1], max_time=6.0,
            open_interval=1, t_lo=5.0 + 1.2 * i, t_hi=6.2 + 1.2 * i)[0]
        one_shot_ingest(**items, **kw, **sk)
        ref.one_shot_ingest(**items, **kw, **sp)
        bad = [f for f in fields if not same_bits(torch, sk[f], sp[f])]
        clean = workspace_clean(torch)
        log(f"[one_shot] sequence chunk {i}: bitwise={not bad} scratch "
            f"clean={clean} counts {sk['counts'].view(-1).tolist()}")
        if bad or not clean:
            fail(f"one-shot kernel differs from its plain version (sequence "
                 f"chunk {i}): {bad}, or left its scratch dirty")

    two = one_shot_two_leaves(torch, gen, cases)

    t = one_shot_timing(torch, dev)
    need = one_shot_need(torch, t["items"], t["state"])
    n_ops = 20 * M                     # ~twenty integer/f32 ops per item
    bound = max(need["bytes"] / HBM_BYTES_PER_S,
                n_ops / F32_OPS_PER_S) * 1e3
    log(f"[one_shot] steady replacement chunk: kernel {t['ms']:.4f} ms "
        f"(the counts put back before each call included), plain "
        f"{t['plain_ms']:.4f} ms, bound {bound:.4f} ms ({need['bytes']} B "
        f"the function needs: {need['masked_in']} masked in, "
        f"{need['live']} live, {need['tested']} past capacity, "
        f"{need['accepted']} accepted, {need['won']} cells won); no single "
        "PyTorch call does the fused ingest")
    log_split("one_shot", {k: v[0] for k, v in t["prof"].items()}, t["ms"])
    small_form("one_shot", t["prof"])
    log(f"[one_shot] the counts' restore before each call: "
        f"{t['restore']} (left out of the split above)")
    two.update(one_shot_leaf_turns(torch, dev, t, need, n_ops))
    shards = one_shot_shards(torch, gen)
    return dict(max_abs_err=worst, ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=bound,
                bound_by="bytes" if need["bytes"] / HBM_BYTES_PER_S
                >= n_ops / F32_OPS_PER_S else "operations", library_ms=None,
                two_leaves=two, shards=shards)


def with_key_leaf(torch, gen, items, state) -> tuple:
    """A one-shot case with a payload of two leaves, ``{"val": f32,
    "key": i32}`` (the reference's pytree payloads: heavy-hitter keys
    riding beside the values): ``val`` the case's own payload and ring,
    ``key`` drawn from ``gen``. Returns new dicts; the case's tensors are
    shared, not copied."""
    dev = gen.device
    m = items["times"].numel()
    key = torch.randint(0, 2**31 - 1, (m,), generator=gen,
                        dtype=torch.int32, device=dev)
    ring = torch.randint(0, 2**31 - 1, state["values"].shape, generator=gen,
                         dtype=torch.int32, device=dev)
    return (dict(items, payload={"val": items["payload"], "key": key}),
            dict(state, values={"val": state["values"], "key": ring}))


def clone_tree(d: dict) -> dict:
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in d.items()}


def one_shot_two_leaves(torch, gen, cases) -> dict:
    """The kernel on a payload of two leaves (:func:`with_key_leaf`) at
    phase one_shot's shapes, for the replacement, crossing and late
    cases: every field and both ring leaves bit for bit the plain
    version's, the f32 leaf bit for bit a one-leaf call's on the same
    state (one set of decisions), the scratch clean after each call."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.one_shot import one_shot_ingest
    kw = ONE_SHOT_KW
    calls = 0
    for name in ("replacement", "crossing", "late"):
        items, state = cases[name]
        items2, state2 = with_key_leaf(torch, gen, items, state)
        sk, sp, single = clone_tree(state2), clone_tree(state2), \
            clone_tree(state)
        one_shot_ingest(**items2, **kw, **sk)
        ref.one_shot_ingest(**items2, **kw, **sp)
        one_shot_ingest(**items, **kw, **single)
        calls += 1
        bad = [f for f in sk if f not in ("values", "adopt")
               and not (same_bits(torch, sk[f], sp[f])
                        and same_bits(torch, sk[f], single[f]))]
        bad += [f"values.{leaf}" for leaf in ("val", "key")
                if not same_bits(torch, sk["values"][leaf],
                                 sp["values"][leaf])]
        if not same_bits(torch, sk["values"]["val"], single["values"]):
            bad.append("values.val against one leaf")
        moved = int((sk["values"]["key"] != state2["values"]["key"]).sum())
        clean = workspace_clean(torch)
        log(f"[one_shot] two leaves (f32 val, i32 key), {name}: bitwise="
            f"{not bad} ({moved} key cells written, the val leaf the "
            f"one-leaf call's), scratch clean={clean}")
        if bad or not clean or moved == 0:
            fail(f"one-shot kernel on two leaves ({name}) differs from its "
                 f"plain version or from one leaf: {bad}; {moved} key cells "
                 f"written; scratch clean {clean}")
    return dict(cases=["replacement", "crossing", "late"],
                two_leaf_checked_calls=calls)


def one_shot_leaf_turns(torch, dev, t1, need, n_ops) -> dict:
    """Device ms per call (the profiler's kernel time, the counts'
    restore left out) of the steady replacement chunk with one payload
    leaf and with two (:func:`one_shot_timing`, ``leaves=2``: the same
    items, ring and decisions, an i32 key leaf beside), in turns
    1, 2, 2, 1; each beside its bound, the two-leaf one 8 B more per cell
    won (the key's payload read and ring word written)."""
    t2 = one_shot_timing(torch, dev, leaves=2, plain=False)
    turns = {1: [], 2: []}
    for n in (1, 2, 2, 1):
        prof = device_profile((t1 if n == 1 else t2)["call"], torch)
        turns[n].append(sum(v[0] for k, v in prof.items()
                            if "Memcpy" not in k))
    b1 = need["bytes"]
    b2 = b1 + 8 * need["won"]
    bounds = {n: max(b / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S) * 1e3
              for n, b in ((1, b1), (2, b2))}
    log(f"[one_shot] device ms per call in turns 1, 2, 2, 1 leaves: one "
        f"leaf {[round(x, 5) for x in turns[1]]}, two leaves "
        f"{[round(x, 5) for x in turns[2]]} (events around back-to-back "
        f"calls: one {t1['ms']:.4f}, two {t2['ms']:.4f}); bounds "
        f"{bounds[1]:.4f} / {bounds[2]:.4f} ms ({b1} / {b2} B: the second "
        f"leaf adds 8 B per cell won, {need['won']} cells)")
    return dict(one_leaf_device_ms=turns[1], two_leaf_device_ms=turns[2],
                one_leaf_ms=t1["ms"], two_leaf_ms=t2["ms"],
                one_leaf_bound_ms=bounds[1], two_leaf_bound_ms=bounds[2],
                two_leaf_bytes=b2)


def one_shot_timing(torch, dev, seed: int = TIMING_SEED, leaves: int = 1,
                    plain: bool = True) -> dict:
    """Times the one-shot at the main path's steady state, a replacement
    chunk made from ``seed``: counts 2-3 M above random capacities, the
    frontier at 9.9 s and the items in [9.45, 9.85) s, so every masked-in
    item is live and the frontier does not move. The counts are put back
    before each call (one 24-byte copy, shown apart from the kernels), so
    every call does the same work. Only the wrapper and the plain version
    are called, so the same inputs time any tree's kernel. ``leaves=2``
    adds an i32 key leaf to the payload and the ring
    (:func:`with_key_leaf`), drawn after the one-leaf inputs, so those
    are the same; ``plain=False`` leaves the plain version untimed.
    ``call`` is the timed kernel call."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.one_shot import one_shot_ingest
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    i32 = dict(dtype=torch.int32, device=dev)
    items, state = one_shot_case(
        torch, gen, M,
        counts=torch.randint(2_000_000, 3_000_000, (K, S), generator=gen,
                             **i32),
        capacity=torch.randint(1, N_MAX + 1, (K, S), generator=gen, **i32),
        adopt=torch.randint(1, N_MAX, (S,), generator=gen, **i32),
        slot_interval=[0, 1], max_time=9.9, open_interval=1, t_lo=9.45,
        t_hi=9.85)
    if leaves == 2:
        items, state = with_key_leaf(torch, gen, items, state)
    counts0 = state["counts"].clone()

    def steady(fn):
        def call():
            state["counts"].copy_(counts0)
            fn(**items, **ONE_SHOT_KW, **state)
        return call
    ms = time_ms(steady(one_shot_ingest), torch)
    plain_ms = (time_ms(steady(ref.one_shot_ingest), torch, reps=5, warm=1)
                if plain else None)
    prof = device_profile(steady(one_shot_ingest), torch)
    restore = {k: prof.pop(k) for k in list(prof) if "Memcpy" in k}
    state["counts"].copy_(counts0)
    return dict(ms=ms, plain_ms=plain_ms, prof=prof, restore=restore,
                items=items, state=state, call=steady(one_shot_ingest))


def one_shot_need(torch, items, state) -> dict:
    """Bytes the one-shot of ``items`` into ``state`` must move, from one
    probe call of the kernel on a copy of the state: the mask of every
    item; the time and stratum of each masked-in item (the frontier, the
    verdict and the counter rows need them); then as the fold's need
    (``fold_need``) over the live items; the carried state (counts,
    capacities, slot table, counter rows, scalars), and the adopted
    capacities of reset slots."""
    from repro_torch.kernels.one_shot import one_shot_ingest
    m = items["times"].numel()
    k, s = state["counts"].shape
    probe = dict({n: v.clone() for n, v in state.items()},
                 values=torch.full(state["values"].shape, float("nan"),
                                   device=state["counts"].device))
    one_shot_ingest(**items, **ONE_SHOT_KW, **probe)
    won = int((~torch.isnan(probe["values"])).sum())
    accepted = listed_items(torch, m, k * s)
    reset = (probe["slot_interval"] != state["slot_interval"])[:, None]
    base = torch.where(reset, 0, state["counts"])
    need = item_needs(torch, base, probe["counts"], probe["capacity"])
    live = int((probe["counters"][1] - state["counters"][1]).sum())
    if live != need["live"]:
        fail(f"one-shot probe: {live} accepted by the counter row, "
             f"{need['live']} by the counts")
    masked_in = int(items["mask"].sum())
    resets = int(reset.sum())
    nbytes = (m + 8 * masked_in + 4 * need["tested"]
              + 4 * (accepted - need["fill"]) + 8 * won
              + 4 * (3 * k * s + 11 * s + 2 * k + 14)
              + 4 * (resets * s + (s if resets else 0)))
    return dict(need, bytes=nbytes, masked_in=masked_in, accepted=accepted,
                won=won)


def shard_case(torch, gen, kind, k, s, n_max, m) -> tuple:
    """One shard's ``(items, state)`` of a batched one-shot call (span 5,
    lateness 0.5, a ``[k, s, n_max]`` ring whose counts are over random
    capacities): ``steady`` a replacement chunk in which every masked-in
    item is live and the frontier stays (as :func:`one_shot_timing`);
    ``late`` items older than the open interval above the watermark, and
    dropped ones; ``crossing`` the frontier moving on an interval, a slot
    reset and dropped items; ``all_masked`` the steady chunk with every
    item masked out."""
    i32 = dict(dtype=torch.int32, device=gen.device)
    open_iv, max_time, t_lo, t_hi = {
        "steady": (1, 9.9, 9.45, 9.85), "all_masked": (1, 9.9, 9.45, 9.85),
        "late": (2, 10.3, 9.0, 11.0), "crossing": (1, 9.9, 9.0, 10.6)}[kind]
    slots = torch.arange(k, **i32)
    return one_shot_case(
        torch, gen, m,
        counts=torch.randint(n_max, 4 * n_max, (k, s), generator=gen, **i32),
        capacity=torch.randint(1, n_max + 1, (k, s), generator=gen, **i32),
        adopt=torch.randint(1, n_max, (s,), generator=gen, **i32),
        slot_interval=(open_iv - torch.remainder(open_iv - slots, k)).tolist(),
        max_time=max_time, open_interval=open_iv, t_lo=t_lo, t_hi=t_hi,
        mask_p=0.0 if kind == "all_masked" else 0.97, n_max=n_max)


def stack_shards(torch, cases) -> tuple:
    """Shards' ``(items, state)`` stacked on a leading ``[W]`` axis."""
    return tuple({n: torch.stack([c[i][n] for c in cases])
                  for n in cases[0][i]} for i in (0, 1))


def shard_views(d: dict, w: int) -> dict:
    return {n: v[w] for n, v in d.items()}


def per_shard(fn, items, state) -> None:
    """``fn`` (a one-shot entry) once per shard on each shard's views of
    the ``[W, ...]`` tensors: the W calls a sharded chunk took before the
    shard axis."""
    for w in range(items["times"].shape[0]):
        fn(**shard_views(items, w), **ONE_SHOT_KW, **shard_views(state, w))


def one_shot_form(k: int, s: int) -> str:
    from repro_torch.kernels.one_shot import MAX_CELLS
    return "parted" if k * s > MAX_CELLS else "small"


def form_launches(k: int, s: int) -> int:
    """Kernels of one one-shot call of one leaf over ``k x s`` cells."""
    return (PARTED_LAUNCHES if one_shot_form(k, s) == "parted"
            else SMALL_FORM_LAUNCHES)["one_shot"]


def one_shot_shards_check(torch, gen, case, w, k, s, n_max, m) -> dict:
    """One call batched over ``w`` shards in the states of SHARD_KINDS[w]:
    every field of every shard bit for bit the batched plain version's,
    twice from the same start; one call of the form counted per call; the
    scratch clean after each; the kernels and memsets per call from the
    profiler, which must be the unbatched call's whatever ``w`` is."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.one_shot import one_shot_ingest
    form = one_shot_form(k, s)
    items, state = stack_shards(torch, [
        shard_case(torch, gen, kind, k, s, n_max, m)
        for kind in SHARD_KINDS[w]])
    sp = clone_tree(state)
    ref.one_shot_ingest(**items, **ONE_SHOT_KW, **sp)
    bad, clean, counted = [], True, []
    for run in range(2):
        sk = clone_tree(state)
        forms, n0 = dict(one_shot_ingest.forms), one_shot_ingest.launches
        one_shot_ingest(**items, **ONE_SHOT_KW, **sk)
        counted.append((one_shot_ingest.launches - n0, {
            f: one_shot_ingest.forms[f] - forms[f] for f in forms}))
        bad += [f"{f} (run {run})" for f in sk
                if not same_bits(torch, sk[f], sp[f])]
        clean = clean and workspace_clean(torch)
    scratch = clone_tree(state)
    prof = device_profile(lambda: one_shot_ingest(
        **items, **ONE_SHOT_KW, **scratch), torch)
    kernels, memsets = log_launches(f"one_shot shards {case} W={w}", prof)
    d = {f: (sp[f] - state[f]).tolist() for f in ("late", "dropped")}
    resets = (sp["slot_interval"] != state["slot_interval"]).sum(-1).tolist()
    log(f"[one_shot] batched {case} W = {w} ({SHARD_KINDS[w]}, ring "
        f"{list(state['values'].shape)}, items {list(items['times'].shape)}"
        f"): bitwise to the batched plain version={not bad} twice, scratch "
        f"clean={clean}, counted {counted}; late {d['late']} dropped "
        f"{d['dropped']} slots reset {resets}")
    want = (1, {"small": form == "small", "parted": form == "parted"})
    if bad or not clean or any(c != want for c in counted):
        fail(f"one_shot batched {case} W = {w}: differs from its plain "
             f"version ({bad}), scratch clean {clean}, counted {counted}")
    if (kernels, memsets) != (form_launches(k, s), 0):
        fail(f"one_shot batched {case} W = {w}: {kernels:g} kernels and "
             f"{memsets:g} memsets per call, not {form_launches(k, s)} and "
             "none")
    if "crossing" in SHARD_KINDS[w] and not d["dropped"][
            SHARD_KINDS[w].index("crossing")]:
        fail(f"one_shot batched {case} W = {w}: the crossing shard dropped "
             "nothing")
    return dict(case=case, w=w, form=form, kernels=kernels,
                memsets=memsets)


def one_shot_shard_turns(torch, gen, case, w, k, s, n_max, m) -> dict:
    """The batched call (B) against W unbatched calls on the shards' views
    (A), in turns A B B A, at a steady replacement chunk on every shard
    (the counts put back before each call, shown apart): device ms per
    chunk (the profiler's kernels), kernels and memsets, events ms around
    back-to-back calls; the bound W times each shard's bytes
    (:func:`one_shot_need`) at 3.35 TB/s."""
    from repro_torch.kernels.one_shot import one_shot_ingest
    items, state = stack_shards(torch, [
        shard_case(torch, gen, "steady", k, s, n_max, m) for _ in range(w)])
    need = [one_shot_need(torch, shard_views(items, i), shard_views(state, i))
            for i in range(w)]
    nbytes = sum(n["bytes"] for n in need)
    counts0 = state["counts"].clone()

    def batched():
        state["counts"].copy_(counts0)
        one_shot_ingest(**items, **ONE_SHOT_KW, **state)

    def looped():
        state["counts"].copy_(counts0)
        per_shard(one_shot_ingest, items, state)
    turns = []
    for name in "ABBA":
        fn = looped if name == "A" else batched
        prof = device_profile(fn, torch)
        restore = {n: prof.pop(n) for n in list(prof) if "Memcpy" in n}
        kernels, memsets = log_launches(f"one_shot shards {case} {name}", prof)
        turns.append(dict(
            calls=name, device_ms=sum(v[0] for v in prof.values()),
            kernels=kernels, memsets=memsets, events_ms=time_ms(fn, torch),
            split={n: v[0] for n, v in prof.items()}, restore=restore))
        want = form_launches(k, s) * (w if name == "A" else 1)
        if (kernels, memsets) != (want, 0):
            fail(f"one_shot shards {case} {name}: {kernels:g} kernels and "
                 f"{memsets:g} memsets per chunk, not {want} and none")
    state["counts"].copy_(counts0)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log_split(f"one_shot shards {case} B", turns[1]["split"],
              turns[1]["events_ms"])
    log(f"[one_shot] batched {case}: W = {w}, ring "
        f"{list(state['values'].shape)}, items {list(items['times'].shape)} "
        f"({one_shot_form(k, s)} form): device ms per chunk in turns "
        + ", ".join(f"{t['calls']} {t['device_ms']:.5f} ({t['kernels']:g} "
                    f"kernels)" for t in turns)
        + " (A: W unbatched calls, B: one batched call); events "
        + ", ".join(f"{t['events_ms']:.5f}" for t in turns)
        + f" ms (the counts' restore included); bound {bound:.5f} ms by "
        f"bytes ({nbytes} B, W x a shard's: "
        f"{[n['bytes'] for n in need]}); {card()}")
    return dict(case=case, w=w, k=k, s=s, n_max=n_max, items=m,
                form=one_shot_form(k, s), turns=turns, bound_ms=bound,
                bytes=nbytes, shard_bytes=[n["bytes"] for n in need],
                card=card())


def one_shot_shards(torch, gen) -> dict:
    """The one-shot batched over shards (module docstring, phase 5): the
    checks of :func:`one_shot_shards_check` at W = 1, 2 and 4 in both
    forms (the paper's 4 workers' small form, the sliding deployment's
    parted form), then :func:`one_shot_shard_turns` at every
    SHARD_ONE_SHOT case; ``chiprun_out/chip_smoke_one_shot_shards.json``.
    Returns the device ms of each timed case's turns and its bound."""
    checks = [one_shot_shards_check(torch, gen, case, w, k, s, n_max, m)
              for case, _, k, s, n_max, m in SHARD_ONE_SHOT[:2]
              for w in sorted(SHARD_KINDS)]
    turns = [one_shot_shard_turns(torch, gen, *c) for c in SHARD_ONE_SHOT]
    (ROOT / "chiprun_out" / "chip_smoke_one_shot_shards.json").write_text(
        json.dumps(dict(checks=checks, turns=turns, card=card()), indent=1))
    return {t["case"]: dict(
        batched_ms=[x["device_ms"] for x in t["turns"] if x["calls"] == "B"],
        looped_ms=[x["device_ms"] for x in t["turns"] if x["calls"] == "A"],
        bound_ms=t["bound_ms"]) for t in turns}


def fold_batch_case(torch, gen, w, k, s, n_max, m, leaves=1,
                    steady=False) -> tuple:
    """``(inputs, ring)`` of one fold call batched over ``w`` shards' ``k``
    ring slots, as the masked ingest makes them: items ``[w, m]``, each
    masked into one slot of its shard (97 in 100 masked in at all), so a
    ``[w, k, m]`` mask; fold ``b`` in ``FOLD_KINDS[b % 3]`` (counts over
    random capacities, empty cells, every item masked out), or every fold
    in replacement when ``steady``. ``leaves=2``: payload and ring
    ``{"val": f32, "key": i32}`` (:func:`payload_tree`)."""
    dev = gen.device
    i32 = dict(dtype=torch.int32, device=dev)
    kinds = ["replacement" if steady else FOLD_KINDS[b % 3]
             for b in range(w * k)]

    def where(kind):
        return torch.tensor([x == kind for x in kinds],
                            device=dev).view(w, k, 1)
    slot = torch.randint(0, k, (w, m), generator=gen, device=dev)
    live = torch.rand((w, m), generator=gen, device=dev) < 0.97
    mask = ((slot[:, None, :] == torch.arange(k, device=dev)[None, :, None])
            & live[:, None, :] & ~where("all_masked"))
    counts = torch.randint(n_max, 4 * n_max, (w, k, s), generator=gen, **i32)
    inp = dict(stratum_ids=torch.randint(0, s, (w, m), generator=gen, **i32),
               payload=torch.randn((w, m), generator=gen, device=dev) * 100.0,
               u_accept=torch.rand((w, m), generator=gen, device=dev),
               u_slot=torch.rand((w, m), generator=gen, device=dev),
               mask=mask, counts=torch.where(where("filling"), 0, counts),
               capacity=torch.randint(1, n_max + 1, (w, k, s),
                                      generator=gen, **i32))
    ring = torch.randn((w, k, s, n_max), generator=gen, device=dev)
    if leaves == 2:
        inp["payload"] = payload_tree(torch, gen, "two", (w, m))
        ring = payload_tree(torch, gen, "two", (w, k, s, n_max))
    return inp, ring


def fold_of(d: dict, i: int, j: int) -> dict:
    """Fold ``(i, j)``'s views of a batched call's tensors (trees too):
    shard ``i``'s items, slot ``j``'s mask, counts, capacity and ring."""
    def at(v, lead):
        return ({n: at(x, lead) for n, x in v.items()}
                if isinstance(v, dict) else v[lead])
    return {n: at(v, (i, j) if n in ("mask", "counts", "capacity", "values")
                  else i) for n, v in d.items()}


def tree_leaves(v) -> dict:
    return v if isinstance(v, dict) else {"": v}


def fold_form(s: int) -> str:
    from repro_torch.kernels.reservoir import MAX_STRATA
    return "parted" if s > MAX_STRATA else "small"


def fold_batch_check(torch, gen, case, w, k, s, n_max, m, leaves) -> dict:
    """One fold call batched over ``w`` x ``k`` folds: the ring (every
    leaf) and counts bit for bit the batched plain version's and those of
    ``w·k`` unbatched kernel calls on each fold's views; one call of the
    form counted; the scratch clean after the batched call and after the
    unbatched ones; every leaf moved; the kernels and memsets per call
    from the profiler, 2 / 4 and none whatever ``w·k`` is."""
    from repro_torch.kernels import ref, reservoir
    form = fold_form(s)
    inp, start = fold_batch_case(torch, gen, w, k, s, n_max, m, leaves)
    vk, vp, vu = (clone_tree({"v": start})["v"] for _ in range(3))
    fn = reservoir.reservoir_fold
    n0, forms0 = fn.launches, dict(fn.forms)
    ck = fn(values=vk, **inp)
    counted = (fn.launches - n0, {f: fn.forms[f] - forms0[f]
                                  for f in forms0})
    clean = workspace_clean(torch)
    cp = ref.reservoir_fold(values=vp, **inp)
    bad = [] if torch.equal(ck, cp) else ["counts"]
    bad += [f"values {n}" for n, a in tree_leaves(vk).items()
            if not same_bits(torch, a, tree_leaves(vp)[n])]
    for i in range(w):
        for j in range(k):
            one = fold_of(dict(inp, values=vu), i, j)
            if not torch.equal(fn(**one), ck[i, j]):
                bad.append(f"unbatched counts {(i, j)}")
    clean = clean and workspace_clean(torch)
    bad += [f"unbatched values {n}" for n, a in tree_leaves(vu).items()
            if not same_bits(torch, a, tree_leaves(vk)[n])]
    still = [n for n, a in tree_leaves(vk).items()
             if not bool((a != tree_leaves(start)[n]).any())]
    prof = device_profile(lambda: fn(values=vk, **inp), torch)
    kernels, memsets = log_launches(
        f"fold batch {case} W={w} K={k} leaves={leaves}", prof)
    want = (PARTED_LAUNCHES if form == "parted" else
            SMALL_FORM_LAUNCHES)["fold"]
    log(f"[fold] batched {case}: W = {w}, K = {k} ({w * k} folds, ring "
        f"{[w, k, s, n_max]}, items {[w, m]}, {leaves} leaves, {form} "
        f"form): bitwise to the batched plain version and to {w * k} "
        f"unbatched calls={not bad}, scratch clean={clean}, counted "
        f"{counted}, every leaf moved={not still}")
    if bad or not clean or still or counted != (1, {
            "small": form == "small", "parted": form == "parted"}):
        fail(f"fold batched {case} W = {w} K = {k}: differs ({bad}), "
             f"scratch clean {clean}, unmoved leaves {still}, counted "
             f"{counted}")
    if (kernels, memsets) != (want, 0):
        fail(f"fold batched {case} W = {w} K = {k}: {kernels:g} kernels "
             f"and {memsets:g} memsets per call, not {want} and none")
    return dict(case=case, w=w, k=k, s=s, n_max=n_max, items=m,
                leaves=leaves, form=form, kernels=kernels, memsets=memsets)


def fold_batch_turns(torch, gen, case, w, k, s, n_max, m, leaves=1) -> dict:
    """The batched fold call (B) against ``w·k`` unbatched calls on the
    folds' views (A), in turns A B B A, every fold in replacement
    (the counts are not written in place, so each call does the same
    work): device ms per chunk (the profiler's kernels), kernels and
    memsets, events ms around back-to-back calls; the bound, the sum of
    the folds' bytes (:func:`fold_need`) at 3.35 TB/s."""
    from repro_torch.kernels import reservoir
    fn = reservoir.reservoir_fold
    inp, ring = fold_batch_case(torch, gen, w, k, s, n_max, m, leaves,
                                steady=True)
    need = [fold_need(torch, fold_of(inp, i, j), n_max)["bytes"]
            for i in range(w) for j in range(k)]
    nbytes = sum(need)

    def batched():
        fn(values=ring, **inp)

    def looped():
        for i in range(w):
            for j in range(k):
                fn(**fold_of(dict(inp, values=ring), i, j))
    turns = []
    for name in "ABBA":
        prof = device_profile(looped if name == "A" else batched, torch)
        kernels, memsets = log_launches(f"fold batch {case} {name}", prof)
        turns.append(dict(
            calls=name, device_ms=sum(v[0] for v in prof.values()),
            kernels=kernels, memsets=memsets,
            events_ms=time_ms(looped if name == "A" else batched, torch),
            split={n: v[0] for n, v in prof.items()}))
        want = (PARTED_LAUNCHES if fold_form(s) == "parted" else
                SMALL_FORM_LAUNCHES)["fold"] * (w * k if name == "A" else 1)
        if (kernels, memsets) != (want, 0):
            fail(f"fold batch {case} {name}: {kernels:g} kernels and "
                 f"{memsets:g} memsets per chunk, not {want} and none")
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log_split(f"fold batch {case} B", turns[1]["split"],
              turns[1]["events_ms"])
    log(f"[fold] batched {case}: W = {w}, K = {k}, ring {[w, k, s, n_max]}, "
        f"items {[w, m]} ({fold_form(s)} form): device ms per chunk in "
        "turns " + ", ".join(f"{t['calls']} {t['device_ms']:.5f} "
                             f"({t['kernels']:g} kernels)" for t in turns)
        + f" (A: {w * k} unbatched calls, B: one batched call); events "
        + ", ".join(f"{t['events_ms']:.5f}" for t in turns)
        + f" ms; bound {bound:.5f} ms by bytes ({nbytes} B, the folds' "
        f"sum, {min(need)}-{max(need)} each); {card()}")
    return dict(case=case, w=w, k=k, s=s, n_max=n_max, items=m,
                form=fold_form(s), turns=turns, bound_ms=bound,
                bytes=nbytes, fold_bytes=need, card=card())


def fold_batches(torch, gen) -> list:
    """The fold batched over W·K folds (module docstring, phase 2):
    :func:`fold_batch_check` at every FOLD_BATCHES case;
    ``chiprun_out/chip_smoke_fold_batches.json``."""
    checks = [fold_batch_check(torch, gen, *c) for c in FOLD_BATCHES]
    (ROOT / "chiprun_out" / "chip_smoke_fold_batches.json").write_text(
        json.dumps(dict(checks=checks, card=card()), indent=1))
    return checks


def make_disordered_stream(torch, seed: int, dev):
    """The §5.1 stream (aggregator seed ``seed + 1``) from DISORDER_T0 s
    on, with SHIFT_P of the items shifted back by U(0, SHIFT_MAX) s (the
    shifts drawn on the card from a seeded generator), and the script's own verdict on every item, chunk by
    chunk, from the chunk times, the pre-chunk watermark and ring
    eviction: the exact float64 per-(interval, stratum) count, sum and
    count(x > THRESHOLD) over the accepted items after each chunk, and the
    accepted / on-time / late / dropped totals."""
    from repro_torch.runtime.records import TimestampedChunk
    from repro_torch.stream import GaussianSource, StreamAggregator
    agg = StreamAggregator(GaussianSource(), seed=seed + 1, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    recip = float(np.float32(1.0) / np.float32(SPAN))
    n_iv = int((DISORDER_T0 + CHUNKS * M / RATE) // SPAN) + 1
    acc = torch.zeros((3, n_iv, S), dtype=torch.float64, device=dev)
    totals = dict(on_time=0, late=0, dropped=0)
    frontier, open_iv = np.float32(-3.0e38), 0
    chunks, exact = [], []
    for e in range(CHUNKS):
        c = agg.interval_chunk(e, M)
        vals, sid = c.values, c.stratum_ids
        base = (torch.arange(M, dtype=torch.float32, device=dev)
                / float(np.float32(RATE))
                + float(np.float32(DISORDER_T0 + e * M / RATE)))
        shift = torch.where(
            torch.rand(M, generator=gen, device=dev) < SHIFT_P,
            torch.rand(M, generator=gen, device=dev) * SHIFT_MAX, 0.0)
        t = torch.clamp(base - shift, min=0.0)
        chunks.append(TimestampedChunk(
            values=vals, stratum_ids=sid, times=t,
            mask=torch.ones(M, dtype=torch.bool, device=dev)))
        tgt = torch.floor(t * recip).to(torch.int32)
        wmark = float(frontier - np.float32(LATENESS))   # pre-chunk, f32
        new_open = max(open_iv, int(tgt.max()))
        ok = ~(t < wmark) & (tgt >= new_open - K + 1)
        totals["late"] += int((ok & (tgt < open_iv)).sum())
        totals["on_time"] += int((ok & (tgt >= open_iv)).sum())
        totals["dropped"] += int((~ok).sum())
        cell = (tgt.long() * S + sid.long())[ok]
        v = vals[ok].double()
        acc[0].view(-1).index_add_(0, cell, torch.ones_like(v))
        acc[1].view(-1).index_add_(0, cell, v)
        acc[2].view(-1).index_add_(0, cell, (v > THRESHOLD).double())
        exact.append(acc.clone())
        frontier = max(frontier, np.float32(float(t.max())))
        open_iv = new_open
    accepted = [int(c) for c in acc[0].sum(dim=0).tolist()]
    return chunks, exact, accepted, totals




def state_bits(state) -> dict:
    """The state as numpy, less the wall-clock controller leaves."""
    from repro_torch.runtime import convert
    d = convert.state_to_numpy(state)
    d["ctrl"].pop("latency_ema")
    d["ctrl"].pop("pressure")
    return d


def same_state(a, b, path="state") -> list:
    if isinstance(a, dict):
        return [bad for k in a for bad in same_state(a[k], b[k],
                                                      f"{path}.{k}")]
    return [] if a.tobytes() == b.tobytes() else [path]


def device_ms_per_call(fn, torch, calls: int) -> float:
    """Profiler device time of ``fn`` (which makes ``calls`` calls), per
    call: every kernel and memset it ran, summed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA)
    return busy / calls / 1e3


def phase_paths(torch, seed: int, dev) -> dict:
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.runtime.executor import (BatchedExecutor,
                                              PipelinedExecutor,
                                              RuntimeConfig, _ingest_chunk)
    from repro_torch.runtime.registry import QueryRegistry
    chunks, exact, accepted, totals = make_disordered_stream(torch, seed,
                                                             dev)
    log(f"[paths] disordered stream: script's verdict {totals}, accepted "
        f"per stratum {accepted}")
    if min(totals.values()) == 0:
        fail(f"the disordered stream lacks on-time, late or dropped items: "
             f"{totals}")
    paths = {
        "a": (PipelinedExecutor, "fused", "cadence"),
        "b": (PipelinedExecutor, "onekernel", "cadence"),
        "c": (BatchedExecutor, "onekernel", "cadence"),
        "d": (PipelinedExecutor, "masked", "cadence"),
        "e": (PipelinedExecutor, "onekernel", "watermark"),
        "f": (BatchedExecutor, "onekernel", "watermark"),
    }
    runs, execs = {}, {}
    for tag, (cls, ingest, emission) in paths.items():
        cfg = RuntimeConfig(num_strata=S, capacity=N_MAX, num_intervals=K,
                            interval_span=SPAN, allowed_lateness=LATENESS,
                            emit_every=EMIT_EVERY, batch_chunks=EMIT_EVERY,
                            ingest=ingest, emission=emission)
        reg = (QueryRegistry().register("sum", "sum")
               .register("mean", "mean")
               .register("count", "count",
                         predicate=lambda x: x > THRESHOLD))
        ex = cls(cfg, reg, prng.PRNGKey(seed), device=dev)
        ex.run(chunks[:EMIT_EVERY])        # warm-up
        ex.reset(prng.PRNGKey(seed))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        ems = ex.run(chunks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        runs[tag] = dict(ems=ems, launches=launches, walls=[wall],
                         state=state_bits(ex.state),
                         mirror_wait_s=ex.mirror_wait_s, cfg=cfg)
        execs[tag] = ex
        m = ex.state.metrics
        log(f"[paths] ({tag}) {cls.__name__} ingest={ingest} emission="
            f"{emission}: {len(ems)} emissions, launches {launches}, "
            f"accepted {m.accepted.tolist()} late {m.late.tolist()} "
            f"dropped {m.dropped.tolist()}")
        if m.accepted.tolist() != accepted:
            fail(f"path {tag}: runtime accepted {m.accepted.tolist()} != "
                 f"script's {accepted}")
        wm_ = ex.state.wm
        got = dict(on_time=int(wm_.on_time), late=int(wm_.late),
                   dropped=int(wm_.dropped))
        if got != totals:
            fail(f"path {tag}: watermark accounting {got} != script's "
                 f"{totals}")
        one = launches["one_shot_ingest"]
        if ingest == "onekernel" and (one == 0
                                      or launches["reservoir_fold"] != 0):
            fail(f"path {tag} did not run the one-shot kernel alone: "
                 f"{launches}")
        if ingest != "onekernel" and (one != 0
                                      or launches["reservoir_fold"] == 0):
            fail(f"path {tag} did not run the fold kernel: {launches}")
        if ingest == "masked" and launches["reservoir_fold"] != CHUNKS:
            fail(f"path {tag}: {launches['reservoir_fold']} fold calls for "
                 f"{CHUNKS} chunks, not one batched call over the K slots "
                 "per chunk")
        for em in ems:
            if emission == "cadence":
                check_answers(f"paths ({tag})", em, live_intervals(em),
                              exact[(em.index + 1) * EMIT_EVERY - 1])
            else:
                check_answers(f"paths ({tag})", em, [em.interval], exact[-1])

    ref_state = runs["a"]["state"]
    for tag in "bcd":
        bad = same_state(ref_state, runs[tag]["state"])
        log(f"[paths] ({tag}) state bitwise equal to (a): {not bad}")
        if bad:
            fail(f"path {tag} state differs from (a): {bad[:5]}")
    for tag in "bc":
        a, b = runs["a"]["ems"], runs[tag]["ems"]
        if len(a) != len(b):
            fail(f"path {tag}: {len(b)} emissions, (a) has {len(a)}")
        for x, y in zip(a, b):
            for f in ("index", "watermark", "open_interval", "on_time",
                      "late", "dropped", "items", "interval"):
                if getattr(x, f) != getattr(y, f):
                    fail(f"path {tag} emission {x.index} field {f}")
            if not (x.capacity == y.capacity).all():
                fail(f"path {tag} emission {x.index} capacity")
            for q in x.results:
                for f in ("value", "variance"):
                    if not same_bits(torch, getattr(x.results[q], f),
                                     getattr(y.results[q], f)):
                        fail(f"path {tag} emission {x.index} {q}.{f} bits")
        log(f"[paths] ({tag}) {len(b)} emissions equal to (a)'s, answers "
            "bit for bit")
    ivs = {t: [em.interval for em in runs[t]["ems"]] for t in "ef"}
    log(f"[paths] (e) closes {ivs['e']}, (f) closes {ivs['f']}")
    if ivs["e"] != ivs["f"] or ivs["e"] != list(range(len(ivs["e"]))) \
            or not ivs["e"]:
        fail(f"watermark paths closed different intervals: {ivs}")
    for x, y in zip(runs["e"]["ems"], runs["f"]["ems"]):
        for q in x.results:
            for f in ("value", "variance"):
                if not same_bits(torch, getattr(x.results[q], f),
                                 getattr(y.results[q], f)):
                    fail(f"watermark paths differ on interval {x.interval} "
                         f"{q}.{f}")
    log("[paths] (e) and (f) answers equal bit for bit")

    # Throughput of (a), (b), (c): PATH_WINDOWS windows each, in turns.
    for _ in range(PATH_WINDOWS - 1):
        for tag in "abc":
            ex = execs[tag]
            ex.reset(prng.PRNGKey(seed))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ex.run(chunks)
            torch.cuda.synchronize()
            runs[tag]["walls"].append(time.perf_counter() - t0)
    rates = {}
    for tag in "abc":
        r = sorted(CHUNKS * M / w for w in runs[tag]["walls"])
        rates[tag] = r[len(r) // 2]
        log(f"[paths] ({tag}) median {rates[tag]:.6g} items/s over "
            f"{len(r)} windows (all {[round(x) for x in r]})")

    # Device time of the ingest alone per chunk, (a) and (b), profiler.
    ingest_dev = {}
    for tag in "ab":
        ex = execs[tag]
        ex.reset(prng.PRNGKey(seed))
        box = [ex.state]

        def ingest_all():
            for ch in chunks[:8]:
                box[0] = _ingest_chunk(runs[tag]["cfg"], box[0], ch)
        ingest_all()                       # warm
        ex.reset(prng.PRNGKey(seed))
        box[0] = ex.state
        ingest_dev[tag] = device_ms_per_call(ingest_all, torch, 8)
    wait_ms = runs["e"]["mirror_wait_s"] / CHUNKS * 1e3
    log(f"[paths] ingest device ms per chunk (profiler, 8 chunks): "
        f"(a) fused {ingest_dev['a']:.4f}, (b) onekernel "
        f"{ingest_dev['b']:.4f}; (e) host wait on the mirror event "
        f"{wait_ms:.4f} ms per chunk")
    return dict(launches=runs["b"]["launches"], rates=rates,
                ingest_dev=ingest_dev, wait_ms=wait_ms)


WHIST_CASES = ("uniform", "log2", "narrow", "all_masked", "collapsed",
               "on_edges", "ragged", "max_cells_bins")
WHIST_TIMED = ("uniform", "log2", "narrow")


def whist_inputs(torch, gen, case):
    """Inputs of one weighted-histogram call at the emission's shape: the
    flattened ``[6, 1,048,576]`` view (cell = row, per-cell HT weight,
    slot mask from a per-cell sample size) of floored log-normal flow
    sizes, and the edges of a first quantile round over the sample's
    range (``"uniform"``, 32 bins), of a later round's bracket between the
    live values' 0.50 and 0.51 quantiles (``"narrow"``, 32 bins, most
    items outside), or the histogram query's ``2^0 ... 2^24`` (``"log2"``,
    24 bins). ``(x, cell, w, mask, edges, G)``."""
    from repro_torch.core.quantile import _unit_edges
    from repro_torch.kernels.weighted_hist import MAX_CELLS_BINS
    dev = gen.device
    g, m = K * S, K * S * N_MAX
    if case == "ragged":
        m -= 77
    x = torch.floor(torch.exp(7.5 + 1.8 * torch.randn(
        m, generator=gen, device=dev)))
    slot = torch.arange(m, device=dev)
    if case == "max_cells_bins":
        g = MAX_CELLS_BINS // REFINE_BINS
        cell = torch.randint(0, g, (m,), generator=gen, device=dev,
                             dtype=torch.int32)
    else:
        cell = (slot // N_MAX).to(torch.int32)
    w = (1.0 + 3.0 * torch.rand(g, generator=gen, device=dev))[cell.long()]
    taken = torch.randint(N_MAX // 2, N_MAX + 1, (g,), generator=gen,
                          device=dev)
    mask = (slot % N_MAX) < taken[cell.long()]
    if case == "log2":
        edges = torch.tensor(LOG2_EDGES, dtype=torch.float32, device=dev)
    elif case == "collapsed":
        x = torch.full_like(x, 1480.0)
        edges = torch.full((REFINE_BINS + 1,), 1480.0, device=dev)
    elif case == "narrow":
        live = x[mask].sort().values
        lo, hi = (float(live[int(q * (live.numel() - 1))])
                  for q in (0.50, 0.51))
        edges = lo + (hi - lo) * _unit_edges(REFINE_BINS, dev)
    else:
        lo, hi = float(x[mask].min()), float(x[mask].max())
        edges = lo + (hi - lo) * _unit_edges(REFINE_BINS, dev)
    if case == "on_edges":
        pool = torch.cat([edges, edges[:1] - 1.0, edges[-1:] + 1.0])
        x = pool[torch.randint(0, pool.numel(), (m,), generator=gen,
                               device=dev)]
    if case == "all_masked":
        mask = torch.zeros_like(mask)
    return x, cell, w, mask, edges, g


def phase_weighted_hist(torch, gen):
    """The weighted-histogram kernel against its plain version in every
    case of ``WHIST_CASES`` (counts bit for bit, mass within STATS_RTOL of
    the f64-summed plain version, the same bits on a second call, the
    tickets 0 after it), then its times at the ``WHIST_TIMED`` inputs
    (``whist_timing``) beside their bounds and the nearest PyTorch
    composition."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import weighted_hist as wk
    dev = gen.device
    worst = 0.0
    for case in WHIST_CASES:
        x, cell, w, mask, edges, g = whist_inputs(torch, gen, case)
        kh, kc = wk.weighted_hist(x, cell, w, mask, edges, g)
        ph, pc = ref.weighted_hist(x, cell, w, mask, edges, g)
        kh2, kc2 = wk.weighted_hist(x, cell, w, mask, edges, g)
        torch.cuda.synchronize()
        rel = float(((kh - ph).abs() / ph.abs().clamp(min=1e-30)).max())
        worst = max(worst, float((kh - ph).abs().max()))
        again = same_bits(torch, kh2, kh) and same_bits(torch, kc2, kc)
        clean = workspace_clean(torch)
        log(f"[weighted_hist] {case}: M={x.numel()} G={g} "
            f"B={edges.numel() - 1} counts bitwise={torch.equal(kc, pc)} "
            f"mass rel err {rel:.3e} (rtol {STATS_RTOL}) second call "
            f"same bits={again} tickets clean={clean} in-bin items "
            f"{int(kc.sum())}")
        if not torch.equal(kc, pc):
            fail(f"weighted_hist counts differ from the plain version "
                 f"({case})")
        if rel > STATS_RTOL:
            fail(f"weighted_hist mass outside rtol ({case})")
        if not again:
            fail(f"weighted_hist is not deterministic ({case})")
        if not clean:
            fail(f"weighted_hist left a ticket dirty ({case})")
        if case == "collapsed" and (float(kc[:, :-1].sum()) != 0.0 or
                                    float(kc.sum()) != float(mask.sum())):
            fail("collapsed edges: not every value in the last bin")
        if case == "all_masked" and float(kc.sum()) != 0.0:
            fail("all-masked call counted items")

    for case in WHIST_TIMED:
        t = whist_timing(torch, dev, case)
        need = whist_need(torch, *t["inputs"])
        bound = max(need["bytes"] / HBM_BYTES_PER_S,
                    need["ops"] / F32_OPS_PER_S) * 1e3
        log(f"[weighted_hist] {case} [{K * S} x {N_MAX}], B={need['bins']}:"
            f" kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"bucketize + index_add_ {t['library_ms']:.4f} ms, bound "
            f"{bound:.4f} ms ({need['bytes']} B the function needs: "
            f"{need['slots']} mask bytes, {need['live']} live x 4 B, "
            f"{need['in_bin']} in a bin x 8 B, edges and [G, B] x 2 out)")
        log_split(f"weighted_hist {case}",
                  {k: v[0] for k, v in t["prof"].items()}, t["ms"])
        one_launch(f"weighted_hist {case}", t["prof"])
        if case == "uniform":        # the kernels line: a first round
            uniform = dict(
                max_abs_err=worst, ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=bound,
                bound_by="bytes" if need["bytes"] / HBM_BYTES_PER_S
                >= need["ops"] / F32_OPS_PER_S else "operations",
                library_ms=t["library_ms"])
    return uniform


def whist_timing(torch, dev, case: str, seed: int = TIMING_SEED) -> dict:
    """Times the histogram kernel at ``whist_inputs``' ``case`` made from
    ``seed``: CUDA events around back-to-back calls, the plain version,
    ``bucketize`` + ``index_add_`` of the same mass, and the profiler's
    kernels and memsets per call. Only the wrapper and the plain version
    are called, so the same inputs time any tree's kernel."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import weighted_hist as wk
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x, cell, w, mask, edges, g = whist_inputs(torch, gen, case)
    nb = edges.numel() - 1

    def kernel():
        return wk.weighted_hist(x, cell, w, mask, edges, g)
    ms = time_ms(kernel, torch)
    plain_ms = time_ms(lambda: ref.weighted_hist(x, cell, w, mask, edges, g),
                       torch, reps=3, warm=1)
    acc = torch.zeros(g * nb, device=dev)
    key_base = cell.long() * nb
    w_live = torch.where(mask, w, 0.0)

    def library():
        b = torch.bucketize(x, edges, right=True) - 1
        acc.zero_().index_add_(0, key_base + b.clamp(0, nb - 1), w_live)
    library_ms = time_ms(library, torch)
    prof = device_profile(kernel, torch)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, prof=prof,
                inputs=(x, cell, w, mask, edges, g))


def whist_need(torch, x, cell, w, mask, edges, g) -> dict:
    """Bytes the histogram of ``(x, cell, w, mask)`` over ``edges`` and
    ``g`` cells must move: every mask byte, the value of each live slot,
    the cell id and weight of each item in a bin (the plain version's
    counts), the edges, and the two f32 ``[G, B]`` outputs; and its
    operations (the bin search, the range test and one add per live
    slot)."""
    from repro_torch.kernels import ref
    nb = edges.numel() - 1
    slots = x.numel()
    live = int(mask.sum())
    in_bin = int(ref.weighted_hist(x, cell, w, mask, edges, g)[1].sum())
    nbytes = slots + 4 * live + 8 * in_bin + 4 * (nb + 1) + 8 * g * nb
    ops = (math.ceil(math.log2(nb)) + 4) * live
    return dict(bytes=nbytes, ops=ops, slots=slots, live=live,
                in_bin=in_bin, bins=nb)


def nonlinear_registry():
    """The §6.1 network-traffic standing queries."""
    from repro_torch.runtime.registry import QueryRegistry
    return (QueryRegistry()
            .register("sum", "sum")
            .register("bytes_per_protocol", "sum", window="per_key")
            .register("session_bytes", "sum", window="session",
                      session_gap=SESSION_GAP)
            .register("q_sort", "quantile", qs=NL_QS)
            .register("q_hist", "quantile", qs=NL_QS, method="hist")
            .register("q_protocol", "quantile", qs=NL_KEY_QS,
                      window="per_key")
            .register("hist_log2", "histogram", edges=LOG2_EDGES)
            .register("top", "heavy_hitters", k=TOP_K)
            .register("distinct", "distinct"))


def make_netflow_stream(torch, seed: int, dev):
    """The §6.1 NetFlow stream (TCP/UDP/ICMP at 0.85/0.13/0.02, log-normal
    bytes; aggregator seed ``seed + 2``), flow sizes floored to whole
    bytes, stamped in order at RATE, made on the card."""
    from repro_torch.runtime.records import stamp
    from repro_torch.stream import NetflowSource, StreamAggregator
    agg = StreamAggregator(NetflowSource(), seed=seed + 2, device=dev)
    chunks = []
    for e in range(NL_CHUNKS):
        c = agg.interval_chunk(e, M)
        chunks.append(stamp(torch.floor(c.values), c.stratum_ids,
                            e * M / RATE, RATE))
    return chunks


def sampled_window(ex, em):
    """The emission's own sample, read right after it: the valid slot
    values of the view it answered (the closed interval's cells under
    watermark emission) and its largest HT weight."""
    from repro_torch.core import window as win
    from repro_torch.runtime.executor import _interval_cell_mask
    view = win.sample_view(ex.state.window)
    if em.interval is not None:
        view = win.restrict_view(view, _interval_cell_mask(
            ex.cfg, ex.state, em.interval))
    return view.values[view.slot_mask()], float(view.weights().max())


class Checker:
    """Every answer of one emission against the exact window the script
    keeps on the card; counts the checks and logs one line per query."""

    def __init__(self, torch, tag, em):
        self.torch, self.tag, self.em = torch, tag, em

    def near(self, name, est, exact, weight=None) -> None:
        """Each entry within 3 sigma (+ f32 rounding) of ``exact``.

        For a count (``weight`` = the view's largest HT weight W) sigma is
        the larger of the estimate's own and ``sqrt(n (W - 1))``, which
        bounds the sampling sd of an HT count of ``n`` items: a bin or key
        with a handful of items may have none sampled, and then its Eq. 6
        variance is 0 while its count is not."""
        torch = self.torch
        v = est.value.double().reshape(-1)
        var = est.variance.double().clamp(min=0).reshape(-1)
        want = torch.as_tensor(exact, dtype=torch.float64,
                               device=v.device).reshape(-1)
        if weight is not None:
            var = torch.maximum(var, want * (weight - 1.0))
        sig = var.sqrt()
        slack = 3 * sig + ANSWER_RTOL * want.abs()
        ratio = float(((v - want).abs() / slack.clamp(min=1e-30)).max())
        ok = bool(((v - want).abs() <= slack).all())
        log(f"[{self.tag}] emission {self.em.index} {name}: {v.numel()} "
            f"entries, worst |err| / (3 sigma + rtol) {ratio:.4f} "
            f"{'ok' if ok else 'OUTSIDE'}")
        if not ok:
            fail(f"{self.tag} emission {self.em.index} {name}: "
                 f"{v.tolist()} vs exact {want.tolist()}, sigma "
                 f"{sig.tolist()}")

    def quantiles(self, name, value, xs_sorted, qs, slack=0.0) -> None:
        """Each level inside the exact window's quantiles at q ± Q_SLACK
        (``slack`` more for the histogram method)."""
        n = xs_sorted.numel()

        def at(p):
            i = min(max(math.ceil(p * n) - 1, 0), n - 1)
            return float(xs_sorted[i])
        got = value.reshape(-1).tolist()
        bad = [(q, v, at(q - Q_SLACK), at(q + Q_SLACK))
               for q, v in zip(qs, got)
               if not at(q - Q_SLACK) - slack <= v <= at(q + Q_SLACK) + slack]
        log(f"[{self.tag}] emission {self.em.index} {name}: "
            f"{[round(v, 3) for v in got]} at {list(qs)} "
            f"{'ok' if not bad else 'OUTSIDE'}")
        if bad:
            fail(f"{self.tag} emission {self.em.index} {name} outside the "
                 f"exact quantiles at q +- {Q_SLACK}: {bad}")


def session_of(intervals_with_items, gap: int) -> list:
    """A key's current session: its active intervals, newest first, while
    consecutive ones are at most ``gap`` apart."""
    out = []
    for iv in sorted(intervals_with_items, reverse=True):
        if out and out[-1] - iv > gap:
            break
        out.append(iv)
    return out


def check_nonlinear(torch, tag, em, chunks, upto, sampled) -> None:
    """The emission's answers against the exact window over the first
    ``upto`` chunks (an in-order stream: every item is accepted);
    ``sampled`` is :func:`sampled_window`'s."""
    sample, weight = sampled
    from repro_torch.runtime.watermark import interval_of
    dev = chunks[0].values.device
    vals = torch.cat([c.values for c in chunks[:upto]])
    sid = torch.cat([c.stratum_ids for c in chunks[:upto]]).long()
    iv = interval_of(torch.cat([c.times for c in chunks[:upto]]), SPAN)
    live = [i for i in range(em.open_interval - K + 1,
                             em.open_interval + 1) if i >= 0]
    base = [em.interval] if em.interval is not None else live
    sel = torch.isin(iv, torch.tensor(base, device=dev, dtype=iv.dtype))
    x, s = vals[sel], sid[sel]
    r, c = em.results, Checker(torch, tag, em)
    c.near("sum", r["sum"], x.double().sum())
    c.near("bytes_per_protocol", r["bytes_per_protocol"],
           [x[s == k].double().sum() for k in range(S)])
    ring = [i for i in live if em.interval is None or i <= em.interval]
    gap = max(1, math.ceil(SESSION_GAP / SPAN))
    sess = []
    for k in range(S):
        ivs = session_of([i for i in ring if bool(((iv == i)
                                                   & (sid == k)).any())],
                         gap)
        pick = (sid == k) & torch.isin(iv, torch.tensor(
            ivs or [-1], device=dev, dtype=iv.dtype))
        sess.append(vals[pick].double().sum())
    c.near("session_bytes", r["session_bytes"], sess)
    e = torch.tensor(LOG2_EDGES, dtype=torch.float32, device=dev)
    b = torch.bucketize(x, e, right=True) - 1
    b = torch.where(x == e[-1], len(LOG2_EDGES) - 2, b)   # right-closed
    inside = (b >= 0) & (b < len(LOG2_EDGES) - 1)
    c.near("hist_log2", r["hist_log2"],
           torch.bincount(b[inside], minlength=len(LOG2_EDGES) - 1),
           weight=weight)
    xs = torch.sort(x).values
    c.quantiles("q_sort", r["q_sort"].value, xs, NL_QS)
    lo0, hi0 = float(sample.min()), float(sample.max())
    c.quantiles("q_hist", r["q_hist"].value, xs, NL_QS,
                slack=(hi0 - lo0) / REFINE_BINS ** REFINE_STEPS)
    for k in range(S):
        c.quantiles(f"q_protocol[{k}]", r["q_protocol"].value[k],
                    torch.sort(x[s == k]).values, NL_KEY_QS)
    uniq, cnt = torch.unique(x, return_counts=True)
    kth = float(torch.topk(cnt, TOP_K).values[-1])
    hh = r["top"]
    pos = torch.searchsorted(uniq, hh.keys).clamp(max=uniq.numel() - 1)
    exact = torch.where(uniq[pos] == hh.keys, cnt[pos], 0)
    c.near("top (estimates)", hh.estimate, exact, weight=weight)
    sig = torch.maximum(hh.estimate.variance.double().clamp(min=0),
                        exact.double() * (weight - 1.0)).sqrt()
    short = exact.double() < kth - 3 * sig
    log(f"[{tag}] emission {em.index} top keys {hh.keys.tolist()} exact "
        f"counts {exact.tolist()}, exact 8th-largest count {kth:.0f}")
    if bool(short.any()):
        fail(f"{tag} emission {em.index}: a reported heavy hitter's exact "
             "count is below the exact 8th-largest less 3 sigma")
    d = r["distinct"]
    seen = torch.unique(sample).numel()
    log(f"[{tag}] emission {em.index} distinct: Chao1 {float(d.value):.1f} "
        f"sd {math.sqrt(max(float(d.variance), 0.0)):.1f}, sampled "
        f"{seen}, exact {uniq.numel()}")
    if not math.isfinite(float(d.value)) or float(d.value) < seen:
        fail(f"{tag} emission {em.index}: Chao1 {float(d.value)} not "
             f"finite or below the sampled distinct count {seen}")


def profile_emission(torch, fn, wall_ms: float) -> None:
    """Device time of one nonlinear emission by kernel name (profiler):
    the busy share and the top kernels in the log, the whole table in
    chiprun_out/chip_smoke_nonlinear_profile.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    busy = sum(t for t, _ in by_name.values())
    launches = sum(c for _, c in by_name.values())
    log(f"[nonlinear] one nonlinear emission: device busy {busy:.4f} ms of "
        f"{wall_ms:.4f} ms, {launches} device activities (profiler)")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (t, c) in ranked[:8]:
        log(f"[nonlinear]   {t:10.4f} ms {c:7d}x  {name[:100]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_nonlinear_profile.txt").write_text("\n".join(
        f"{t:.4f} ms {c}x {name}" for name, (t, c) in ranked))


def results_bits(torch, results) -> dict:
    from repro_torch.runtime import convert
    return {name: {f: a.tobytes() for f, a in r.items()}
            for name, r in convert.results_to_numpy(results).items()}


def phase_nonlinear(torch, seed: int, dev) -> dict:
    """The §6.1 network-traffic deployment at phase main's ring size
    through four paths; every answer against the exact window."""
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.runtime.executor import (BatchedExecutor,
                                              PipelinedExecutor,
                                              RuntimeConfig, _evaluate)
    from repro_torch.runtime.registry import QueryRegistry
    chunks = make_netflow_stream(torch, seed, dev)
    paths = {
        "1": (PipelinedExecutor, "fused", "cadence"),
        "2": (PipelinedExecutor, "onekernel", "cadence"),
        "3": (BatchedExecutor, "onekernel", "cadence"),
        "4": (PipelinedExecutor, "onekernel", "watermark"),
    }
    runs = {}
    for tag, (cls, ingest, emission) in paths.items():
        cfg = RuntimeConfig(num_strata=S, capacity=N_MAX, num_intervals=K,
                            interval_span=SPAN, allowed_lateness=LATENESS,
                            emit_every=EMIT_EVERY, batch_chunks=EMIT_EVERY,
                            ingest=ingest, emission=emission)
        ex = cls(cfg, nonlinear_registry(), prng.PRNGKey(seed), device=dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        upto, samples = [], []
        for i, ch in enumerate(chunks):
            before = len(ex.emissions)
            ex.push(ch)
            for em in ex.emissions[before:]:
                upto.append(i + 1)
                samples.append(sampled_window(ex, em))
        ems = ex.finalize()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        log(f"[nonlinear] ({tag}) {cls.__name__} ingest={ingest} emission="
            f"{emission}: {len(ems)} emissions (intervals "
            f"{[em.interval for em in ems]}), launches {launches}")
        want = len(ems) * HIST_LAUNCHES
        if not ems or launches["weighted_hist"] != want:
            fail(f"path {tag}: weighted_hist launched "
                 f"{launches['weighted_hist']} times, expected {want}")
        kernel = "one_shot_ingest" if ingest == "onekernel" else \
            "reservoir_fold"
        if launches[kernel] == 0:
            fail(f"path {tag} did not run {kernel}: {launches}")
        tname = f"nonlinear ({tag})"
        for em, n, smp in zip(ems, upto, samples):
            check_nonlinear(torch, tname, em, chunks, n, smp)
        runs[tag] = dict(ems=ems, launches=launches, ex=ex, cfg=cfg,
                         state=state_bits(ex.state))
    if [em.interval for em in runs["4"]["ems"]] != [0]:
        fail("watermark path did not close interval 0 exactly once")
    for tag in "23":
        bad = same_state(runs["1"]["state"], runs[tag]["state"])
        if bad:
            fail(f"nonlinear path {tag} state differs from (1): {bad[:5]}")
        a, b = runs["1"]["ems"], runs[tag]["ems"]
        if len(a) != len(b):
            fail(f"nonlinear path {tag}: {len(b)} emissions, (1) {len(a)}")
        for x, y in zip(a, b):
            if results_bits(torch, x.results) != \
                    results_bits(torch, y.results):
                fail(f"nonlinear path {tag} emission {x.index}: answers "
                     "differ in their bits from (1)")
        log(f"[nonlinear] ({tag}) state and all {len(b)} emissions' answers "
            "bit for bit equal to (1)")

    # Emission latency on one state: this registry against phase main's.
    ex, cfg = runs["2"]["ex"], runs["2"]["cfg"]
    linear = (QueryRegistry().register("sum", "sum").register("mean", "mean")
              .register("count", "count", predicate=lambda x: x > THRESHOLD))
    lat = {}
    for name, reg in (("linear", linear), ("nonlinear", ex.registry)):
        walls = []
        for _ in range(LATENCY_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _evaluate(cfg, reg, ex.state)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        lat[name] = sorted(walls)[len(walls) // 2]
        log(f"[nonlinear] {name} registry: one emission's evaluation "
            f"{lat[name]:.4f} ms (median of {[round(w, 4) for w in walls]})")
    profile_emission(torch, lambda: _evaluate(cfg, ex.registry, ex.state),
                     lat["nonlinear"])

    # What the bootstrap's draws and sorts cost, at the view's shape.
    g, n = K * S, N_MAX
    key = prng.PRNGKey(seed, device=dev)
    top = torch.full((g, 1), n, dtype=torch.int32, device=dev)
    draw_ms = time_ms(lambda: prng.randint(key, (g, n), 0, top), torch,
                      reps=5, warm=1)
    xs = torch.rand(g * n, device=dev)
    sort_ms = time_ms(lambda: torch.argsort(xs, stable=True), torch, reps=5,
                      warm=1)
    reps = 32
    draws = reps * (3 + S)                    # q_sort, q_hist, distinct, keys
    sorts = (1 + reps) * (2 + S) + reps + 2   # quantiles, chao1, top-k
    share = (draws * draw_ms + sorts * sort_ms) / lat["nonlinear"]
    log(f"[nonlinear] per emission {draws} randint draws of [{g} x {n}] at "
        f"{draw_ms:.4f} ms and {sorts} stable sorts of {g * n} at "
        f"{sort_ms:.4f} ms: {share:.4f} of the emission; weighted_hist "
        f"launches per emission {HIST_LAUNCHES}")
    return dict(launches=runs["1"]["launches"], latency=lat, share=share,
                path2=dict(ex=runs["2"]["ex"], ems=runs["2"]["ems"],
                           chunks=chunks))


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return smi.stdout.strip()


def emission_bits(torch, em) -> tuple:
    """Everything of an emission but its wall-clock latency, as bytes."""
    return (em.index, em.interval, em.watermark, em.open_interval,
            em.on_time, em.late, em.dropped, em.items,
            em.capacity.tobytes(), results_bits(torch, em.results))


def crash_and_recover(torch, victim, recovery, chunks, crash_after, key):
    """Run ``victim`` with a cadence checkpointer (and a bootstrap save at
    offset 0), kill it after ``crash_after`` chunks: only the latest
    payload's bytes survive. Restore ``recovery`` (built with another key)
    from them and replay the chunks from the payload's offset. Returns
    the deduped output (pre-crash emissions below the payload's cursor,
    then the recovered ones), the checkpoint, the payload's bytes, the
    restore and replay wall ms, and the replay's kernel launches."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import Checkpointer
    victim.reset(key)
    victim.checkpointer = Checkpointer(every_chunks=RECOVERY_EVERY)
    victim.checkpointer.save(victim)
    for ch in chunks[:crash_after]:
        victim.push(ch)
    payload = victim.checkpointer.latest
    victim.checkpointer = None
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ckpt = recovery.restore(payload)
    t1 = time.perf_counter()
    for ch in chunks[ckpt.stream_offset:]:
        recovery.push(ch)
    recovered = recovery.finalize()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = victim.emissions[:ckpt.emissions_done] + recovered
    return (out, ckpt, len(payload), (t1 - t0) * 1e3, (t2 - t1) * 1e3,
            ops.launch_counts())


def check_exactly_once(torch, tag, reference, out, final, state) -> None:
    """The deduped output and the final state bit for bit the
    uninterrupted run's."""
    got = [emission_bits(torch, em) for em in out]
    if [g[0] for g in got] != list(range(len(reference))):
        fail(f"{tag}: emission indices {[g[0] for g in got]} after "
             f"recovery, expected 0..{len(reference) - 1}")
    for want, have in zip(reference, got):
        if want != have:
            fail(f"{tag}: emission {want[0]} differs from the "
                 "uninterrupted run's")
    bad = same_state(final, state_bits(state))
    if bad:
        fail(f"{tag}: final state differs from the uninterrupted run's: "
             f"{bad[:5]}")


def phase_recovery(torch, seed: int, dev, nonlinear: dict) -> dict:
    """Exactly-once recovery at phase main's width: three paths killed
    after chunks 6, 12 and 21 and restored from the payload's bytes into
    an executor built with another key; the cost of a checkpoint and of a
    recovery; items/s with and without checkpointing; and phase
    nonlinear's path (2) killed after chunk 6."""
    from repro_torch import prng
    from repro_torch.obs import EventLog, Telemetry, read_events
    from repro_torch.obs import export as obx
    from repro_torch.runtime import Checkpointer
    from repro_torch.runtime import checkpoint as ckp
    from repro_torch.runtime.executor import (BatchedExecutor,
                                              PipelinedExecutor,
                                              RuntimeConfig)
    from repro_torch.runtime.registry import QueryRegistry
    where = card()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    log_path = out_dir / "chip_smoke_recovery_events.jsonl"
    if log_path.exists():
        log_path.unlink()
    events = EventLog(str(log_path))
    in_order = make_stream(torch, seed, dev)[0]
    disordered = make_disordered_stream(torch, seed, dev)[0]
    paths = {
        "a": (PipelinedExecutor, "fused", "cadence", in_order),
        "b": (PipelinedExecutor, "onekernel", "watermark", disordered),
        "c": (BatchedExecutor, "onekernel", "cadence", in_order),
    }
    key, other = prng.PRNGKey(seed), prng.PRNGKey(seed + 1000)
    execs, replay_ms, restore_ms, sizes = {}, {}, {}, []
    for tag, (cls, ingest, emission, chunks) in paths.items():
        cfg = RuntimeConfig(num_strata=S, capacity=N_MAX, num_intervals=K,
                            interval_span=SPAN, allowed_lateness=LATENESS,
                            emit_every=EMIT_EVERY, batch_chunks=EMIT_EVERY,
                            ingest=ingest, emission=emission)

        def make(k):
            reg = (QueryRegistry().register("sum", "sum")
                   .register("mean", "mean")
                   .register("count", "count",
                             predicate=lambda x: x > THRESHOLD))
            return cls(cfg, reg, k, device=dev,
                       telemetry=Telemetry(events))
        victim, recovery = make(key), make(other)
        reference = [emission_bits(torch, em) for em in victim.run(chunks)]
        final = state_bits(victim.state)
        kernel = "one_shot_ingest" if ingest == "onekernel" else \
            "reservoir_fold"
        for k in RECOVERY_CRASHES:
            out, ckpt, nbytes, r_ms, p_ms, launches = crash_and_recover(
                torch, victim, recovery, chunks, k, key)
            check_exactly_once(torch, f"recovery ({tag}) crash after {k}",
                               reference, out, final, recovery.state)
            if launches[kernel] == 0 or launches["stratified_stats"] == 0:
                fail(f"recovery ({tag}): the replay after crash {k} did "
                     f"not run {kernel} and stratified_stats: {launches}")
            sizes.append(nbytes)
            replay = CHUNKS - ckpt.stream_offset
            restore_ms[(tag, k)] = r_ms
            replay_ms[(tag, k)] = p_ms
            log(f"[recovery] on {where}: ({tag}) {cls.__name__} "
                f"ingest={ingest} "
                f"emission={emission}, crash after chunk {k}: payload at "
                f"offset {ckpt.stream_offset} ({nbytes} B, "
                f"{ckpt.emissions_done} emissions done, "
                f"{ckpt.chunks_since_emit} chunks into the period), "
                f"restore {r_ms:.4f} ms, replay of {replay} chunks "
                f"{p_ms:.4f} ms ({p_ms / replay:.4f} ms per chunk), "
                f"launches {launches}; {len(out)} emissions and the final "
                "state bit for bit the uninterrupted run's")
        execs[tag] = (victim, recovery, chunks)

    # The parts of one capture and one restore, at path (a)'s full state.
    victim, recovery, chunks = execs["a"]
    victim.reset(key)
    victim.run(chunks)
    parts = {"d2h": [], "serialize": [], "deserialize": [], "h2d": []}
    for _ in range(RECOVERY_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = ckp.capture(victim)
        t1 = time.perf_counter()
        payload = ckp.to_bytes(snap)
        t2 = time.perf_counter()
        back = ckp.from_bytes(payload, recovery.state)
        t3 = time.perf_counter()
        ckp.restore_into(recovery, back)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for name, a, b in (("d2h", t0, t1), ("serialize", t1, t2),
                           ("deserialize", t2, t3), ("h2d", t3, t4)):
            parts[name].append((b - a) * 1e3)
        if same_state(state_bits(victim.state), state_bits(recovery.state)):
            fail("recovery: a restored state differs from its capture")
    med = {k: sorted(v)[len(v) // 2] for k, v in parts.items()}
    nbytes = len(payload)
    events.close()
    stats = obx.checkpoint_stats(str(log_path))
    restores = read_events(str(log_path), type="checkpoint_restore")
    log(f"[recovery] on {where}: payload {nbytes} B (the crashes' "
        f"{min(sizes)} to {max(sizes)} B: the header's length varies); "
        "capture: device to "
        f"host {med['d2h']:.4f} ms + serialize {med['serialize']:.4f} ms; "
        f"restore: deserialize {med['deserialize']:.4f} ms + host to "
        f"device {med['h2d']:.4f} ms (medians of {RECOVERY_REPS}: "
        f"{ {k: [round(x, 4) for x in v] for k, v in parts.items()} }); "
        f"copy rate {nbytes / med['d2h'] / 1e6:.4f} GB/s to the host, "
        f"{nbytes / med['h2d'] / 1e6:.4f} GB/s to the card")
    log(f"[recovery] on {where}: event log "
        f"chiprun_out/{log_path.name} by obs.export.checkpoint_stats: "
        f"{stats['saves']} saves, {stats['bytes_total']} B, capture and "
        f"serialize {stats['serialize_s_mean'] * 1e3:.4f} ms mean per save, "
        f"drift max {stats['drift_chunks_max']} chunks; "
        f"{stats['restores']} restores, "
        f"{[round(ev['restore_s'] * 1e3, 4) for ev in restores]} ms "
        "(deserialize, host to device, each)")

    # Items/s of path (a): no checkpointer, every 4 and every chunk, in turns.
    cadences = (None, 4, 1)
    rates = {c: [] for c in cadences}
    victim.telemetry = None
    for _ in range(RECOVERY_REPS):
        for every in cadences:
            victim.reset(key)
            victim.checkpointer = (None if every is None
                                   else Checkpointer(every_chunks=every))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            victim.run(chunks)
            torch.cuda.synchronize()
            rates[every].append(CHUNKS * M / (time.perf_counter() - t0))
    victim.checkpointer = None
    summary = {}
    for every, r in rates.items():
        r = sorted(r)
        name = "none" if every is None else f"every_{every}"
        summary[name] = r
        log(f"[recovery] on {where}: path (a) with "
            f"{'no checkpointer' if every is None else f'every_chunks={every}'}"
            f": median {r[len(r) // 2]:.6g} items/s (min {r[0]:.6g}, max "
            f"{r[-1]:.6g}; all {[round(x) for x in r]})")

    # Phase nonlinear's path (2), killed after chunk 6.
    ex2, ems2, nl_chunks = (nonlinear["path2"][k]
                            for k in ("ex", "ems", "chunks"))
    reference = [emission_bits(torch, em) for em in ems2]
    final = state_bits(ex2.state)
    rec2 = PipelinedExecutor(ex2.cfg, nonlinear_registry(), other,
                             device=dev)
    out, ckpt, _, r_ms, p_ms, launches = crash_and_recover(
        torch, ex2, rec2, nl_chunks, 6, prng.PRNGKey(seed))
    check_exactly_once(torch, "recovery (nonlinear 2) crash after 6",
                       reference, out, final, rec2.state)
    if launches["weighted_hist"] == 0 or launches["one_shot_ingest"] == 0:
        fail(f"recovery (nonlinear 2): the replay did not run the "
             f"histogram and one-shot kernels: {launches}")
    log(f"[recovery] on {where}: (nonlinear 2) crash after chunk 6: "
        "payload at offset "
        f"{ckpt.stream_offset}, replay of {NL_CHUNKS - ckpt.stream_offset} "
        f"chunks {p_ms:.4f} ms, launches {launches}; {len(out)} emissions "
        "and the final state bit for bit the uninterrupted run's")
    result = dict(card=where, payload_bytes=nbytes, parts_ms=parts,
                  replay_ms={f"{t}{k}": v for (t, k), v in replay_ms.items()},
                  restore_ms={f"{t}{k}": v
                              for (t, k), v in restore_ms.items()},
                  checkpoint_stats=stats, items_per_s=summary,
                  nonlinear_replay_ms=p_ms)
    (out_dir / "chip_smoke_recovery.json").write_text(
        json.dumps(result, indent=1))
    return result


# ---------------------------------------------------------------------------
# Phase sharded: the paper's four-worker deployment (placement="vmap").
# ---------------------------------------------------------------------------

def linear_registry():
    from repro_torch.runtime.registry import QueryRegistry
    return (QueryRegistry().register("sum", "sum").register("mean", "mean")
            .register("count", "count", predicate=lambda x: x > THRESHOLD))


def make_sharded_stream(torch, seed: int, dev, disorder: bool = False):
    """The §5.1 Gaussian stream over W_SHARDS shards
    (``sharded_interval`` of the aggregator), made on the card in bulk:
    chunk ``e`` gives every shard M_SHARD items on the same ramp
    ``t0 + j / RATE_SHARD`` (``stamp_sharded``), RATE items per
    event-time second in all. With ``disorder`` it starts at DISORDER_T0
    and SHIFT_P of the items are shifted back by U(0, SHIFT_MAX) s, as
    phase paths' stream. Returns the chunks and, for the ordered stream,
    the exact float64 per-(interval, stratum) count, sum and
    count(x > THRESHOLD) after each chunk (every item is on time)."""
    from repro_torch.runtime.records import stamp_sharded
    from repro_torch.runtime.watermark import interval_of
    from repro_torch.stream import GaussianSource, StreamAggregator
    agg = StreamAggregator(GaussianSource(),
                           seed=seed + (3 if disorder else 2), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + (3 if disorder else 2))
    t_start = DISORDER_T0 if disorder else 0.0
    n_iv = int((t_start + CHUNKS * M / RATE) // SPAN) + 1
    acc = torch.zeros((3, n_iv, S), dtype=torch.float64, device=dev)
    chunks, exact = [], []
    for e in range(CHUNKS):
        c = agg.sharded_interval(e, W_SHARDS, M_SHARD)
        ch = stamp_sharded(c.values, c.stratum_ids,
                           t_start + e * M_SHARD / RATE_SHARD, RATE_SHARD)
        if disorder:
            shift = torch.where(
                torch.rand(ch.times.shape, generator=gen, device=dev)
                < SHIFT_P, torch.rand(ch.times.shape, generator=gen,
                                      device=dev) * SHIFT_MAX, 0.0)
            ch.times = torch.clamp(ch.times - shift, min=0.0)
        else:
            cell = (interval_of(ch.times, SPAN).long() * S
                    + ch.stratum_ids.long()).view(-1)
            v = ch.values.double().view(-1)
            acc[0].view(-1).index_add_(0, cell, torch.ones_like(v))
            acc[1].view(-1).index_add_(0, cell, v)
            acc[2].view(-1).index_add_(0, cell, (v > THRESHOLD).double())
            exact.append(acc.clone())
        chunks.append(ch)
    return chunks, exact


def sharded_cfg(**kw):
    from repro_torch.runtime.executor import RuntimeConfig
    base = dict(num_strata=S, capacity=N_MAX, num_intervals=K,
                interval_span=SPAN, allowed_lateness=LATENESS,
                emit_every=EMIT_EVERY, batch_chunks=EMIT_EVERY,
                num_shards=W_SHARDS)
    base.update(kw)
    return RuntimeConfig(**base)


def shard_leaves(d: dict, w=None) -> dict:
    """A state dict's leaves by path, shard ``w``'s row of each (all of
    it for ``w=None``), as bytes."""
    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}.{k}")
        else:
            out[path] = (x if w is None else x[w]).tobytes()
    walk(d, "")
    return out


#: Name prefixes of the hand-written kernels in a profiler trace.
OWN_KERNELS = ("fold_", "osi_", "stats_", "whist_")


def device_split(torch, fn, calls: int) -> tuple:
    """From one ``torch.profiler`` trace of ``fn`` (``calls`` units of
    work): device activities (kernels and memsets) and device ms per
    unit, each hand-written kernel's device ms per unit by name, and the
    host's torch ops per unit (``aten::`` calls not made inside another
    one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in events)
    own = {}
    for e in events:
        name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
        if name.startswith(OWN_KERNELS):
            own[name] = own.get(name, 0.0) + e.time_range.elapsed_us()
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU
            and e.name.startswith("aten::") and (
                e.cpu_parent is None
                or not e.cpu_parent.name.startswith("aten::"))]
    return (len(events) / calls, busy / calls / 1e3,
            {k: v / calls / 1e3 for k, v in sorted(own.items())},
            len(host) / calls)


def ingest_activities(torch, cfg, state, chunks) -> tuple:
    """:func:`device_split` of the ingest of ``chunks``, per chunk."""
    from repro_torch.runtime.executor import _ingest_chunk
    box = [state]

    def run():
        for ch in chunks:
            box[0] = _ingest_chunk(cfg, box[0], ch)
    return device_split(torch, run, len(chunks))


class HeldToPlain:
    """Inside ``with``, every call of the kernels' dispatch
    (``kernels/ops``) is held against its plain version in
    ``kernels/ref`` on clones of the same inputs, at the shapes its caller
    gives it: the fold's ring and counts and every tensor the one-shot
    carries bit for bit; the stats' and the histogram's counts bit for bit
    and their sums within STATS_RTOL of the plain version's sums. The
    wrapper runs once per call on the caller's tensors, so the launch
    counts stay the path's. ``calls`` counts the calls held per kernel
    and shape; a row entry's calls count as its kernel's at the flat
    view's shape."""
    NAMES = ("reservoir_fold", "one_shot_ingest", "stratified_stats",
             "weighted_histogram", "stratified_stats_rows",
             "weighted_histogram_rows")

    def __init__(self, torch, tag: str):
        self.torch, self.tag, self.calls = torch, tag, {}

    def __enter__(self):
        from repro_torch.kernels import ops
        self.real = {n: getattr(ops, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(ops, n, getattr(self, n))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for n, fn in self.real.items():
            setattr(ops, n, fn)
        return False

    def _held(self, name, shape, bad):
        if bad:
            fail(f"{self.tag}: {name} at {shape} differs from its plain "
                 f"version: {bad}")
        key = (name,) + shape
        self.calls[key] = self.calls.get(key, 0) + 1

    @staticmethod
    def _sums(kernel, plain) -> bool:
        return float(((kernel - plain).abs()
                      / plain.abs().clamp(min=1e-30)).max()) <= STATS_RTOL

    def reservoir_fold(self, stratum_ids, payload, u_accept, u_slot, mask,
                       counts, capacity, values):
        from repro_torch.kernels import ref
        plain = values.clone()
        want = ref.reservoir_fold(stratum_ids, payload, u_accept, u_slot,
                                  mask, counts.clone(), capacity, plain)
        out = self.real["reservoir_fold"](stratum_ids, payload, u_accept,
                                          u_slot, mask, counts, capacity,
                                          values)
        bad = [f for f, a, b in (("values", values, plain),
                                 ("counts", out, want))
               if not same_bits(self.torch, a, b)]
        self._held("reservoir_fold", (tuple(values.shape),
                                      stratum_ids.numel()), bad)
        return out

    def one_shot_ingest(self, *items, **state):
        from repro_torch.kernels import ref
        t = self.torch
        plain = {k: v.clone() if isinstance(v, t.Tensor) else v
                 for k, v in state.items()}
        ref.one_shot_ingest(*items, **plain)
        out = self.real["one_shot_ingest"](*items, **state)
        bad = [k for k, v in state.items() if isinstance(v, t.Tensor)
               and not same_bits(t, v, plain[k])]
        self._held("one_shot_ingest", (tuple(state["values"].shape),
                                       items[0].numel()), bad)
        return out

    def _stats(self, out, want, g, m):
        bad = [] if self.torch.equal(out[0], want[0]) else ["counts"]
        bad += [f for f, i in (("sums", 1), ("sumsqs", 2))
                if not self._sums(out[i], want[i])]
        self._held("stratified_stats", (g, m), bad)
        return out

    def _hist(self, out, want, g, nb, m):
        bad = [] if self.torch.equal(out[1], want[1]) else ["counts"]
        bad += [] if self._sums(out[0], want[0]) else ["mass"]
        self._held("weighted_hist", (g, nb, m), bad)
        return out

    def stratified_stats(self, values, stratum_ids, mask, num_strata):
        from repro_torch.kernels import ref
        out = self.real["stratified_stats"](values, stratum_ids, mask,
                                            num_strata)
        return self._stats(out, ref.stratified_stats(
            values, stratum_ids, mask, num_strata), num_strata,
            values.numel())

    def stratified_stats_rows(self, values, mask):
        from repro_torch.kernels import ref
        out = self.real["stratified_stats_rows"](values, mask)
        return self._stats(out, ref.stratified_stats_rows(values, mask),
                           values.shape[0], values.numel())

    def weighted_histogram(self, values, stratum_ids, weights, mask, edges,
                           num_strata):
        from repro_torch.kernels import ref
        out = self.real["weighted_histogram"](values, stratum_ids, weights,
                                              mask, edges, num_strata)
        return self._hist(out, ref.weighted_hist(
            values, stratum_ids, weights, mask, edges, num_strata),
            num_strata, edges.numel() - 1, values.numel())

    def weighted_histogram_rows(self, values, row_weights, mask, edges):
        from repro_torch.kernels import ref
        out = self.real["weighted_histogram_rows"](values, row_weights, mask,
                                                   edges)
        return self._hist(out, ref.weighted_hist_rows(
            values, row_weights, mask, edges), values.shape[0],
            edges.numel() - 1, values.numel())

    def require(self, key, n: int) -> None:
        """Fail unless ``n`` calls were held at ``key``
        (``(name,) + shape``)."""
        got = self.calls.get(key, 0)
        log(f"[sharded] {self.tag}: {got} {key[0]} calls at {key[1:]} held "
            "to the plain version")
        if got != n:
            fail(f"{self.tag}: {got} {key[0]} calls held at {key[1:]}, "
                 f"expected {n}; held {self.calls}")


def hist_registry():
    """The nonlinear queries that reach the histogram kernel."""
    from repro_torch.runtime.registry import QueryRegistry
    return (QueryRegistry()
            .register("q_hist", "quantile", qs=NL_QS, method="hist")
            .register("hist_log2", "histogram", edges=LOG2_EDGES))


def phase_sharded(torch, seed: int, dev) -> dict:
    """The paper's §5.1 deployment with its 4 workers on one card
    (``placement="vmap"``): answers, bitwise equivalences, launches,
    times and recovery at W = 4 (module docstring, phase 10)."""
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.obs import metrics as obm
    from repro_torch.runtime import convert
    from repro_torch.runtime.executor import (BatchedExecutor,
                                              PipelinedExecutor,
                                              _ingest_chunk, init_state)
    from repro_torch.runtime.records import TimestampedChunk
    key = prng.PRNGKey(seed)
    chunks, exact = make_sharded_stream(torch, seed, dev)
    cfg = sharded_cfg()
    items = CHUNKS * W_SHARDS * M_SHARD

    # (a) Pipelined fused on cadence with the linear registry.
    ex4 = PipelinedExecutor(cfg, linear_registry(), key, device=dev)
    ring = tuple(ex4.state.window.intervals.values.shape)
    log(f"[sharded] W = {W_SHARDS}: ring {list(ring)} f32 = "
        f"{ex4.state.window.intervals.values.numel() * 4} B, chunks "
        f"[{W_SHARDS}, {M_SHARD}] at {RATE_SHARD:g} items/s per shard")
    if ring != (W_SHARDS, K, S, N_SHARD):
        fail(f"sharded ring {ring}, expected {(W_SHARDS, K, S, N_SHARD)}")
    ex4.run(chunks[:EMIT_EVERY])           # warm-up
    ex4.reset(key)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with HeldToPlain(torch, "(a)") as held:
        ems = ex4.run(chunks)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    held.require(("stratified_stats", W_SHARDS * K * S,
                  W_SHARDS * K * S * N_SHARD), 2 * len(ems))
    if (launches["reservoir_fold"] != CHUNKS
            or launches["stratified_stats"] != 2 * len(ems)
            or len(ems) != CHUNKS // EMIT_EVERY):
        fail(f"sharded (a): {len(ems)} emissions, launches {launches}")
    for em in ems:
        check_answers("sharded (a)", em, live_intervals(em),
                      exact[(em.index + 1) * EMIT_EVERY - 1])
    c = obm.counters(ex4.state.metrics)
    ing, acc_, drop = (c[f].tolist() for f in ("ingested", "accepted",
                                               "dropped"))
    log(f"[sharded] (a) {len(ems)} emissions within 3 sigma; launches "
        f"{launches}; ingested {ing} accepted {acc_} dropped {drop}")
    if any(i != a + d for i, a, d in zip(ing, acc_, drop)) \
            or sum(ing) != items:
        fail(f"sharded (a): ingested {ing}, accepted {acc_}, dropped "
             f"{drop}, expected {items} in all")
    # The histogram kernel at W = 4: one emission of the nonlinear
    # queries that reach it, on the merged [W·K·S, N] view.
    exh = PipelinedExecutor(cfg, hist_registry(), key, device=dev)
    with HeldToPlain(torch, "(a) histogram") as held:
        em = exh.run(chunks[:EMIT_EVERY])
    torch.cuda.synchronize()
    g, n_view = W_SHARDS * K * S, W_SHARDS * K * S * N_SHARD
    held.require(("weighted_hist", g, REFINE_BINS, n_view),
                 len(NL_QS) * REFINE_STEPS)
    held.require(("weighted_hist", g, len(LOG2_EDGES) - 1, n_view), 1)
    answers = {f"{q}.{f}": a for q, r in convert.results_to_numpy(
        em[0].results).items() for f, a in r.items()} if em else {}
    if len(em) != 1 or not all(np.isfinite(a).all()
                               for a in answers.values()):
        fail(f"sharded (a) histogram: {len(em)} emissions, answers "
             f"{answers}")
    del exh

    # (b) The ingest alone: the W = 4 state is four W = 1 states, each fed
    # its shard's rows, its key split(key, 4)[w] and the per-shard
    # capacity; one fold launch per chunk.
    state = init_state(cfg, key, dev)
    ops.reset_launch_counts()
    with HeldToPlain(torch, "(b)") as held:
        for ch in chunks:
            state = _ingest_chunk(cfg, state, ch)
    torch.cuda.synchronize()
    folds = ops.launch_counts()["reservoir_fold"]
    held.require(("reservoir_fold", (W_SHARDS * K * S, N_SHARD),
                  W_SHARDS * M_SHARD), CHUNKS)
    four = convert.state_to_numpy(state)
    cfg1 = sharded_cfg(capacity=N_SHARD, num_shards=1)
    keys = prng.split(key, W_SHARDS)
    for w in range(W_SHARDS):
        one = init_state(cfg1, keys[w], dev)
        for ch in chunks:
            one = _ingest_chunk(cfg1, one, TimestampedChunk(
                ch.values[w], ch.stratum_ids[w], ch.times[w], ch.mask[w]))
        mine, want = shard_leaves(four, w), shard_leaves(
            convert.state_to_numpy(one))
        bad = [p for p in want if mine[p] != want[p]]
        if bad:
            fail(f"sharded (b): shard {w} differs from a W = 1 state: {bad}")
        del one
    log(f"[sharded] (b) ingest alone: the W = {W_SHARDS} state after "
        f"{CHUNKS} chunks is bit for bit {W_SHARDS} single-shard states; "
        f"{folds} reservoir_fold launches = {folds / CHUNKS:g} per chunk")
    if folds != CHUNKS:
        fail(f"sharded (b): {folds} fold launches for {CHUNKS} chunks")
    del state, four

    # (c) Every path on the disordered stream.
    dchunks, _ = make_sharded_stream(torch, seed, dev, disorder=True)
    paths = {
        "a": (PipelinedExecutor, "fused", "cadence"),
        "d": (PipelinedExecutor, "masked", "cadence"),
        "b": (PipelinedExecutor, "onekernel", "cadence"),
        "e": (PipelinedExecutor, "fused", "watermark"),
        "f": (BatchedExecutor, "onekernel", "watermark"),
    }
    runs = {}
    held = HeldToPlain(torch, "(c)")
    for tag, (cls, ingest, emission) in paths.items():
        ex = cls(sharded_cfg(ingest=ingest, emission=emission),
                 linear_registry(), key, device=dev)
        ops.reset_launch_counts()
        with held:
            out = ex.run(dchunks)
        torch.cuda.synchronize()
        n = ops.launch_counts()
        runs[tag] = dict(ems=[emission_bits(torch, em) for em in out],
                         state=state_bits(ex.state), launches=n)
        wm_ = ex.state.wm
        log(f"[sharded] (c) ({tag}) {cls.__name__} ingest={ingest} "
            f"emission={emission}: {len(out)} emissions; per chunk "
            f"{n['reservoir_fold'] / CHUNKS:g} fold, "
            f"{n['one_shot_ingest'] / CHUNKS:g} one-shot; "
            f"{n['stratified_stats'] / max(len(out), 1):g} stats per "
            f"emission; on time {int(wm_.on_time.sum())} late "
            f"{int(wm_.late.sum())} dropped {int(wm_.dropped.sum())}")
        want = {"fused": (CHUNKS, 0), "masked": (CHUNKS, 0),
                "onekernel": (0, CHUNKS)}[ingest]
        if (n["reservoir_fold"], n["one_shot_ingest"]) != want or \
                n["stratified_stats"] != 2 * len(out) or not out:
            fail(f"sharded (c) ({tag}): launches {n}, expected fold and "
                 f"one-shot {want} and 2 stats per emission (the window's "
                 "or the closed interval's, and count's)")
        del ex
    held.require(("reservoir_fold", (W_SHARDS * K * S, N_SHARD),
                  W_SHARDS * M_SHARD), 2 * CHUNKS)
    held.require(("reservoir_fold", (W_SHARDS, K, S, N_SHARD),
                  W_SHARDS * M_SHARD), CHUNKS)
    held.require(("one_shot_ingest", (W_SHARDS, K, S, N_SHARD),
                  W_SHARDS * M_SHARD), 2 * CHUNKS)
    onekernel = sum(r["launches"]["one_shot_ingest"] for r in runs.values())
    if not int(wm_.late.sum()) or not int(wm_.dropped.sum()):
        fail("sharded (c): the disordered stream has no late or dropped "
             "items")
    for tag in "db":
        if runs[tag]["ems"] != runs["a"]["ems"] or same_state(
                runs["a"]["state"], runs[tag]["state"]):
            fail(f"sharded (c): path ({tag}) differs from (a)")
    e_, f_ = runs["e"], runs["f"]
    if [x[1] for x in e_["ems"]] != list(range(len(e_["ems"]))) or \
            [(x[1], x[9]) for x in e_["ems"]] != \
            [(x[1], x[9]) for x in f_["ems"]] or \
            same_state(e_["state"], f_["state"]):
        fail("sharded (c): batched onekernel and pipelined fused differ "
             "on the watermark")
    log("[sharded] (c) (d) masked and (b) onekernel equal (a) fused bit "
        "for bit (emissions and state); (f) batched onekernel closes "
        f"(e) pipelined fused's intervals {[x[1] for x in e_['ems']]} "
        "with the same answers and state")
    del runs

    # (d) Items/s of W = 4 beside phase main's W = 1, in turns; device
    # activities per ingest chunk; one emission at W = 4.
    chunks1, _ = make_stream(torch, seed, dev)
    cfg_main = sharded_cfg(num_shards=1)
    ex1 = PipelinedExecutor(cfg_main, linear_registry(), key, device=dev)
    ex1.run(chunks1[:EMIT_EVERY])
    walls = {1: [], W_SHARDS: []}
    for _ in range(SHARDED_WINDOWS):
        for w, ex, stream in ((1, ex1, chunks1), (W_SHARDS, ex4, chunks)):
            ex.reset(key)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ex.run(stream)
            torch.cuda.synchronize()
            walls[w].append(time.perf_counter() - t0)
    rates, act, emit = {}, {}, {}
    for w, c_, stream, ex in ((1, cfg_main, chunks1, ex1),
                              (W_SHARDS, cfg, chunks, ex4)):
        r = sorted(items / x for x in walls[w])
        rates[w] = dict(median=r[len(r) // 2], min=r[0], max=r[-1], all=r)
        log(f"[sharded] (d) W = {w}: median {rates[w]['median']:.6g} "
            f"items/s over {len(r)} windows (min {r[0]:.6g}, max "
            f"{r[-1]:.6g}; all {[round(x) for x in r]})")
        for ingest in ("fused", "onekernel"):
            c_i = dataclasses.replace(c_, ingest=ingest)
            st = _ingest_chunk(c_i, init_state(c_i, key, dev), stream[0])
            act[f"{w}/{ingest}"] = a = ingest_activities(torch, c_i, st,
                                                         stream[1:9])
            log(f"[sharded] (d) W = {w} {ingest} ingest per chunk "
                f"(profiler, 8 chunks): {a[0]:.1f} device activities, "
                f"{a[3]:.1f} host torch ops, {a[1]:.4f} device ms; kernels "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in a[2].items()))
        # One emission: host clock over 5, then a profile of one.
        ex.reset(key)
        for ch in stream:
            ex.push(ch)
        torch.cuda.synchronize()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            ex._chunks_since_emit = 1
            ex._emit_now()
        ms = (time.perf_counter() - t0) / reps * 1e3

        def one_emission():
            ex._chunks_since_emit = 1
            ex._emit_now()
        emit[w] = (ms,) + device_split(torch, one_emission, 1)
        log(f"[sharded] (d) W = {w}: one emission {ms:.4f} ms (host "
            f"clock, {reps} emissions); profiled: {emit[w][1]:.0f} device "
            f"activities, {emit[w][4]:.0f} host torch ops, "
            f"{emit[w][2]:.4f} device ms; kernels "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in emit[w][3].items()))
    emit_ms = emit[W_SHARDS][0]
    del ex1, chunks1

    # (e) Recovery at W = 4, fused: killed after chunks 6 and 21.
    victim = PipelinedExecutor(cfg, linear_registry(), key, device=dev)
    recovery = PipelinedExecutor(cfg, linear_registry(),
                                 prng.PRNGKey(seed + 1000), device=dev)
    reference = [emission_bits(torch, em) for em in victim.run(chunks)]
    final = state_bits(victim.state)
    crashes = {}
    for k in SHARDED_CRASHES:
        out, ckpt, nbytes, restore_ms, replay_ms, _ = crash_and_recover(
            torch, victim, recovery, chunks, k, key)
        check_exactly_once(torch, f"sharded (e) crash after {k}", reference,
                           out, final, recovery.state)
        crashes[k] = dict(offset=ckpt.stream_offset, payload_bytes=nbytes,
                          restore_ms=restore_ms, replay_ms=replay_ms)
        log(f"[sharded] (e) killed after chunk {k}: restored offset "
            f"{ckpt.stream_offset} from {nbytes} B in {restore_ms:.4f} ms, "
            f"replay {replay_ms:.4f} ms; emissions and state bit for bit "
            "the uninterrupted run's")

    # (f) The mesh placement needs one card per shard.
    cards = torch.cuda.device_count()
    if cards < W_SHARDS:
        log(f"[sharded] mesh not run: torch.cuda.device_count() = {cards} "
            f"< {W_SHARDS}")
    else:
        log(f"[sharded] mesh not run: this script drives one card "
            f"(torch.cuda.device_count() = {cards})")
    result = dict(card=card(), rates={str(w): r for w, r in rates.items()},
                  ingest=act, emission={str(w): e for w, e in emit.items()},
                  emit_ms=emit_ms, crashes=crashes, launches=launches,
                  one_shot_launches=onekernel)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_sharded.json").write_text(
        json.dumps(result, indent=1))
    return result


# ---------------------------------------------------------------------------
# Phase rescale: restore-time elastic rescale, 1 -> 4 -> 1 shards.
# ---------------------------------------------------------------------------

def rescale_bounds() -> list:
    """``[(W, start, end)]`` of RESCALE_SEGMENTS, global chunk offsets."""
    out, start = [], 0
    for w, n in RESCALE_SEGMENTS:
        out.append((w, start, start + n))
        start += n
    return out


def rescale_exact(torch, streams, dev):
    """The script's own verdict on every item of the rescaled schedule
    (chunk ``e`` from ``streams[W]``, W the segment's width): each shard
    row routed by its own pre-chunk watermark, its open interval and ring
    eviction, the frontiers pooled to their minimum and the open intervals
    to their maximum at each rescale, as ``migrate`` pools them. Returns
    the exact float64 per-(interval, stratum) count, sum and
    count(x > THRESHOLD) over the accepted items after each chunk."""
    recip = float(np.float32(1.0) / np.float32(SPAN))
    n_iv = int((DISORDER_T0 + CHUNKS * M / RATE) // SPAN) + 1
    acc = torch.zeros((3, n_iv, S), dtype=torch.float64, device=dev)
    frontier = np.full(1, np.float32(-3.0e38), np.float32)
    open_iv = np.zeros(1, np.int64)
    exact = []
    for w, start, end in rescale_bounds():
        frontier = np.full(w, frontier.min(), np.float32)
        open_iv = np.full(w, open_iv.max(), np.int64)
        for e in range(start, end):
            ch = streams[w][e]
            t, sid, v, mask = (x.reshape(w, -1) for x in (
                ch.times, ch.stratum_ids, ch.values, ch.mask))
            for r in range(w):
                tgt = torch.floor(t[r] * recip).to(torch.int32)
                wmark = float(frontier[r] - np.float32(LATENESS))
                top = int(torch.where(mask[r], tgt, -1).max())
                new_open = max(int(open_iv[r]), top)
                ok = mask[r] & ~(t[r] < wmark) & (tgt >= new_open - K + 1)
                cell = (tgt.long() * S + sid[r].long())[ok]
                x = v[r][ok].double()
                acc[0].view(-1).index_add_(0, cell, torch.ones_like(x))
                acc[1].view(-1).index_add_(0, cell, x)
                acc[2].view(-1).index_add_(0, cell, (x > THRESHOLD).double())
                frontier[r] = max(frontier[r], np.float32(float(
                    torch.where(mask[r], t[r], -3.0e38).max())))
                open_iv[r] = new_open
            exact.append(acc.clone())
    return exact


def rescale_invariants(tag, before, after, n_max) -> dict:
    """A migrate's invariants on host states: Σ counts per (slot, stratum)
    cell, ``taken <= capacity <= N_max``, Σ of the watermark counters and
    of the device counters, and the occupancy gauge recomputed."""
    def rows(a, tail):
        return np.asarray(a).reshape((-1,) + tail)
    bi, ai = before.window.intervals, after.window.intervals
    cb, ca = rows(bi.counts, (K, S)), rows(ai.counts, (K, S))
    cap = rows(ai.capacity, (K, S))
    taken = np.minimum(ca, cap)
    bad = []
    if not (cb.astype(np.int64).sum(0) == ca.astype(np.int64).sum(0)).all():
        bad.append("counts per cell")
    if not ((taken <= cap).all() and (cap <= n_max).all()):
        bad.append("taken <= capacity <= N_max")
    for part in ("wm", "metrics"):
        for f in dataclasses.fields(getattr(before, part)):
            if part == "metrics" and f.name == "occupancy":
                continue
            x, y = (np.asarray(getattr(getattr(s, part), f.name))
                    for s in (before, after))
            if x.astype(np.int64).sum() != y.astype(np.int64).sum() \
                    and f.name != "max_time":
                bad.append(f"sum of {part}.{f.name}")
    if not (rows(after.metrics.occupancy, (S,)) == taken.sum(1)).all():
        bad.append("occupancy")
    if bad:
        fail(f"{tag}: migrate broke {bad}")
    return dict(cells=cb.astype(np.int64).sum(0).tolist(),
                taken=taken.sum(axis=(0, 1)).tolist())


class Rescaler:
    """The rescaled schedule on one path: ``executors[W]`` (warm, one per
    width), ``streams[W][e]`` the chunk at global offset ``e``. At each
    boundary the batched executor flushes its partial micro-batch, the
    executor is captured, the checkpoint migrated to the next width's
    shard count and slot width, serialized, deserialized and restored into
    the next width's executor; the figures of every boundary are kept."""

    def __init__(self, torch, tag, executors, streams):
        self.torch, self.tag = torch, tag
        self.executors, self.streams = executors, streams
        self.boundaries = []

    def _sync(self):
        self.torch.cuda.synchronize()

    def start(self, seg, payload, key, every):
        from repro_torch.runtime import Checkpointer
        from repro_torch.runtime import checkpoint as ckp
        ex = self.executors[rescale_bounds()[seg][0]]
        ex.checkpointer = None
        fig = {}
        if payload is None:
            ex.reset(key)
        else:
            self._sync()
            t0 = time.perf_counter()
            ckpt = ckp.from_bytes(payload, ex.payload_template())
            t1 = time.perf_counter()
            ex.restore(ckpt)                 # waits for the copies
            fig = dict(from_bytes_ms=(t1 - t0) * 1e3,
                       restore_ms=(time.perf_counter() - t1) * 1e3)
        if every is not None:
            ex.checkpointer = Checkpointer(every_chunks=every)
            ex.checkpointer.save(ex)
        return ex, fig

    def boundary(self, ex, seg):
        """Capture, migrate and serialize at the end of segment ``seg``;
        returns the payload and its figures."""
        from repro_torch.runtime import checkpoint as ckp
        nxt = self.executors[rescale_bounds()[seg + 1][0]]
        if ex.mode == "batched" and ex._pending:
            ex._flush()
        self._sync()
        t0 = time.perf_counter()
        snap = ex.snapshot()
        t1 = time.perf_counter()
        n_max = nxt.state.window.intervals.values.shape[-1]
        mig = ckp.migrate(snap, nxt.cfg.num_shards, new_max_capacity=n_max)
        t2 = time.perf_counter()
        payload = ckp.to_bytes(mig)
        t3 = time.perf_counter()
        inv = rescale_invariants(f"rescale ({self.tag}) boundary {seg}",
                                 snap.state, mig.state, n_max)
        return payload, dict(capture_ms=(t1 - t0) * 1e3,
                             migrate_ms=(t2 - t1) * 1e3,
                             to_bytes_ms=(t3 - t2) * 1e3,
                             payload_bytes=len(payload), **inv)

    def drive(self, seg, ex, offset, every=None, watch=None, walls=None):
        """Push from global ``offset`` (in segment ``seg``) to the end,
        rescaling at each boundary. Returns the emissions and the last
        executor; ``walls`` gets each segment's wall seconds."""
        bounds = rescale_bounds()
        ems = []
        for i in range(seg, len(bounds)):
            w, _, end = bounds[i]
            self._sync()
            t0 = time.perf_counter()
            n = end - offset
            while offset < end:
                ex.push(self.streams[w][offset])
                offset += 1
                if watch is not None:
                    watch(offset, ems + list(ex.emissions), ex)
            if i == len(bounds) - 1:
                ems += ex.finalize()
            self._sync()
            if walls is not None:
                walls.append((w, n, time.perf_counter() - t0))
            if i == len(bounds) - 1:
                return ems, ex
            ems += list(ex.emissions)
            payload, fig = self.boundary(ex, i)
            ex.checkpointer = None
            ex, fig2 = self.start(i + 1, payload, None, every)
            self.boundaries.append(dict(fig, **fig2))
        raise RuntimeError("empty schedule")

    def run(self, key, every=None, watch=None, walls=None):
        ex, _ = self.start(0, None, key, every)
        if watch is not None:
            watch(0, [], ex)
        return self.drive(0, ex, 0, every, watch, walls)

    def resume(self, payload, kill):
        """Recover from ``payload`` after a kill after chunk ``kill``:
        replay at the payload's own width, re-perform every remaining
        rescale. Returns the emissions, the last executor, the restore ms,
        the chunks replayed until the state holds chunk ``kill`` again
        (the batched executor's next flush at or after it) and the ms per
        replayed chunk."""
        from repro_torch.runtime import checkpoint as ckp
        head = ckp.peek(payload)
        w_ck, off = int(head["config"]["num_shards"]), head["stream_offset"]
        bounds = rescale_bounds()
        cands = [i for i, (w, s, e) in enumerate(bounds)
                 if w == w_ck and s <= off <= e]
        live = [i for i in cands if off < bounds[i][2]]
        seg = live[0] if live else cands[0]
        t0 = time.perf_counter()
        ex, fig = self.start(seg, payload, None, None)
        t1 = time.perf_counter()
        replay = dict(chunks=0, ms=0.0)
        if off >= kill:
            replay["done"] = True

        def watch(_o, _ems, now):
            held = ckp.incorporated_offset(now)
            if held >= kill and "done" not in replay:
                self._sync()
                replay.update(done=True, chunks=held - off,
                              ms=(time.perf_counter() - t1) * 1e3)
        ems, last = self.drive(seg, ex, off, watch=watch)
        per_chunk = replay["ms"] / max(replay["chunks"], 1)
        return (ems, last, (t1 - t0) * 1e3, replay["chunks"], per_chunk,
                off)


def phase_rescale(torch, seed: int, dev) -> dict:
    """Restore-time elastic rescale at full width: 1 -> 4 -> 1 shards with
    ``checkpoint.migrate`` at each boundary, on two paths, answers within
    3 sigma, invariants at both boundaries, killed around both and
    recovered bit for bit (module docstring, phase 11)."""
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.runtime import checkpoint as ckp
    from repro_torch.runtime.executor import (BatchedExecutor,
                                              PipelinedExecutor)
    where = card()
    key, other = prng.PRNGKey(seed), prng.PRNGKey(seed + 1000)
    paths = {
        "a": (PipelinedExecutor, "fused", "cadence",
              {1: make_stream(torch, seed, dev)[0],
               W_SHARDS: make_sharded_stream(torch, seed, dev)[0]}),
        "b": (BatchedExecutor, "onekernel", "watermark",
              {1: make_disordered_stream(torch, seed, dev)[0],
               W_SHARDS: make_sharded_stream(torch, seed, dev,
                                             disorder=True)[0]}),
    }
    result = dict(card=where, segments=RESCALE_SEGMENTS,
                  every_chunks=RESCALE_EVERY, paths={})
    for tag, (cls, ingest, emission, streams) in paths.items():
        execs = {w: cls(sharded_cfg(num_shards=w, ingest=ingest,
                                    emission=emission),
                        linear_registry(), key, device=dev)
                 for w in (1, W_SHARDS)}
        rings = {w: list(ex.state.window.intervals.values.shape)
                 for w, ex in execs.items()}
        log(f"[rescale] ({tag}) {cls.__name__} ingest={ingest} emission="
            f"{emission}: segments {RESCALE_SEGMENTS}, rings {rings} f32")
        exact = rescale_exact(torch, streams, dev)

        # Timed runs, no kernel held: items/s per segment and the
        # boundaries' parts.
        res = Rescaler(torch, tag, execs, streams)
        res.run(key)                       # warm-up
        res.boundaries, seg_rates = [], []
        for _ in range(RESCALE_TIMED):
            walls = []
            res.run(key, walls=walls)
            seg_rates.append([n * M / s for _, n, s in walls])
        timed = res.boundaries

        # The uninterrupted schedule, every kernel call held.
        res.boundaries = []
        held = HeldToPlain(torch, f"rescale ({tag})")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with held:
            ems, last = res.run(key)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        kernel = "one_shot_ingest" if ingest == "onekernel" else \
            "reservoir_fold"
        if launches[kernel] == 0 or launches["stratified_stats"] == 0:
            fail(f"rescale ({tag}): the schedule did not run {kernel} and "
                 f"stratified_stats: {launches}")
        # One fold (fused) or one batched one-shot call per chunk, at
        # W = 1 and at W = 4 alike.
        chunks = sum(n for _, n in RESCALE_SEGMENTS)
        if launches[kernel] != chunks:
            fail(f"rescale ({tag}): {launches[kernel]} {kernel} launches "
                 f"for {chunks} chunks, not one per chunk")
        reference = [emission_bits(torch, em) for em in ems]
        final = state_bits(last.state)
        if not ems:
            fail(f"rescale ({tag}): no emission")
        for em in ems:
            if emission == "cadence":
                check_answers(f"rescale ({tag})", em, live_intervals(em),
                              exact[(em.index + 1) * EMIT_EVERY - 1])
            else:
                check_answers(f"rescale ({tag})", em, [em.interval],
                              exact[-1])
        inv = [{k: b[k] for k in ("cells", "taken")}
               for b in res.boundaries]
        log(f"[rescale] ({tag}) {len(ems)} emissions within 3 sigma; "
            f"launches {launches}; kernel calls held to the plain version "
            f"{ {' '.join(map(str, k)): v for k, v in held.calls.items()} }"
            f"; invariants held at both boundaries (Σ counts per cell, "
            f"Σ taken per stratum after) {inv}")

        # Killed around both boundaries: one checkpointed run gives the
        # payload each kill leaves (the run is deterministic). Each
        # recovery runs twice: with every kernel call held, then unheld
        # for its times.
        survivors = {}

        def watch(offset, so_far, ex):
            survivors[offset] = (ex.checkpointer.latest, list(so_far))
        kills = {}
        with held:
            res.run(key, every=RESCALE_EVERY, watch=watch)
        for k in RESCALE_CRASHES:
            payload, pre = survivors[k]
            head = ckp.peek(payload)
            done = int(head["emissions_done"])
            for ctx in (held, contextlib.nullcontext()):
                with ctx:
                    rec, last, restore_ms, n_replay, replay_ms, off = \
                        res.resume(payload, k)
                out = pre[:done] + rec
                check_exactly_once(torch, f"rescale ({tag}) kill after {k}",
                                   reference, out, final, last.state)
            w_ck = head["config"]["num_shards"]
            kills[k] = dict(offset=off, width=w_ck,
                            payload_bytes=len(payload),
                            restore_ms=restore_ms,
                            replayed_chunks=n_replay,
                            replay_ms_per_chunk=replay_ms)
            log(f"[rescale] ({tag}) killed after chunk {k}: payload at "
                f"offset {off}, W = {w_ck} ({len(payload)} B), restore "
                f"{restore_ms:.4f} ms, {n_replay} chunks replayed until "
                f"the state held chunk {k} again, {replay_ms:.4f} ms per "
                f"chunk (unheld); {len(out)} emissions and the final state "
                "bit for bit the uninterrupted schedule's, held and unheld")

        for i, b in enumerate(timed):
            w0, w1 = (RESCALE_SEGMENTS[i % 2][0],
                      RESCALE_SEGMENTS[i % 2 + 1][0])
            log(f"[rescale] ({tag}) on {where}: boundary {w0} -> {w1} "
                f"(timed run {i // 2}): payload {b['payload_bytes']} B, "
                f"capture {b['capture_ms']:.4f} ms, migrate "
                f"{b['migrate_ms']:.4f} ms, to_bytes {b['to_bytes_ms']:.4f} "
                f"ms, from_bytes {b['from_bytes_ms']:.4f} ms, restore "
                f"{b['restore_ms']:.4f} ms")
        for j, r in enumerate(seg_rates):
            log(f"[rescale] ({tag}) on {where}: items/s per segment (timed "
                f"run {j}, W = {[w for w, _ in RESCALE_SEGMENTS]}): "
                f"{[round(x) for x in r]}")
        result["paths"][tag] = dict(
            executor=cls.__name__, ingest=ingest, emission=emission,
            boundaries=timed, segment_items_per_s=seg_rates, kills=kills,
            launches=launches, emissions=len(ems),
            held={" ".join(map(str, k)): v for k, v in held.calls.items()})
        del execs, res, last

    cards = torch.cuda.device_count()
    log(f"[rescale] mesh not run: torch.cuda.device_count() = {cards}"
        + (f" < {W_SHARDS}" if cards < W_SHARDS else
           " (this script drives one card)"))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_rescale.json").write_text(
        json.dumps(result, indent=1))
    return result


def five_systems(dev, num_strata: int, fraction: float, items: int,
                 lane: int = 256, seed: int = 0) -> dict:
    """The five systems of the paper's §5 comparison, built from the
    port's modules as ``benchmarks/systems.py`` builds them from the
    reference's: ``name -> run(values, stratum_ids) -> Estimate`` of the
    window's SUM.

    native          exact stats over every item (no sampling);
    oasrs_batched   StreamApprox, Spark-Streaming mode: one fold of the
                    window into a reset reservoir;
    oasrs_pipelined StreamApprox, Flink mode: one fold per ``lane`` items;
    srs             Spark ``sample`` (random sort with (p, q) pruning);
    sts             Spark ``sampleByKeyExact`` (count, then sort within
                    each stratum).
    """
    from repro_torch import prng
    from repro_torch.core import baselines as bl
    from repro_torch.core import error as err
    from repro_torch.core import oasrs, query
    cap = max(int(fraction * items / num_strata), 4)
    key = prng.PRNGKey(seed, device=dev)
    state0 = oasrs.init(num_strata, cap, key, device=dev)
    k = max(int(fraction * items), 4)

    def native(values, sids):
        return err.estimate_sum(query.exact_stats(values, sids, num_strata))

    def oasrs_batched(values, sids):
        st = oasrs.update_chunk(oasrs.reset_window(state0), sids, values)
        return query.query_sum(st)

    def oasrs_pipelined(values, sids):
        st = oasrs.update_pipelined_chunks(oasrs.reset_window(state0), sids,
                                           values, lane=lane)
        return query.query_sum(st)

    def srs(values, sids):
        return err.estimate_sum(bl.srs_stats(values,
                                             bl.srs_sample(key, items, k)))

    def sts(values, sids):
        gc = bl.sts_counts(sids, num_strata)           # pass 1 (the sync)
        sample = bl.sts_sample(key, sids, gc, fraction)
        return err.estimate_sum(bl.sample_stats(values, sids, sample,
                                                num_strata, gc))

    return {"native": native, "oasrs_batched": oasrs_batched,
            "oasrs_pipelined": oasrs_pipelined, "srs": srs, "sts": sts}


def system_gate(tag, name, est, exact, target=None) -> dict:
    """Log one system's answer against the f64 sum; fail unless native is
    within ANSWER_RTOL of it and a sampled system within 3 sigma (plus
    ANSWER_RTOL) of ``target`` (the f64 sum unless given)."""
    v, var = float(est.value), float(est.variance)
    sigma = max(var, 0.0) ** 0.5
    want = exact if target is None else target
    err_ = abs(v - want)
    bound = (0.0 if name == "native" else 3 * sigma) + ANSWER_RTOL * abs(
        want)
    ok = err_ <= bound
    loss = abs(v - exact) / abs(exact)
    log(f"[systems] ({tag}) {name}: {v:.9g} exact {exact:.9g} "
        f"accuracy loss {loss:.3e} sigma {sigma:.4g}"
        + ("" if target is None else f" target {target:.9g}")
        + f" {'ok' if ok else 'OUTSIDE its bound'}")
    if not ok:
        fail(f"systems ({tag}) {name}: {v} is {err_:.4g} from {want}, "
             f"bound {bound:.4g}")
    return dict(value=v, sigma=sigma, accuracy_loss=loss,
                gate="native rtol" if name == "native" else "3 sigma")


def run_systems(torch, tag, systems, values, sids, exact, lane,
                srs_target=None) -> dict:
    """(1) One untimed window of each system with every kernel call held
    to its plain version (``HeldToPlain``), its launches of the fold and
    the stats kernel counted and checked, and its answer gated; (2)
    ``SYS_RUNS`` timed windows of each, in turns, by the port's §6.1
    method (``replay.measure_window_program``: the clock stops after the
    card has finished)."""
    from repro_torch.kernels import ops
    from repro_torch.stream import replay
    items = values.numel()
    expect = {"native": (0, 1), "oasrs_batched": (1, 1),
              "oasrs_pipelined": (items // lane, 1), "srs": (0, 1),
              "sts": (0, 1)}
    out, totals = {}, {"reservoir_fold": 0, "stratified_stats": 0}
    for name in SYSTEMS:
        ops.reset_launch_counts()
        with HeldToPlain(torch, f"systems-{tag}-{name}") as held:
            est = systems[name](values, sids)
            torch.cuda.synchronize()
        counts = ops.launch_counts()
        got = (counts["reservoir_fold"], counts["stratified_stats"])
        held_n = sum(held.calls.values())
        log(f"[systems] ({tag}) {name}: fold {got[0]}, stats {got[1]} "
            f"launches per window; {held_n} kernel calls held to the "
            f"plain version ({', '.join(f'{k[0]} {k[1:]} x{n}' for k, n in held.calls.items())})")
        if got != expect[name] or held_n != sum(got):
            fail(f"systems ({tag}) {name}: launches {got}, expected "
                 f"{expect[name]}; held {held.calls}")
        for k in totals:
            totals[k] += counts[k]
        out[name] = system_gate(tag, name, est, exact,
                                srs_target if name == "srs" else None)
        out[name].update(fold_launches=got[0], stats_launches=got[1])
    rates = {name: [] for name in SYSTEMS}
    for _ in range(SYS_RUNS):
        for name in SYSTEMS:
            res = replay.measure_window_program(
                lambda e, fn=systems[name]: fn(values, sids), items,
                warmup=0, windows=1)
            rates[name].append(res.items_per_sec)
    for name in SYSTEMS:
        r = sorted(rates[name])
        out[name].update(items_per_s=r, items_per_s_median=r[len(r) // 2],
                         ms_median=items / r[len(r) // 2] * 1e3)
        log(f"[systems] ({tag}) {name}: items/s median {r[len(r) // 2]:.6g} "
            f"(min {r[0]:.6g}, max {r[-1]:.6g}) over {SYS_RUNS} windows of "
            f"{items} items, in turns")
    return dict(systems=out, launches=totals)


def phase_systems(torch, seed: int, dev) -> dict:
    """The paper's five-system comparison (§5) on the card, the stream
    substrate and the per-item path (module docstring, phase 12)."""
    from repro_torch import prng
    from repro_torch.core import baselines as bl
    from repro_torch.core import oasrs
    from repro_torch.kernels import ops
    from repro_torch.runtime.executor import PipelinedExecutor, RuntimeConfig
    from repro_torch.stream import (GaussianSource, MeteredStream,
                                    ReplayableStream, StreamAggregator,
                                    skewed)
    t_phase = time.perf_counter()
    result = {"card": card()}
    launches = {"reservoir_fold": 0, "stratified_stats": 0}

    # (a) fig7b's window at the reference's own width.
    a = SYS_A
    agg_a = StreamAggregator(
        skewed(GaussianSource(mus=(100.0, 1000.0, 10000.0),
                              sigmas=(10.0, 100.0, 1000.0)),
               (0.8, 0.19, 0.01)), seed=a["seed"], device=dev)
    win = agg_a.interval_chunk(0, a["items"])
    exact_a = float(win.values.double().sum())
    sys_a = five_systems(dev, S, a["fraction"], a["items"], lane=a["lane"])
    ra = run_systems(torch, "a", sys_a, win.values, win.stratum_ids,
                     exact_a, a["lane"])
    key = prng.PRNGKey(0, device=dev)
    k = max(int(a["fraction"] * a["items"]), 4)
    n_srs = int(bl.srs_sample(key, a["items"], k).mask.sum())
    gc = bl.sts_counts(win.stratum_ids, S)
    sts = bl.sts_sample(key, win.stratum_ids, gc, a["fraction"])
    per = torch.bincount(win.stratum_ids[sts.mask].long(), minlength=S)
    want = torch.ceil(float(np.float32(a["fraction"])) * gc.float()).long()
    log(f"[systems] (a) srs selected {n_srs} of k = {k}; sts per stratum "
        f"{per.tolist()} of ceil(0.4 C_i) = {want.tolist()}")
    if n_srs != k or not torch.equal(per, want):
        fail("systems (a): SRS or STS did not select its exact sample size")
    result["a"] = dict(ra["systems"], items=a["items"], exact=exact_a,
                       fraction=a["fraction"], lane=a["lane"])
    for kk in launches:
        launches[kk] += ra["launches"][kk]

    result["seconds_a"] = time.perf_counter() - t_phase
    # (b) one 10 s window of the §5.1 stream at full width.
    b = SYS_B
    agg_b = StreamAggregator(GaussianSource(), seed=seed, device=dev)
    stream_b = ReplayableStream(agg_b, M, RATE)
    chunks = stream_b.prefix(b["chunks"])
    values = torch.cat([c.values for c in chunks])
    sids = torch.cat([c.stratum_ids for c in chunks])
    del chunks
    items = values.numel()
    exact_b = float(values.double().sum())
    sys_b = five_systems(dev, S, b["fraction"], items, lane=b["lane"])
    k_b = max(int(b["fraction"] * items), 4)
    srs_b = bl.srs_stats(values, bl.srs_sample(key, items, k_b))
    c_est = int(srs_b.counts[0])
    log(f"[systems] (b) SRS count estimate {c_est} of {items} items "
        f"(the reference's f32 running sum of the HT weights, "
        f"{c_est / items - 1:+.4e}); SRS is held to 3 sigma around "
        f"exact * {c_est} / {items}")
    rb = run_systems(torch, "b", sys_b, values, sids, exact_b, b["lane"],
                     srs_target=exact_b * c_est / items)
    for kk in launches:
        launches[kk] += rb["launches"][kk]
    for name in SYSTEMS:
        fn = sys_b[name]

        # Three windows per trace. The pipelined system's window is tens
        # of thousands of host ops, whose trace alone takes tens of
        # seconds: it is traced on its first tenth (16 of 160 lanes) and
        # counted as a tenth of a window.
        n_tr, part = (0.1, b["chunks"] * M // 10) if \
            name == "oasrs_pipelined" else (3, items)

        def windows(fn=fn, n_tr=n_tr, part=part):
            for _ in range(max(int(n_tr), 1)):
                fn(values[:part], sids[:part])
        for _ in range(PROFILE_TRIES):
            acts, busy_ms, own, host_ops = device_split(torch, windows,
                                                        n_tr)
            traced = any(k.startswith("stats_") for k in own)
            if traced:
                break
            log(f"[systems] (b) {name}: the trace holds no stats kernel "
                f"({acts:.1f} device activities per window); profiling "
                "again")
        wall = rb["systems"][name]["ms_median"]
        rb["systems"][name].update(
            device_activities=acts, device_busy_ms=busy_ms,
            device_busy_share=busy_ms / wall, own_kernel_ms=own,
            host_torch_ops=host_ops, stats_kernel_traced=traced)
        log(f"[systems] (b) {name}: {acts:.1f} device activities, "
            f"{busy_ms:.4f} device ms busy of {wall:.4f} ms median wall "
            f"(share {busy_ms / wall:.3f}); own kernels {own}; "
            f"{host_ops:.0f} host torch ops per window ({n_tr:g} traced)"
            + ("" if traced else "; the tracer recorded no stats kernel, "
               "so the busy share misses it"))
    med = {n: rb["systems"][n]["items_per_s_median"] for n in SYSTEMS}
    ratios = {f"{o}/{x}": med[o] / med[x] for o in ("oasrs_batched",
                                                   "oasrs_pipelined")
              for x in ("native", "srs", "sts")}
    log(f"[systems] (b) items/s ratios (median over median): "
        + ", ".join(f"{k_} {v:.4g}" for k_, v in ratios.items()))
    result["b"] = dict(rb["systems"], items=items, exact=exact_b,
                       fraction=b["fraction"], lane=b["lane"],
                       srs_count_estimate=c_est, ratios=ratios)
    del values, sids

    result["seconds_b"] = time.perf_counter() - t_phase
    # (c) the substrate: replay bits, cost per chunk, metering.
    again = stream_b.chunk_at(7)
    first = stream_b.chunk_at(7)
    if not all(same_bits(torch, getattr(first, f), getattr(again, f))
               for f in ("values", "stratum_ids", "times", "mask")):
        fail("systems (c): chunk_at(7) made twice differs")
    stream_c = ReplayableStream(agg_b, M, RATE, disorder=SHIFT_MAX,
                                disorder_seed=seed + 5,
                                key_gaps=((1, 2.0, 1.0),))
    full = stream_c.prefix(SYS_REPLAY)
    for i, c in enumerate(stream_c.range(7, SYS_REPLAY)):
        if not all(same_bits(torch, getattr(c, f),
                             getattr(full[7 + i], f))
                   for f in ("values", "stratum_ids", "times", "mask")):
            fail(f"systems (c): range(7, {SYS_REPLAY}) differs from "
                 f"prefix({SYS_REPLAY})[7:] at chunk {7 + i}")
    exact_items = int(sum(int(c.mask.sum()) for c in full))
    lo = min(float(c.times[c.mask].min()) for c in full)
    hi = max(float(c.times[c.mask].max()) for c in full)
    del full
    gen_ms = {}
    for tag, st in (("plain", stream_b), ("disorder+gap", stream_c)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e in range(8):
            st.chunk_at(e)
        torch.cuda.synchronize()
        gen_ms[tag] = (time.perf_counter() - t0) / 8 * 1e3
    log(f"[systems] (c) chunk_at bitwise twice; range(7, {SYS_REPLAY}) == "
        f"prefix({SYS_REPLAY})[7:] with disorder and a key gap; ms per "
        f"generated chunk of {M} items: "
        + ", ".join(f"{k_} {v:.4f}" for k_, v in gen_ms.items()))
    cfg = RuntimeConfig(num_strata=S, capacity=N_MAX, num_intervals=K,
                        interval_span=SPAN, allowed_lateness=LATENESS,
                        emit_every=EMIT_EVERY)
    ex = PipelinedExecutor(cfg, linear_registry(), prng.PRNGKey(seed,
                                                                device=dev),
                           device=dev)
    metered = MeteredStream(stream_c.range(0, SYS_REPLAY))
    it = iter(metered)
    for _ in range(SYS_REPLAY):
        torch.cuda.set_sync_debug_mode("error")
        try:
            c = next(it)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ex.push(c)
    ex.finalize()
    summary = metered.summary()
    want_summary = {"chunks": SYS_REPLAY, "items": exact_items,
                    "event_span": hi - lo}
    log(f"[systems] (c) MeteredStream over a {SYS_REPLAY}-chunk pipelined "
        f"run: {summary}, exact {want_summary}; no device-to-host read "
        f"while metering (CUDA sync debug mode 'error')")
    if summary != want_summary:
        fail(f"systems (c): metered {summary} != exact {want_summary}")
    result["c"] = dict(generate_ms_per_chunk=gen_ms, metered=summary)

    result["seconds_c"] = time.perf_counter() - t_phase
    # (d) the per-item path, card against CPU.
    first = stream_b.chunk_at(0)
    sid_d = first.stratum_ids[:SYS_ITEMS_D]
    pay_d = first.values[:SYS_ITEMS_D]
    states = {}
    for where in ("cpu", dev):
        st = oasrs.init(S, 64, prng.PRNGKey(seed, device=where),
                        device=where)
        ids, pay = sid_d.to(where), pay_d.to(where)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # On the card, any read back to the host inside the loop raises.
        torch.cuda.set_sync_debug_mode("error" if where == dev else 0)
        try:
            st = oasrs.update_stream(st, ids, pay)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        states[str(where)] = (st, (time.perf_counter() - t0) * 1e3)
    (cpu_st, cpu_ms), (gpu_st, gpu_ms) = states["cpu"], states[str(dev)]
    bad = [f for f in ("values", "counts", "key")
           if not torch.equal(getattr(cpu_st, f), getattr(gpu_st, f).cpu())]
    log(f"[systems] (d) update_stream of {SYS_ITEMS_D} items: card state "
        f"{'bit for bit the CPU state' if not bad else f'DIFFERS in {bad}'}"
        f"; {gpu_ms:.1f} ms on the card (no read back to the host), "
        f"{cpu_ms:.1f} ms on the CPU")
    if bad:
        fail(f"systems (d): update_stream on the card differs in {bad}")
    result["d"] = dict(items=SYS_ITEMS_D, card_ms=gpu_ms, cpu_ms=cpu_ms)

    result["launches"] = launches
    result["seconds"] = time.perf_counter() - t_phase
    log(f"[systems] phase took {result['seconds']:.1f} s ((a) ended at "
        f"{result['seconds_a']:.1f} s, (b) at {result['seconds_b']:.1f}, "
        f"(c) at {result['seconds_c']:.1f})")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_systems.json").write_text(
        json.dumps(result, indent=1))
    return result

# ---------------------------------------------------------------------------
# Phase serve: phi4-mini-3.8b at full width with StreamApprox telemetry.
# ---------------------------------------------------------------------------

def main_config():
    """Phase main's deployment: its runtime config and registry."""
    from repro_torch.runtime.executor import RuntimeConfig
    from repro_torch.runtime.registry import QueryRegistry
    cfg = RuntimeConfig(num_strata=S, capacity=N_MAX, num_intervals=K,
                        interval_span=SPAN, allowed_lateness=LATENESS,
                        emit_every=EMIT_EVERY)
    reg = (QueryRegistry().register("sum", "sum").register("mean", "mean")
           .register("count", "count", predicate=lambda x: x > THRESHOLD))
    return cfg, reg


EXPERT_LEAVES = tuple(f"moe_layers.moe.{w}" for w in ("w_in", "w_gate",
                                                      "w_out"))
LAYER_PREFIXES = ("dense_layers", "moe_layers", "blocks", "encoder",
                  "decoder")
# Of encdec's weights, those that take the encoder's frames (the rest take
# the decoder's tokens): a decode step reads none of them.
FRAME_LEAVES = ("encoder.", "enc_final_ln.", "decoder.cross_attn.wk",
                "decoder.cross_attn.wv")


def attention_layers(cfg) -> int:
    """Layers (or blocks) that attend: every layer of dense and moe, the
    ``attn`` blocks of hybrid, none of ssm."""
    from repro_torch.models import rglru
    if cfg.family == "hybrid":
        return sum(rglru.block_kind(cfg, i) == "attn"
                   for i in range(cfg.num_layers))
    return 0 if cfg.family == "ssm" else cfg.num_layers


def full_pairs(cfg, sq: int, skv: int) -> int:
    """Query × key elements of the blocks the chunked attention computes
    with ``causal=False`` over ``sq`` queries and ``skv`` keys (padded to
    whole blocks)."""
    qc, ck = min(cfg.attn_q_chunk, sq), min(cfg.attn_kv_chunk, skv)
    return -(-sq // qc) * qc * -(-skv // ck) * ck


def attention_pairs(cfg, seq: int) -> int:
    """Query × key elements of the blocks the chunked attention computes
    for one head and row over ``seq`` tokens from position 0 (the local
    window's block range for hybrid)."""
    qc, ck = min(cfg.attn_q_chunk, seq), min(cfg.attn_kv_chunk, seq)
    w = cfg.local_window if cfg.family == "hybrid" else None
    pairs = 0
    for i in range(-(-seq // qc)):
        start = max(0, (i * qc - w + 1) // ck) if w else 0
        stop = min(-(-seq // ck), -(-((i + 1) * qc) // ck))
        pairs += (stop - start) * qc * ck
    return pairs


def model_work(cfg, params, batch: int, seq: int, frames: int = 0) -> dict:
    """Operations of one forward over ``batch`` rows of ``seq`` tokens
    (for vlm, patches and text; for encdec, the decoder's tokens, the
    encoder taking ``frames``), from the run's shapes: two per weight
    element a token touches (of the experts, the ``k`` of ``E`` routed;
    the embedding table only gathered), the attention blocks' scores and
    P·V (encdec: the encoder's and the cross-attention's full blocks
    too), and the mLSTM's matrix-memory update and read-out (``4·hd²``
    per token and head). ``layer_ops``: the per-layer weights' share
    (what ``remat`` recomputes)."""
    from repro_torch.models import param, xlstm
    leaves = dict(param.leaves(params))
    frac = (cfg.num_experts_per_token / cfg.num_experts
            if cfg.is_moe else 1.0)
    tokens = batch * seq
    frames = frames or seq

    def active(p, t):
        return t.numel() * (frac if p in EXPERT_LEAVES else 1.0)

    def rows(p):
        return batch * frames if (cfg.family == "encdec" and p.startswith(
            FRAME_LEAVES)) else tokens
    mats = [(p, t) for p, t in leaves.items() if p != "embed.tokens"]
    lays = [(p, t) for p, t in mats if p.startswith(LAYER_PREFIXES)]
    attn = 4 * attention_layers(cfg) * batch * cfg.num_heads * \
        attention_pairs(cfg, seq) * cfg.head_dim
    if cfg.family == "encdec":
        attn += 4 * batch * cfg.num_heads * cfg.head_dim * (
            (cfg.num_encoder_layers or cfg.num_layers)
            * full_pairs(cfg, frames, frames)
            + cfg.num_layers * full_pairs(cfg, seq, frames))
    rec = 0
    if cfg.family == "ssm":
        hd = 2 * cfg.d_model // cfg.num_heads
        rec = sum(xlstm.block_kind(cfg, i) == "mlstm"
                  for i in range(cfg.num_layers)) * 4 * tokens \
            * cfg.num_heads * hd * hd
    return dict(params=sum(t.numel() for t in leaves.values()),
                matmul_weights=sum(active(p, t) for p, t in mats),
                layer_weights=sum(active(p, t) for p, t in lays),
                tokens=tokens, frames=batch * frames,
                mat_ops=2 * sum(active(p, t) * rows(p) for p, t in mats),
                layer_ops=2 * sum(active(p, t) * rows(p) for p, t in lays),
                attn_ops=attn, rec_ops=rec)


def state_bytes(cfg, state, batch: int) -> tuple:
    """(bytes read, bytes written) of a decode step's state: a KV cache
    read whole, one slot written; the hybrid's rings likewise; every
    recurrent state (and conv tail) read and written whole."""
    if hasattr(state, "window"):
        item = state.k.element_size()
        return (2 * state.k.numel() * item,
                2 * state.k.shape[0] * batch * cfg.kv_size * item)
    if "cross_k" in state:             # encdec: self and cross K/V read
        item = state["self_k"].element_size()
        return (2 * (state["self_k"].numel() + state["cross_k"].numel())
                * item,
                2 * state["self_k"].shape[0] * batch * cfg.kv_size * item)
    read = written = 0
    for blk in state["blocks"]:
        for name, t in blk.items():
            nb = t.numel() * t.element_size()
            read += nb
            written += nb // cfg.local_window if name in ("k", "v") else nb
    return read, written


def decode_need(cfg, params, state, batch: int, routed=()) -> dict:
    """Bytes and operations one decode step needs: every weight but the
    embedding table read once (of the experts, only those the step
    routed to: ``routed`` distinct experts per MoE layer; of the table
    the ``batch`` rows gathered; of encdec, the decoder's but the
    cross-attention's K/V projections, whose outputs are cached), the
    state read and written (:func:`state_bytes`), the f32 logits written;
    two operations per weight element a token touches, the scores and
    P·V over the cache or ring (encdec: and over the frames), the mLSTM
    read-out and update (``4·hd²`` per head)."""
    from repro_torch.models import param
    item = cfg.dtype.itemsize
    leaves = dict(param.leaves(params))
    per_layer_expert = sum(leaves[p][0].numel() for p in EXPERT_LEAVES
                           if p in leaves) // max(cfg.num_experts, 1)
    dense = [t for p, t in leaves.items()
             if p != "embed.tokens" and p not in EXPERT_LEAVES
             and not (cfg.family == "encdec"
                      and p.startswith(FRAME_LEAVES))]
    dense_elems = sum(t.numel() for t in dense)
    weights = sum(t.numel() * t.element_size() for t in dense) + \
        sum(routed) * per_layer_expert * item
    touched = dense_elems + len(routed) * cfg.num_experts_per_token \
        * per_layer_expert
    read, written = state_bytes(cfg, state, batch)
    nbytes = (weights + batch * cfg.d_model * item + read + written
              + batch * cfg.vocab_size * 4)
    if hasattr(state, "window"):
        slots = state.max_len
    elif "cross_k" in state:
        slots = state["self_k"].shape[2] + state["cross_k"].shape[2]
    else:
        slots = cfg.local_window
    work = model_work(cfg, params, batch, 1)
    ops_ = 2 * batch * touched + 4 * attention_layers(cfg) * batch * \
        cfg.num_heads * slots * cfg.head_dim + work["rec_ops"]
    return dict(weight_bytes=weights, state_read_bytes=read,
                state_write_bytes=written, bytes=nbytes, ops=ops_,
                routed_experts=list(routed),
                bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                ops_ms=ops_ / BF16_OPS_PER_S * 1e3)


def prefill_need(cfg, params, state, batch: int, prompt: int,
                 frames: int = 0, input_bytes: int = 0) -> dict:
    """Bytes and operations of one prefill of ``prompt`` positions (and
    ``frames`` for encdec): the weights read once (the embedding's
    gathered rows), the frontend stubs' ``input_bytes`` read, the
    serving state written, the last logits; the operations of
    :func:`model_work`."""
    from repro_torch.models import param
    item = cfg.dtype.itemsize
    weights = sum(t.numel() * t.element_size()
                  for p, t in param.leaves(params) if p != "embed.tokens")
    if hasattr(state, "window"):
        written = 2 * state.k.numel() * item
    else:
        written = state_bytes(cfg, state, batch)[0]
    w = model_work(cfg, params, batch, prompt, frames)
    nbytes = (weights + batch * prompt * cfg.d_model * item + written
              + input_bytes + batch * cfg.vocab_size * 4)
    ops_ = w["mat_ops"] + w["attn_ops"] + w["rec_ops"]
    return dict(bytes=nbytes, ops=ops_,
                bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                ops_ms=ops_ / BF16_OPS_PER_S * 1e3)


def serve_build(torch, cfg, dev, checked, tag) -> tuple:
    """(a) The full config's weights on the card from ``PRNGKey(0)``,
    drawn in slices; the first ``SERVE_BITS_CHECKED`` elements of two
    leaves (``checked``) against the CPU's draws over the same
    counters."""
    from repro_torch import prng
    from repro_torch.models import api, param
    skel = api.skeleton(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = param.init_params(skel, prng.PRNGKey(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = dict(params=param.count_params(skel),
               param_bytes=param.param_bytes(skel), init_s=init_s,
               init_peak_bytes=torch.cuda.max_memory_allocated(),
               init_slice=param.INIT_SLICE)
    specs = dict(param.leaves(skel))
    paths = list(specs)
    keys = prng.split(prng.PRNGKey(0), len(paths))
    for path in checked:
        spec = specs[path]
        want = (prng.normal(keys[paths.index(path)], SERVE_BITS_CHECKED)
                * param.init_std(spec)).to(spec.dtype)
        got = dict(param.leaves(params))[path].reshape(-1)[
            :SERVE_BITS_CHECKED].cpu()
        if not same_bits(torch, got, want):
            fail(f"{tag} (a): {path} on the card differs from the CPU's "
                 f"draws over its first {SERVE_BITS_CHECKED} elements")
    log(f"{tag} (a) {cfg.name} at full width: {out['params']:,} "
        f"parameters, {out['param_bytes']:,} B in {cfg.dtype}, drawn on "
        f"the card in {init_s:.2f} s (slices of {param.INIT_SLICE:,}), "
        f"peak {out['init_peak_bytes'] / 2**30:.2f} GiB; "
        f"{' and '.join(checked)} bit for bit the CPU's first "
        f"{SERVE_BITS_CHECKED:,} draws")
    return params, out


def check_telemetry(torch, server, est, per, text, tenants, tag) -> dict:
    """(b) Fewer records than the capacity: each tenant's reservoir holds
    all its records (taken == counts), the variances are 0 and the means
    are those of the latencies folded, read back from the state."""
    st = server.telemetry
    counts, taken = st.counts.cpu(), st.taken().cpu()
    values = st.values.cpu().double()
    want_counts = torch.bincount(tenants.cpu().long(),
                                 minlength=SERVE_TENANTS) * SERVE_STEPS
    if not torch.equal(counts.long(), want_counts) or not torch.equal(
            taken, counts):
        fail(f"{tag} (b): counts {counts.tolist()} taken {taken.tolist()}"
             f", expected counts {want_counts.tolist()} all taken")
    folded = [values[i, :int(c)] for i, c in enumerate(counts)]
    every = torch.cat(folded)
    mean = float(every.mean())
    got = float(est.value)
    if abs(got - mean) > ANSWER_RTOL * abs(mean) or float(
            est.variance) != 0.0:
        fail(f"{tag} (b): telemetry mean {got} ± var "
             f"{float(est.variance)}, folded latencies' mean {mean}")
    tenant_means = [float(f.mean()) if f.numel() else 0.0 for f in folded]
    for i, (g, w) in enumerate(zip(per.value.cpu().tolist(),
                                   tenant_means)):
        if counts[i] and abs(g - w) > ANSWER_RTOL * abs(w):
            fail(f"{tag} (b): tenant {i} mean {g}, folded {w}")
    if bool((per.variance.cpu() != 0).any()):
        fail(f"{tag} (b): per-tenant variances {per.variance.tolist()}")
    lines = [ln for ln in text.splitlines() if not ln.startswith("#")]
    gauges = {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
              for ln in lines}
    if (len(gauges) != 2 + 2 * SERVE_TENANTS
            or abs(gauges["repro_serve_decode_latency_ms"] - got)
            > 1e-5 * abs(got)
            or gauges["repro_serve_decode_latency_ms_hw95"] != 0.0):
        fail(f"{tag} (b): metrics text does not parse to the estimates: "
             f"{gauges}")
    log(f"{tag} (b) telemetry: counts {counts.tolist()} = taken, mean "
        f"decode latency {got:.6g} ms (folded {mean:.6g}), variance 0, "
        f"per tenant {[round(x, 4) for x in tenant_means]}")
    return dict(counts=counts.tolist(), mean_ms=got,
                tenant_means_ms=tenant_means)


def positions(batch) -> int:
    """Positions a prefill of ``batch`` puts in the cache: its tokens and,
    for vlm, the patches before them."""
    p = batch.get("patches")
    return batch["tokens"].shape[1] + (0 if p is None else p.shape[1])


def self_cache(state):
    """The serving state's self-attention keys (a KV cache's ``k``,
    encdec's ``self_k``), or None for a recurrent state."""
    if hasattr(state, "window"):
        return state.k
    return state.get("self_k")


def serve_timed(torch, server, batch, tenants, tag) -> dict:
    """(b, d) The serving loop once more, timed on the host clock (each
    decode step ends in the server's synchronise): ``SERVE_PREFILLS``
    prefills, ``SERVE_STEPS`` decode steps; logits finite, tokens in
    range, the position prompt + steps; for a self-attention cache
    (``max_len=0``: a KV cache, encdec's ``self_k``) the clamped write:
    only the prompt's last slot rewritten."""
    from repro_torch.models import api
    from repro_torch.serve.serve_step import _next_tokens
    prompt = positions(batch)
    pre_ms = []
    for _ in range(SERVE_PREFILLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = server.prefill(batch)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
    finite = torch.isfinite(logits).all()
    cache = self_cache(state) is not None
    before = self_cache(state).clone() if cache else None
    toks = _next_tokens(logits)
    dec_ms, out = [], [toks]
    for _ in range(SERVE_STEPS):
        t0 = time.perf_counter()
        logits, state = server.decode(state, toks, tenants)
        dec_ms.append((time.perf_counter() - t0) * 1e3)
        finite &= torch.isfinite(logits).all()
        toks = _next_tokens(logits)
        out.append(toks)
    out = torch.cat(out, dim=1)
    vocab = server.cfg.vocab_size
    pos = int(api.state_tree(state)["position"])
    if not bool(finite) or not bool(((out >= 0) & (out < vocab)).all()) \
            or pos != prompt + SERVE_STEPS:
        fail(f"{tag} (b): logits finite {bool(finite)}, tokens in range, "
             f"position {pos} (expected {prompt + SERVE_STEPS})")
    if cache:
        slot = prompt - 1
        after = self_cache(state)
        kept = torch.equal(after[:, :, :slot], before[:, :, :slot])
        moved = not torch.equal(after[:, :, slot], before[:, :, slot])
        if not (kept and moved):
            fail(f"{tag} (b): clamped write: slots before {slot} kept "
                 f"{kept}, slot {slot} rewritten {moved}")
        log(f"{tag} (b) max_len=0: {SERVE_STEPS} decode steps rewrote "
            f"only slot {slot} of {prompt}, position {pos} (the "
            f"reference's clamped write)")
    return dict(prefill_ms=pre_ms, decode_ms=dec_ms, state=state,
                toks=toks)


def state_gaps(torch, state, fresh, n: int) -> dict:
    """Per leaf of a serving state, its largest gap to the same leaf of a
    fresh prefill's state as a share of that leaf's largest magnitude (a
    self-attention cache's first ``n`` slots, those the fresh prefill
    holds; encdec's cross-attention K/V, the hybrid's rings and recurrent
    states and the xLSTM's states whole); ``inf`` where an integer leaf
    (a position) differs."""
    from repro_torch.models import api, param
    got = dict(param.leaves(api.state_tree(state)))
    gaps = {}
    for path, want in param.leaves(api.state_tree(fresh)):
        have = got[path]
        if not want.is_floating_point():
            gaps[path] = 0.0 if torch.equal(have, want) else math.inf
            continue
        if have.shape != want.shape:
            have = have[:, :, :n]
        want = want.float()
        gaps[path] = float((have.float() - want).abs().amax()
                           / want.abs().amax().clamp_min(1e-30))
    return gaps


def serve_cache_consistency(torch, cfg, params, tokens, tag,
                            checked=None, gate=True, extra=None) -> dict:
    """(c) ``prefill_fn(max_len=prompt+steps)`` then ``decode_fn``, no
    clamp: at step t (each of ``checked``, every step if None) the logits
    against the last logits of a prefill over the prompt and the t tokens
    generated, within SERVE_LOGIT_ATOL, and every leaf of the serving
    state against that prefill's (:func:`state_gaps`), within
    SERVE_CACHE_RTOL of its largest magnitude (with the reference's
    random weights attention moves the logits little, so a wrong slot,
    ring or mask shows in the state, not in the logits). ``extra``: the
    frontend stubs' frames or patches, the same in every prefill.
    ``gate=False`` only logs the gaps."""
    from repro_torch.models import api
    from repro_torch.serve.serve_step import _next_tokens
    extra = extra or {}
    prompt = positions(dict(extra, tokens=tokens))
    checked = range(1, SERVE_STEPS + 1) if checked is None else checked
    prefill, decode = api.prefill_fn(cfg), api.decode_fn(cfg)
    logit_err, state_err, worst = [], [], (-1.0, None)
    with torch.inference_mode():
        logits, state = prefill(params, dict(extra, tokens=tokens),
                                max_len=prompt + SERVE_STEPS)
        seq, nxt = tokens, _next_tokens(logits)
        for t in range(1, SERVE_STEPS + 1):
            seq = torch.cat([seq, nxt], dim=1)
            logits, state = decode(params, state, nxt)
            if t in checked:
                again, fresh = prefill(params, dict(extra, tokens=seq))
                logit_err.append(float((logits - again).abs().amax()))
                gaps = state_gaps(torch, state, fresh, prompt + t)
                path = max(gaps, key=gaps.get)
                state_err.append(gaps[path])
                worst = max(worst, (gaps[path], f"{path} at t = {t}"),
                            key=lambda w: w[0])
                del fresh
            nxt = _next_tokens(logits)
        pos = int(api.state_tree(state)["position"])
    log(f"{tag} (c) {tokens.shape[0]} requests, {cfg.dtype}"
        f"{'' if gate else ' (logged, not gated)'}: decode step t's logits "
        f"within {max(logit_err):.4g} of a prefill over prompt + t tokens "
        f"(limit {SERVE_LOGIT_ATOL}), its state within {worst[0]:.4g} of "
        f"the largest ({worst[1]}; limit {SERVE_CACHE_RTOL}); at t = "
        f"{list(checked)} logits {[round(w, 4) for w in logit_err]}, state "
        f"{[round(w, 5) for w in state_err]}")
    if gate and (max(logit_err) > SERVE_LOGIT_ATOL or worst[0]
                 > SERVE_CACHE_RTOL or pos != prompt + SERVE_STEPS):
        fail(f"{tag} (c): decode vs prefill logits differ by up to "
             f"{max(logit_err)} (limit {SERVE_LOGIT_ATOL}), the state by "
             f"{worst[0]} of its largest ({worst[1]}; limit "
             f"{SERVE_CACHE_RTOL}); position {pos}")
    return dict(steps=list(checked), dtype=str(cfg.dtype), gated=gate,
                logit_max_abs=logit_err, state_max_rel=state_err,
                worst_leaf=worst[1])


def moe_dispatch_check(torch, cfg, params, tokens, tag) -> dict:
    """(c) The MoE dispatch at the served prefill shape: the first MoE
    layer's input in a prefill of ``tokens`` (one group of ``prompt``
    tokens per row), at the served capacity factor and at
    ``MOE_TIGHT_CAPACITY``, where experts overflow; at each, the plan
    against a plain one (each row's assignments ranked per expert in
    flat order by an integer cumulative count, the first C kept) bit for
    bit, and ``moe_ffn``'s output against a loop over rows and experts
    within SERVE_CACHE_RTOL of its largest magnitude. Fails if nothing
    is dropped at the tight capacity."""
    import torch.nn.functional as F
    from repro_torch.models import api, moe
    seen, real = [], moe.moe_ffn

    def capture(p, x, c, key=None):
        if not seen:
            seen.append((p, x.clone()))
        return real(p, x, c, key)
    moe.moe_ffn = capture
    try:
        with torch.inference_mode():
            api.prefill_fn(cfg)(params, {"tokens": tokens})
    finally:
        moe.moe_ffn = real
    p, x = seen[0]
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_token
    out = {}
    for cf in (cfg.capacity_factor, MOE_TIGHT_CAPACITY):
        c = cfg.replace(capacity_factor=cf)
        cap = moe.capacity_of(c, s)
        with torch.inference_mode():
            y = real(p, x, c)
            eids, gates, dst, keep, _ = moe.route(p, x, c)
            flat = eids.reshape(b, s * k).long()
            rank = (F.one_hot(flat, e).cumsum(1) - 1).gather(
                2, flat[..., None])[..., 0]
            keep_plain = rank < cap
            dst_plain = torch.where(keep_plain, flat * cap + rank, e * cap)
            w = gates.reshape(b, s * k) * keep_plain
            plain = torch.zeros(b, s, d, dtype=torch.float32,
                                device=x.device)
            for r in range(b):
                for j in range(e):
                    a = torch.nonzero(keep_plain[r] & (flat[r] == j))[:, 0]
                    t = a // k
                    xe = x[r, t]
                    h = F.silu(xe @ p["w_gate"][j]) * (xe @ p["w_in"][j])
                    plain[r].index_add_(0, t, (h @ p["w_out"][j]).float()
                                        * w[r, a, None])
            if "shared" in p:
                sh = p["shared"]
                plain += ((F.silu(x @ sh["w_gate"]) * (x @ sh["w_in"]))
                          @ sh["w_out"]).float()
            err = float((y.float() - plain).abs().amax()
                        / plain.abs().amax())
        same = torch.equal(keep, keep_plain) and torch.equal(dst.long(),
                                                            dst_plain)
        dropped = int((~keep_plain).sum())
        if not same or err > SERVE_CACHE_RTOL or (
                cf == MOE_TIGHT_CAPACITY and not dropped):
            fail(f"{tag} (c): MoE plan at capacity {cap} the plain one's "
                 f"{same}, {dropped} assignments dropped; moe_ffn within "
                 f"{err} of the loop's largest (limit {SERVE_CACHE_RTOL})")
        log(f"{tag} (c) MoE dispatch of {b} x {s} tokens at capacity "
            f"factor {cf} (capacity {cap}): {dropped} of {b * s * k} "
            f"assignments dropped, keep and dst bit for bit the plain "
            f"plan's, moe_ffn within {err:.4g} of a loop over rows and "
            f"experts (limit {SERVE_CACHE_RTOL})")
        out[f"capacity_{cap}"] = dict(capacity_factor=cf, dropped=dropped,
                                      assignments=b * s * k,
                                      ffn_max_rel=err)
    return out


def serve_sentinel(torch, seed: int, dev) -> dict:
    """(e) Phase main's executor under ``Telemetry(strict_retrace=True)``
    raises nothing; then one chunk of half the size, non-strict, logs
    exactly one ``retrace`` event."""
    import warnings
    from repro_torch import prng
    from repro_torch.obs import EventLog, Telemetry
    from repro_torch.runtime.executor import PipelinedExecutor
    from repro_torch.runtime.records import TimestampedChunk
    chunks, _ = make_stream(torch, seed, dev)
    cfg, reg = main_config()
    ex = PipelinedExecutor(cfg, reg, prng.PRNGKey(seed), device=dev,
                           telemetry=Telemetry(EventLog(),
                                               strict_retrace=True))
    ex.run(chunks)
    ex.query()
    traces = {k: s.traces for k, s in ex._sentinels.items()}
    if traces != {"query": 1, "step": 1, "emit": 1}:
        fail(f"serve (e): strict run traced {traces}")
    events = EventLog()
    ex.attach_telemetry(Telemetry(events, strict_retrace=False))
    half = TimestampedChunk(*(getattr(chunks[0], f)[:M // 2] for f in (
        "values", "stratum_ids", "times", "mask")))
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        ex.push(half)
    retraces = events.of_type("retrace")
    if [(e["step"], e["traces"], e["allowed"]) for e in retraces] != [
            ("pipelined.step", 2, 1)]:
        fail(f"serve (e): half-size chunk logged {retraces}")
    log(f"[serve] (e) phase main's executor, strict: traces {traces}, "
        f"nothing raised; a {M // 2}-item chunk then logged one retrace "
        f"event {retraces[0]}")
    return dict(strict_traces=traces, retrace=retraces[0])


def frontend_inputs(cfg, key, requests: int, length: int) -> dict:
    """The frontend stubs' inputs of ``cfg``'s family, drawn as
    ``launch/serve`` draws them from ``key``: encdec ``frames [requests,
    length, d_model]`` on ``fold_in(key, 1)``, vlm ``patches [requests,
    num_patches, d_model]`` on ``fold_in(key, 2)``; none for the
    others."""
    from repro_torch import prng
    if cfg.family == "encdec":
        return {"frames": prng.normal(prng.fold_in(key, 1),
                                      (requests, length, cfg.d_model))}
    if cfg.family == "vlm":
        return {"patches": prng.normal(prng.fold_in(key, 2),
                                       (requests, cfg.num_patches,
                                        cfg.d_model))}
    return {}


def cut_layers(params: dict, n: int) -> dict:
    """The first ``n`` layers of every stacked leaf (the others whole)."""
    from repro_torch.models import param
    return param.map_tree(lambda p, t: t[:n] if p.startswith(
        LAYER_PREFIXES) else t, params)


def serve_model(torch, cfg, dev, tag="[serve]",
                checked=("embed.tokens", "dense_layers.attn.wq"),
                prompt=None, cache_steps=None, gate_layers=None) -> dict:
    """One full-width model served: (a) its weights on the card
    (:func:`serve_build`); (b) ``Server.generate`` of ``SERVE_REQUESTS``
    prompts of ``prompt`` (``SERVE_PROMPT``) tokens for ``SERVE_STEPS``
    steps, every kernel call held to its plain version, the telemetry read
    back and checked;
    (d) the loop again timed (:func:`serve_timed`), each figure beside its
    bound, one traced decode step's device activities and host ops, the
    telemetry's own calls; (c) decode against prefill
    (:func:`serve_cache_consistency` at ``cache_steps``). Dense is gated
    in its served dtype. The other families are logged in it and gated
    on an f32 copy of the weights: the recurrent states integrate over
    time the rounding differences of the two paths' bf16 products
    (prefill multiplies ``[rows x tokens, D]`` blocks, decode ``[rows,
    D]``), 0.032 of the largest xLSTM state leaf on an H100 against
    phi4's K/V at 0.009, while a wrong slot, ring or state shows at
    O(1); in bf16 a router near-tie picks different experts in the two
    paths. For moe, (c) also holds the dispatch, at the served capacity
    and where experts overflow, to a plain one
    (:func:`moe_dispatch_check`), and runs decode against
    prefill at a capacity that drops nothing: with drops the two
    legitimately differ (their groups and capacities differ, in the
    reference too). encdec and vlm requests carry the frontend stubs'
    frames (one per prompt token) or patches (:func:`frontend_inputs`);
    ``gate_layers`` cuts the f32 copy of (c) to its first layers."""
    from repro_torch import prng
    from repro_torch.core import oasrs
    from repro_torch.kernels import ops
    from repro_torch.models import param
    from repro_torch.serve.serve_step import Server
    prompt = SERVE_PROMPT if prompt is None else prompt
    result = dict(arch=cfg.name, family=cfg.family, dtype=str(cfg.dtype),
                  num_layers=cfg.num_layers, requests=SERVE_REQUESTS,
                  prompt=prompt, steps=SERVE_STEPS, tenants=SERVE_TENANTS,
                  capacity=SERVE_CAPACITY)
    torch.cuda.empty_cache()
    params, result["build"] = serve_build(torch, cfg, dev, checked, tag)

    # (b) The main path: Server.generate and the telemetry queries, every
    # kernel call held to its plain version.
    server = Server(cfg, params, num_tenants=SERVE_TENANTS,
                    telemetry_capacity=SERVE_CAPACITY, device=dev)
    key = prng.PRNGKey(1, device=dev)
    tokens = prng.randint(key, (SERVE_REQUESTS, prompt), 0, cfg.vocab_size)
    tenants = prng.randint(prng.fold_in(key, 3), (SERVE_REQUESTS,), 0,
                           SERVE_TENANTS)
    extra = frontend_inputs(cfg, key, SERVE_REQUESTS, prompt)
    batch = dict(extra, tokens=tokens)
    result.update({k: list(v.shape) for k, v in extra.items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with HeldToPlain(torch, tag) as held:
        t0 = time.perf_counter()
        out = server.generate(batch, steps=SERVE_STEPS, tenant_ids=tenants)
        torch.cuda.synchronize()
        generate_s = time.perf_counter() - t0
        est = server.telemetry_mean()
        per = server.telemetry_per_tenant()
        text = server.metrics_text()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {("reservoir_fold", (SERVE_TENANTS, SERVE_CAPACITY),
             SERVE_REQUESTS): SERVE_STEPS,
            ("stratified_stats", SERVE_TENANTS,
             SERVE_TENANTS * SERVE_CAPACITY): 4}
    if held.calls != want or launches["reservoir_fold"] != SERVE_STEPS \
            or launches["stratified_stats"] != 4:
        fail(f"{tag} (b): kernel calls held {held.calls}, launches "
             f"{launches}; expected {want}")
    if tuple(out.shape) != (SERVE_REQUESTS, SERVE_STEPS + 1) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        fail(f"{tag} (b): generated {tuple(out.shape)} {out.dtype}")
    log(f"{tag} (b) Server.generate: {SERVE_REQUESTS} requests x "
        f"{prompt}-token prompts"
        f"{''.join(f', {k} {list(v.shape)}' for k, v in extra.items())}, "
        f"{SERVE_STEPS} decode steps in "
        f"{generate_s:.3f} s; every kernel call held to its plain version "
        f"({held.calls}); launches {launches}")
    log(f"{tag} (b) metrics_text():\n" + text.rstrip())
    result["telemetry"] = check_telemetry(torch, server, est, per, text,
                                          tenants, tag)
    result.update(generate_s=generate_s, launches=launches,
                  held=str(held.calls), peak_bytes=peak)

    # (d) Times: the loop again, then the telemetry's own calls.
    timed = serve_timed(torch, server, batch, tenants, tag)
    state = timed.pop("state")
    toks = timed.pop("toks")
    dec = sorted(timed["decode_ms"])
    med = dec[len(dec) // 2]
    pre = sorted(timed["prefill_ms"])[len(timed["prefill_ms"]) // 2]
    routed = (routed_experts(torch, server, state, toks) if cfg.is_moe
              else [])
    need = decode_need(cfg, params, state, SERVE_REQUESTS, routed)
    pneed = prefill_need(cfg, params, state, SERVE_REQUESTS,
                         positions(batch), prompt, sum(
                             v.numel() * v.element_size()
                             for v in extra.values()))
    tel = oasrs.OASRSState(values=server.telemetry.values.clone(),
                           counts=server.telemetry.counts.clone(),
                           capacity=server.telemetry.capacity.clone(),
                           key=server.telemetry.key.clone())
    lat = torch.full((SERVE_REQUESTS,), 1.0, dtype=torch.float32,
                     device=dev)
    fold_ms = time_ms(lambda: oasrs.update_chunk(tel, tenants, lat), torch)
    mean_ms = time_ms(server.telemetry_mean, torch)
    tenant_ms = time_ms(server.telemetry_per_tenant, torch)
    t0 = time.perf_counter()
    for _ in range(10):
        server.metrics_text()
    text_ms = (time.perf_counter() - t0) / 10 * 1e3
    box = [state, toks]

    def steps():
        for _ in range(3):
            logits, box[0] = server.decode(box[0], box[1], tenants)
    acts, busy_ms, own, host_ops = device_split(torch, steps, 3)
    bound_ms = max(need["bytes_ms"], need["ops_ms"])
    pbound_ms = max(pneed["bytes_ms"], pneed["ops_ms"])
    result.update(
        prefill_ms=timed["prefill_ms"], decode_ms=timed["decode_ms"],
        decode_median_ms=med, decode_min_ms=dec[0], decode_max_ms=dec[-1],
        tokens_per_s=SERVE_REQUESTS * SERVE_STEPS
        / (sum(dec) / 1e3),
        tokens_per_s_end_to_end=SERVE_REQUESTS * SERVE_STEPS
        / ((pre + sum(dec)) / 1e3),
        prefill_tokens_per_s=SERVE_REQUESTS * positions(batch)
        / (pre / 1e3),
        decode_need=need, decode_bound_ms=bound_ms,
        decode_bound_by="bytes" if need["bytes_ms"] >= need["ops_ms"]
        else "operations",
        prefill_need=pneed, prefill_bound_ms=pbound_ms,
        prefill_bound_by="bytes" if pneed["bytes_ms"] >= pneed["ops_ms"]
        else "operations",
        telemetry_fold_ms=fold_ms, telemetry_mean_ms=mean_ms,
        telemetry_per_tenant_ms=tenant_ms, metrics_text_ms=text_ms,
        decode_device_activities=acts, decode_device_busy_ms=busy_ms,
        decode_busy_share=busy_ms / med, decode_own_kernel_ms=own,
        decode_host_ops=host_ops)
    log(f"{tag} (d) prefill of {SERVE_REQUESTS} x {positions(batch)} "
        f"positions: "
        f"{[round(x, 3) for x in timed['prefill_ms']]} ms "
        f"({result['prefill_tokens_per_s']:.1f} tokens/s; bound "
        f"{pbound_ms:.3f} ms by {result['prefill_bound_by']}); decode step "
        f"median {med:.4f} ms, min {dec[0]:.4f}, max {dec[-1]:.4f} "
        f"({SERVE_STEPS} steps); bound {bound_ms:.4f} ms by "
        f"{result['decode_bound_by']} ({need['bytes'] / 1e9:.4f} GB: "
        f"weights {need['weight_bytes'] / 1e9:.4f}, state read "
        f"{need['state_read_bytes'] / 1e9:.4f}, written "
        f"{need['state_write_bytes'] / 1e9:.4f}"
        f"{f'; routed experts per layer {routed}' if routed else ''}); "
        f"{result['tokens_per_s']:.1f} generated tokens/s "
        f"({result['tokens_per_s_end_to_end']:.1f} with the prefill)")
    log(f"{tag} (d) one decode step: {acts:.1f} device activities, "
        f"{busy_ms:.4f} ms device busy = {busy_ms / med:.3f} of the median "
        f"step, {host_ops:.0f} host torch ops; own kernels {own}")
    log(f"{tag} (d) telemetry: fold of {SERVE_REQUESTS} records "
        f"{fold_ms:.4f} ms, telemetry_mean {mean_ms:.4f} ms, per tenant "
        f"{tenant_ms:.4f} ms (device, events); metrics_text "
        f"{text_ms:.4f} ms (host); peak memory of (b) "
        f"{peak / 2**30:.2f} GiB")
    del state, box, timed, server, tel
    torch.cuda.empty_cache()

    ctoks = tokens[:SERVE_CACHE_BATCH]
    cextra = {k: v[:SERVE_CACHE_BATCH] for k, v in extra.items()}
    del batch, extra
    if cfg.family != "dense":
        if cfg.is_moe:
            result["moe_plan"] = moe_dispatch_check(torch, cfg, params,
                                                    ctoks, tag)
            cfg = cfg.replace(capacity_factor=(
                cfg.num_experts / cfg.num_experts_per_token))
        result["cache_served"] = serve_cache_consistency(
            torch, cfg, params, ctoks, tag, cache_steps, gate=False,
            extra=cextra)
        if gate_layers:
            params = cut_layers(params, gate_layers)
            cfg = cfg.replace(num_layers=gate_layers)
            log(f"{tag} (c) gated on an f32 copy of its first "
                f"{gate_layers} layers (the bf16 run above at all "
                f"{result['num_layers']} served)")
        params = param.map_tree(lambda _p, t: t.float(), params)
        cfg = cfg.replace(dtype=torch.float32)
        torch.cuda.empty_cache()
    result["cache"] = serve_cache_consistency(torch, cfg, params, ctoks,
                                              tag, cache_steps, extra=cextra)
    result["cache"]["num_layers"] = cfg.num_layers
    del params
    torch.cuda.empty_cache()
    return result


def phase_serve(torch, seed: int, dev, cfg=None) -> dict:
    """``SERVE_ARCH`` (or ``cfg``) served at full width
    (:func:`serve_model`), then phase main's executor under the retrace
    sentinel (:func:`serve_sentinel`); ``chiprun_out/
    chip_smoke_serve.json``."""
    from repro_torch import configs
    t_phase = time.perf_counter()
    flags = dict(
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        matmul_allow_bf16_reduced_precision_reduction=(
            torch.backends.cuda.matmul
            .allow_bf16_reduced_precision_reduction),
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    log(f"[serve] torch matmul flags as found (none set): {flags}")
    result = dict(card=card(), flags=flags)
    cfg = configs.get_config(SERVE_ARCH) if cfg is None else cfg
    result.update(serve_model(torch, cfg, dev))
    result["sentinel"] = serve_sentinel(torch, seed, dev)
    result["seconds"] = time.perf_counter() - t_phase
    log(f"[serve] phase took {result['seconds']:.1f} s")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_serve.json").write_text(
        json.dumps(result, indent=1, default=str))
    return result


def train_need(cfg, params, batch: int, seq: int) -> dict:
    """One training step's work, from the run's own counts: the forward's
    operations (:func:`model_work`), the backward at twice the forward,
    the ``remat`` forward of the layers again; and the optimizer's and
    clip's bytes (the grads read for the norm, read and written by the
    clip, read by AdamW; master, mu and nu read and written in f32; the
    params written). The bound is the sum of the two phases' least
    times."""
    w = model_work(cfg, params, batch, seq + (
        cfg.num_patches if cfg.family == "vlm" else 0), seq)
    seq_ops = w["attn_ops"] + w["rec_ops"]
    remat = cfg.remat == "full"
    ops_ = 3 * (w["mat_ops"] + seq_ops) + (
        w["layer_ops"] + seq_ops if remat else 0)
    item = cfg.dtype.itemsize
    nbytes = w["params"] * (4 * item + 3 * 2 * 4 + item)
    ops_ms = ops_ / BF16_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(params=w["params"], matmul_weights=w["matmul_weights"],
                layer_weights=w["layer_weights"], tokens=w["tokens"],
                ops=ops_, opt_bytes=nbytes, ops_ms=ops_ms,
                opt_bytes_ms=bytes_ms, bound_ms=ops_ms + bytes_ms)


def train_frontend(cfg, seed: int, step: int, batch: int, seq: int,
                   dev) -> dict:
    """Step ``step``'s frontend stub inputs in phase families' training
    (:func:`frontend_inputs` of ``batch`` rows, ``seq`` frames for
    encdec): ``prng.normal`` on a key folded with the step."""
    from repro_torch import prng
    key = prng.fold_in(prng.fold_in(prng.PRNGKey(seed, device=dev),
                                    FRONTEND_KEY), step)
    return frontend_inputs(cfg, key, batch, seq)


@contextlib.contextmanager
def frontend_batches(cfg, seed: int):
    """Inside ``with``, every batch ``launch/train`` assembles (tokens and
    weights of the sequences the fold kernel sampled) also carries its
    step's frontend stub inputs (:func:`train_frontend`): the
    reference's ``assemble_batch`` builds ``tokens`` and ``weights``
    only, so its CLI cannot train encdec or vlm. The train step is
    ``train_step.make_train_step``'s, as for every family."""
    from repro_torch.launch import train as tlt
    real, step = tlt.assemble_batch, [0]

    def assemble(tokens, sel_idx, w, valid, batch):
        out = real(tokens, sel_idx, w, valid, batch)
        step[0] += 1
        out.update(train_frontend(cfg, seed, step[0], batch,
                                  tokens.shape[1], tokens.device))
        return out
    tlt.assemble_batch = assemble
    try:
        yield
    finally:
        tlt.assemble_batch = real


def train_first_batch(torch, run, dev) -> dict:
    """Step 1's batch, drawn on the CPU (the fold's plain version: no
    launch) from epoch 0's window and the run's fresh reservoirs, as
    ``launch/train.train`` draws it; on ``dev``."""
    from repro_torch import configs, prng
    from repro_torch.core import oasrs
    from repro_torch.launch import train as tlt
    from repro_torch.stream.pipeline import (TokenWindowSpec,
                                             synthetic_token_window)
    cfg = configs.get_config(run.arch, smoke=run.smoke)
    spec = TokenWindowSpec(int(run.batch / run.sampling_fraction),
                           run.seq_len, run.num_domains, cfg.vocab_size)
    cap = max(run.batch // run.num_domains, 1)
    res = oasrs.init(run.num_domains, cap,
                     prng.fold_in(prng.PRNGKey(run.seed), 1),
                     max_capacity=4 * cap,
                     payload_spec=oasrs.PayloadSpec(dtype=torch.int32),
                     device="cpu")
    tokens, domains = synthetic_token_window(spec, 0, run.seed, "cpu")
    _, idx, w, valid = tlt.sample_window(res, tokens, domains)
    batch = tlt.assemble_batch(tokens, idx, w, valid, run.batch)
    return {k: v.to(dev) for k, v in batch.items()}


class TrainProbe:
    """Hooks on ``launch/train.train``'s main path, inside ``with``:

    * ``optimizer.init_state``: before the optimizer state is allocated,
      step 1's loss recomputed in f32 (the params upcast, the config's
      dtype f32) on ``first_batch``;
    * ``launch/train.sample_window``: each window's domains and sample
      (indices, weights, validity) kept for the CPU check;
    * ``launch/train.make_train_step``: each step timed on the host clock
      between two synchronisations; step ``TRAIN_PROFILED_STEP`` traced
      instead (``device_split``);
    * ``optimizer.apply_updates``: each update's device time (CUDA
      events around it, clip included); at step ``TRAIN_CHECKED_STEP``,
      the first ``TRAIN_SLICE`` elements of ``leaf``'s master, mu and nu
      against the functional AdamW formula on the same grads, the error
      relative to the slice's largest magnitude.
    """

    def __init__(self, torch, cfg, first_batch, leaf: str = TRAIN_LEAF,
                 traced: bool = True):
        self.torch, self.cfg, self.first_batch = torch, cfg, first_batch
        self.leaf, self.traced = leaf, traced
        self.loss32, self.windows, self.step_ms = None, [], []
        self.profile, self.adam, self.update_events = None, None, []

    def __enter__(self):
        from repro_torch.launch import train as tlt
        from repro_torch.train import optimizer as opt
        self.saved = [(opt, "init_state", opt.init_state),
                      (opt, "apply_updates", opt.apply_updates),
                      (tlt, "sample_window", tlt.sample_window),
                      (tlt, "make_train_step", tlt.make_train_step)]
        opt.init_state = self.init_state
        opt.apply_updates = self.apply_updates
        tlt.sample_window = self.sample_window
        tlt.make_train_step = self.make_train_step
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False

    def _real(self, name):
        return next(fn for _, n, fn in self.saved if n == name)

    def update_ms(self) -> list:
        """Each update's device ms, from its events."""
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.update_events]

    def init_state(self, params, mesh, opt_cfg, skeleton=None):
        from repro_torch.models import api, param
        t = self.torch
        with t.no_grad():
            p32 = param.map_tree(lambda _p, x: x.float(), params)
            loss = api.loss_fn(self.cfg.replace(dtype=t.float32))
            self.loss32 = float(loss(p32, self.first_batch)[0])
        del p32
        t.cuda.empty_cache()
        return self._real("init_state")(params, mesh, opt_cfg, skeleton)

    def sample_window(self, res, tokens, domains):
        out = self._real("sample_window")(res, tokens, domains)
        self.windows.append((domains.clone(), out[1].clone(),
                             out[2].clone(), out[3].clone()))
        return out

    def make_train_step(self, cfg, opt_cfg, num_microbatches=1):
        real = self._real("make_train_step")(cfg, opt_cfg, num_microbatches)
        t = self.torch

        def step(state, batch):
            k = len(self.step_ms) + (self.profile is not None) + 1
            if self.traced and k == TRAIN_PROFILED_STEP:
                box = []
                self.profile = device_split(
                    t, lambda: box.append(real(state, batch)), 1)
                return box[0]
            t.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(state, batch)
            t.cuda.synchronize()
            self.step_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return step

    def apply_updates(self, state, grads, opt_cfg):
        from repro_torch import prng
        from repro_torch.models import param
        real = self._real("apply_updates")
        t = self.torch
        a = t.cuda.Event(enable_timing=True)
        b = t.cuda.Event(enable_timing=True)
        self.update_events.append((a, b))
        a.record()
        if int(state.step) + 1 != TRAIN_CHECKED_STEP:
            out = real(state, grads, opt_cfg)
            b.record()
            return out
        t, n = self.torch, TRAIN_SLICE

        def part(tree):
            return dict(param.leaves(tree))[self.leaf].reshape(-1)[:n]
        g = part(grads).clone()
        mu, nu, master = (part(x).clone()
                          for x in (state.mu, state.nu, state.master))
        new, metrics = real(state, grads, opt_cfg)
        b.record()
        gn, lr = metrics["grad_norm"], metrics["lr"]
        scale = t.clamp(opt_cfg.grad_clip / t.clamp(gn, min=1e-9), max=1.0)
        g32 = (g * scale.to(g.dtype)).float()
        b1, b2 = opt_cfg.b1, opt_cfg.b2
        mu_n = b1 * mu + (1 - b1) * g32
        nu_n = b2 * nu + (1 - b2) * g32 * g32
        sf = new.step.float()
        c1 = 1.0 - prng.xla_pow(t.full_like(sf, float(np.float32(b1))), sf)
        c2 = 1.0 - prng.xla_pow(t.full_like(sf, float(np.float32(b2))), sf)
        delta = (mu_n / c1) / (t.sqrt(nu_n / c2) + opt_cfg.eps)
        want = master - lr * (delta + opt_cfg.weight_decay * master)
        # Relative to the slice's largest magnitude: mu's entries cancel
        # to near 0 where the grads change sign.
        err = {f: float((part(getattr(new, f)) - w).abs().max()
                        / w.abs().max().clamp(min=1e-30))
               for f, w in (("mu", mu_n), ("nu", nu_n), ("master", want))}
        self.adam = dict(step=int(new.step), leaf=self.leaf, elements=n,
                         max_rel_err=err, grad_norm=float(gn),
                         lr=float(lr))
        return new, metrics


def train_resume(torch, dev) -> dict:
    """The resume path at the smoke config on the card: 6 steps with a
    checkpoint every 3 into a temporary directory, the state restored
    from it against the state saved (bit for bit), then 3 more steps from
    it against steps 7-9 of an uninterrupted 9-step run."""
    import tempfile
    from repro_torch.launch import train as tlt
    from repro_torch.train import checkpoint as ckpt
    kw = dict(arch=TRAIN_ARCH, smoke=True, steps=6, batch=4, seq_len=32,
              sampling_fraction=0.5)
    quiet = dict(device=dev, log=lambda *_: None)
    whole = tlt.train(tlt.RunConfig(**dict(kw, steps=9)), **quiet)
    saved = {}
    real_save = ckpt.AsyncCheckpointer.save

    def save(self, step, tree):
        saved[step] = (tree, ckpt.host_leaves(tree))
        return real_save(self, step, tree)
    with tempfile.TemporaryDirectory() as d:
        ckpt.AsyncCheckpointer.save = save
        try:
            first = tlt.train(tlt.RunConfig(**kw, checkpoint_dir=d,
                                            checkpoint_every=3), **quiet)
        finally:
            ckpt.AsyncCheckpointer.save = real_save
        last = ckpt.latest_step(d)
        template, host = saved[last]
        back = ckpt.host_leaves(ckpt.restore(d, last, template))
        same = len(back) == len(host) and all(
            a[1:] == b[1:] and np.array_equal(a[0], b[0])
            for a, b in zip(back, host))
        rest = tlt.train(tlt.RunConfig(**dict(kw, steps=3),
                                       checkpoint_dir=d,
                                       checkpoint_every=100), **quiet)
    err = max(abs(a - b) / abs(b) for a, b in zip(rest, whole[6:]))
    if (last != 6 or not same or first != whole[:6]
            or not all(math.isfinite(x) for x in rest)
            or err > TRAIN_RESUME_RTOL):
        fail(f"train (resume): latest step {last}, restored state bit for "
             f"bit the saved {same}, first 6 losses the uninterrupted "
             f"run's {first == whole[:6]}, resumed {rest} vs {whole[6:]} "
             f"(rtol {TRAIN_RESUME_RTOL})")
    log(f"[train] (resume) smoke config on the card: checkpoint at step "
        f"{last} restored bit for bit ({len(host)} leaves), steps 7-9 "
        f"{[round(x, 6) for x in rest]} vs the uninterrupted "
        f"{[round(x, 6) for x in whole[6:]]} (max rel {err:.3g}, rtol "
        f"{TRAIN_RESUME_RTOL}; bit for bit: {rest == whole[6:]})")
    return dict(latest_step=last, leaves=len(host), resumed=rest,
                uninterrupted=whole[6:], max_rel_err=err,
                bitwise=rest == whole[6:])


@contextlib.contextmanager
def config_as(cfg):
    """Inside ``with``, ``launch/train`` gets ``cfg`` for ``cfg.name``
    (a config cut in depth, as ``configs.get_config`` has none)."""
    from repro_torch.launch import train as tlt
    real = tlt.cfgs.get_config

    def get_config(name, smoke=False):
        return cfg if name == cfg.name and not smoke else real(name, smoke)
    tlt.cfgs.get_config = get_config
    try:
        yield
    finally:
        tlt.cfgs.get_config = real


def phase_train(torch, seed: int, dev, smoke: bool = False,
                cfg=None) -> dict:
    """``launch/train.train`` at ``phi4-mini-3.8b``'s full config in bf16
    (the reference CLI's defaults otherwise; no checkpoint directory: a
    full-width checkpoint would be 62 GB of host files), every fold held
    to its plain version; then the checks and figures of ``TrainProbe``,
    the sampled windows against the CPU, and the resume path at the
    smoke config. Given ``cfg`` (phase families: another family, at full
    width, its depth perhaps cut), ``launch/train`` trains that config,
    the AdamW slice is ``FAMILY_LEAF``'s, and the resume path and the
    JSON file are left to the caller."""
    from repro_torch import configs, prng
    from repro_torch.core import oasrs
    from repro_torch.kernels import ops
    from repro_torch.launch import train as tlt
    from repro_torch.models import api, param
    from repro_torch.stream.pipeline import (TokenWindowSpec,
                                             synthetic_token_window)
    t_phase = time.perf_counter()
    family = cfg is not None
    run = tlt.RunConfig(arch=cfg.name if family else TRAIN_ARCH,
                        smoke=smoke, steps=TRAIN_STEPS,
                        batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                        num_domains=TRAIN_DOMAINS,
                        sampling_fraction=TRAIN_FRACTION, seed=seed)
    if not family:
        cfg = configs.get_config(run.arch, smoke=run.smoke)
    leaf = FAMILY_LEAF[cfg.name] if family else TRAIN_LEAF
    traced = cfg.name not in FAMILY_UNTRACED
    window = int(run.batch / run.sampling_fraction)
    cap = max(run.batch // run.num_domains, 1)
    first = train_first_batch(torch, run, dev)
    first.update(train_frontend(cfg, seed, 1, run.batch, run.seq_len, dev))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lines = []

    def keep(line):
        lines.append(line)
        log(line)
    ops.reset_launch_counts()
    with HeldToPlain(torch, "train") as held, config_as(cfg), \
            frontend_batches(cfg, seed), \
            TrainProbe(torch, cfg, first, leaf, traced) as probe:
        t0 = time.perf_counter()
        losses = tlt.train(run, device=dev, log=keep)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    want = {("reservoir_fold", (run.num_domains, 4 * cap), window):
            TRAIN_STEPS}
    if held.calls != want or launches["reservoir_fold"] != TRAIN_STEPS:
        fail(f"train: kernel calls held {held.calls}, launches {launches}; "
             f"expected {want}")
    # The sampled windows against a CPU run of the same sample_window.
    res = oasrs.init(run.num_domains, cap,
                     prng.fold_in(prng.PRNGKey(seed), 1),
                     max_capacity=4 * cap,
                     payload_spec=oasrs.PayloadSpec(dtype=torch.int32),
                     device="cpu")
    spec = TokenWindowSpec(window, run.seq_len, run.num_domains,
                           cfg.vocab_size)
    for e, (dom, idx, w, valid) in enumerate(probe.windows):
        tokens, domains = synthetic_token_window(spec, e, seed, "cpu")
        res, ci, cw, cv = tlt.sample_window(res, tokens, domains)
        if not (torch.equal(dom.cpu(), domains) and all(
                same_bits(torch, a.cpu(), b) for a, b in
                ((idx, ci), (w, cw), (valid, cv)))):
            fail(f"train: window {e}'s sample on the card differs from the "
                 "CPU's")
    l1, l32 = losses[0], probe.loss32
    if abs(l1 - l32) > TRAIN_LOSS_RTOL * abs(l32):
        fail(f"train: step 1's loss {l1} vs its f32 recomputation {l32} "
             f"(rtol {TRAIN_LOSS_RTOL})")
    adam = probe.adam
    if adam is None or max(adam["max_rel_err"].values()) > TRAIN_ADAM_RTOL:
        fail(f"train: AdamW slice at step {TRAIN_CHECKED_STEP}: {adam} "
             f"(rtol {TRAIN_ADAM_RTOL})")
    if not (all(math.isfinite(x) for x in losses) and len(losses)
            == TRAIN_STEPS and np.mean(losses[-5:]) < np.mean(losses[:5])):
        fail(f"train: losses do not decrease: {losses}")
    timed = sorted(probe.step_ms[1:])      # step 1 warms the allocator
    med = timed[len(timed) // 2]
    shapes = param.map_tree(lambda _p, s: torch.empty(
        s.shape, dtype=s.dtype, device="meta"), api.skeleton(cfg))
    need = train_need(cfg, shapes, run.batch, run.seq_len)
    acts, busy_ms, own, host_ops = probe.profile or (None,) * 4
    upd = sorted(probe.update_ms()[1:])
    upd_med = upd[len(upd) // 2]
    result = dict(
        arch=cfg.name, num_layers=cfg.num_layers, dtype=str(cfg.dtype),
        card=card(), steps=TRAIN_STEPS,
        batch=run.batch, seq_len=run.seq_len, window=window,
        domains=run.num_domains, losses=losses, loss32_step1=l32,
        step1_rel_err=abs(l1 - l32) / abs(l32), adam=adam,
        step_ms=probe.step_ms, step_median_ms=med, step_min_ms=timed[0],
        step_max_ms=timed[-1],
        tokens_per_s=run.batch * run.seq_len / (med / 1e3),
        window_tokens_per_s=window * run.seq_len / (med / 1e3),
        peak_bytes=peak, train_s=train_s, launches=launches,
        held=str(held.calls), need=need, bound_ms=need["bound_ms"],
        device_activities=acts, device_busy_ms=busy_ms,
        busy_share=busy_ms / med if traced else None, own_kernel_ms=own,
        host_ops=host_ops, update_ms=probe.update_ms(),
        update_median_ms=upd_med, lines=lines)
    log(f"[train] {cfg.name} at {'smoke' if smoke else 'full'} width in "
        f"{cfg.dtype}, {cfg.num_layers} layers: {need['params']:,} "
        f"parameters, {TRAIN_STEPS} steps "
        f"of {run.batch} x {run.seq_len} tokens sampled from windows of "
        f"{window} in {train_s:.2f} s; every fold held to its plain "
        f"version ({held.calls}); launches {launches}; sampled indices, "
        f"weights and validity of every window bit for bit a CPU run")
    log(f"[train] step 1's loss {l1:.6f} vs {l32:.6f} recomputed in f32 "
        f"before the optimizer state (rel {result['step1_rel_err']:.3g}, "
        f"rtol {TRAIN_LOSS_RTOL}); AdamW slice at step {adam['step']} "
        f"({leaf}[:{TRAIN_SLICE}]) rel err {adam['max_rel_err']} "
        f"(rtol {TRAIN_ADAM_RTOL}); loss {losses[0]:.4f} → "
        f"{losses[-1]:.4f} (first 5 mean {np.mean(losses[:5]):.4f}, last 5 "
        f"{np.mean(losses[-5:]):.4f})")
    log(f"[train] step ms median {med:.3f}, min {timed[0]:.3f}, max "
        f"{timed[-1]:.3f} (steps 2-{TRAIN_STEPS}"
        f"{f' but {TRAIN_PROFILED_STEP}' if traced else ''}; "
        f"step 1 {probe.step_ms[0]:.3f}); {result['tokens_per_s']:.1f} "
        f"trained tokens/s ({result['window_tokens_per_s']:.1f} window "
        f"tokens/s); bound {need['bound_ms']:.3f} ms = products "
        f"{need['ops_ms']:.3f} ms ({need['ops']:.4g} operations) + "
        f"optimizer {need['opt_bytes_ms']:.3f} ms ({need['opt_bytes']:.4g} "
        f"B); peak {peak / 2**30:.2f} GiB")
    log(f"[train] optimizer (clip + AdamW, device, events): median "
        f"{upd_med:.3f} ms, min {upd[0]:.3f}, max {upd[-1]:.3f} (bound "
        f"{need['opt_bytes_ms']:.3f} ms); forward and backward: the rest of "
        f"the step, {med - upd_med:.3f} ms at the median (bound "
        f"{need['ops_ms']:.3f} ms)")
    if traced:
        log(f"[train] step {TRAIN_PROFILED_STEP} traced: {acts:.0f} device "
            f"activities, {busy_ms:.3f} ms busy = {busy_ms / med:.3f} of "
            f"the median step, {host_ops:.0f} host torch ops; own kernels "
            f"{own}")
    else:
        log(f"[train] no step traced ({cfg.name} is in FAMILY_UNTRACED)")
    if family:
        result["seconds"] = time.perf_counter() - t_phase
        return result
    result["resume"] = train_resume(torch, dev)
    result["seconds"] = time.perf_counter() - t_phase
    log(f"[train] phase took {result['seconds']:.1f} s")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_train.json").write_text(
        json.dumps(result, indent=1, default=str))
    return result


def routed_experts(torch, server, state, toks) -> list:
    """Distinct experts each MoE layer routes the batch to in one decode
    step from ``state`` (the step is run once more, outside the timing;
    it writes the cache slot the next step would)."""
    from repro_torch.models import moe
    seen, real = [], moe.route

    def route(params, xg, cfg, key=None):
        out = real(params, xg, cfg, key)
        seen.append(int(torch.unique(out[0]).numel()))
        return out
    moe.route = route
    try:
        server.decode(state, toks)
    finally:
        moe.route = real
    return seen


def phase_families(torch, seed: int, dev) -> dict:
    """The families beyond dense, each at full width in bf16: served as
    phase serve serves phi4 (:func:`serve_model`; the xLSTM's prompt cut
    to ``FAMILY_SSM_PROMPT``, internvl2-76b's depth to
    ``FAMILY_SERVE_LAYERS``, encdec and vlm requests with their frames or
    patches), then trained by ``launch/train.train`` at its defaults
    (:func:`phase_train` with the family's config;
    ``FAMILY_TRAIN_LAYERS`` cuts the depth; encdec and vlm batches with
    their step's frames or patches, :func:`frontend_batches`). Every fold
    and stats call held to its plain version; the launches of the phase
    summed for the kernels' JSON line. ``chiprun_out/
    chip_smoke_families.json``."""
    from repro_torch import configs
    from repro_torch.models import api, param
    t_phase = time.perf_counter()
    result = dict(card=card(), archs={}, reduced={})
    launches = {"reservoir_fold": 0, "stratified_stats": 0}
    for arch in FAMILY_ARCHS:
        cfg = configs.get_config(arch)
        t0 = time.perf_counter()
        prompt = FAMILY_SSM_PROMPT if cfg.family == "ssm" else SERVE_PROMPT
        if prompt != SERVE_PROMPT:
            result["reduced"][f"{arch} prompt"] = (
                f"served on prompts of {prompt} of {SERVE_PROMPT} tokens: "
                "its prefill is a host-bound loop over time")
        served = FAMILY_SERVE_LAYERS.get(arch, cfg.num_layers)
        gate = FAMILY_GATE_LAYERS.get(arch)
        if served != cfg.num_layers:
            result["reduced"][f"{arch} serve"] = (
                f"served at {served} of {cfg.num_layers} layers (full "
                f"width; the first {served} of the full model's draws): "
                f"all would need "
                f"{param.param_bytes(api.skeleton(cfg)) / 1e9:.1f} GB of "
                f"{cfg.dtype} weights"
                + (f"; decode vs prefill gated on an f32 copy of its first "
                   f"{gate} layers (the training depth)" if gate else ""))
        serve = serve_model(torch, cfg.replace(num_layers=served), dev,
                            f"[families] {arch}",
                            ("embed.tokens", FAMILY_LEAF[arch]), prompt,
                            FAMILY_CACHE_STEPS, gate)
        depth, why = FAMILY_TRAIN_LAYERS.get(arch, (cfg.num_layers, ""))
        if depth != cfg.num_layers:
            result["reduced"][arch] = (
                f"trained at {depth} of {cfg.num_layers} layers (full "
                f"width): {why}")
        train = phase_train(torch, seed, dev,
                            cfg=cfg.replace(num_layers=depth))
        torch.cuda.empty_cache()
        for d in (serve["launches"], train["launches"]):
            for k in launches:
                launches[k] += d.get(k, 0)
        result["archs"][arch] = dict(serve=serve, train=train,
                                     seconds=time.perf_counter() - t0)
        log(f"[families] {arch} served and trained in "
            f"{result['archs'][arch]['seconds']:.1f} s")
    result.update(launches=launches,
                  seconds=time.perf_counter() - t_phase)
    log(f"[families] phase took {result['seconds']:.1f} s; reduced "
        f"{result['reduced']}; launches {launches}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_families.json").write_text(
        json.dumps(result, indent=1, default=str))
    return result


# ---------------------------------------------------------------------------
# Phase dryrun: the multi-pod dry-run tooling.
# ---------------------------------------------------------------------------

DRYRUN_ARCH = "phi4-mini-3.8b"
DRYRUN_SHAPES = ("decode_32k", "prefill_32k", "train_4k")


def _shard_bytes(spec, shape, sizes, itemsize) -> int:
    n = itemsize
    for entry, d in zip(spec, shape):
        axes = entry if isinstance(entry, tuple) else (entry,)
        n *= d // math.prod(sizes[a] for a in axes if a is not None)
    return n


def argument_bytes_from_specs(arch: str, shape: str) -> int:
    """One device's argument bytes of a (16, 16) cell, from the specs
    alone: each param's ``param_specs`` entry (and, for train_4k, the f32
    master and moments at their ``zero_pspec``, the step), each batch
    input's leading dim over ``batch``, each decode-state leaf as
    ``launch/specs`` places it (5-D caches by the cache's logical axes,
    other leaves on their first dim equal to the batch)."""
    from repro_torch import configs
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import api, param
    from repro_torch.models.kvcache import CACHE_LOGICAL
    from repro_torch.launch import specs
    from repro_torch.train import optimizer as opt
    cfg = configs.get_config(arch)
    _, batch = configs.SHAPES[shape]
    sizes = {"data": 16, "model": 16}
    mesh = shd.AbstractMesh(sizes)
    skel = api.skeleton(cfg)
    total = 0
    with shd.use_mesh(None, shd.build_rules(cfg, mesh)):
        pspecs = dict(param.leaves(param.param_specs(skel, mesh)))
        for path, s in param.leaves(skel):
            total += _shard_bytes(pspecs[path], s.shape, sizes,
                                  s.dtype.itemsize)
            if shape == "train_4k":
                z = opt.zero_pspec(pspecs[path], s.shape, mesh,
                                   ("pod", "data"))
                total += 3 * _shard_bytes(z, s.shape, sizes, 4)
        total += 4 if shape == "train_4k" else 0          # the step
        inputs = specs.input_specs(arch, shape, cfg)
        leaves = [t for k, v in inputs.items() if k != "state"
                  for t in [v]]
        for t in leaves:
            spec = shd.resolve_spec(("batch",) + (None,) * (t.dim() - 1),
                                    t.shape, mesh)
            total += _shard_bytes(spec, t.shape, sizes, t.element_size())
        st = inputs.get("state")
        for t in ((st.k, st.v, st.position) if st is not None else ()):
            if t.dim() == 5:
                spec = shd.resolve_spec(CACHE_LOGICAL, t.shape, mesh)
            else:
                spec = tuple(shd.resolve_spec(("batch",), (d,), mesh)[0]
                             if d == batch and i == 0 else None
                             for i, d in enumerate(t.shape))
            total += _shard_bytes(spec, t.shape, sizes, t.element_size())
    return total


def dryrun_records() -> None:
    """Phase dryrun (a), run in its own process: the (16, 16) records of
    ``DRYRUN_SHAPES``, each beside its argument bytes from the specs,
    printed as one JSON line."""
    from repro_torch.launch import dryrun
    out = []
    for shape in DRYRUN_SHAPES:
        rec = dryrun.run_cell(DRYRUN_ARCH, shape, verbose=False)
        rec["argument_bytes_from_specs"] = argument_bytes_from_specs(
            DRYRUN_ARCH, shape)
        out.append(rec)
    print(json.dumps(out))


def _card_args(torch, prog, seq: int, vocab: int, dev, gen):
    """Rank 0's shards of seeded inputs of a cell's program on the card:
    params and master normal x 0.02, moments, caches and the step zeros,
    a decode position at ``seq``, tokens uniform over the vocab, weights
    one."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.train.optimizer import TrainState

    def maker(kind):
        def make(a, sh):
            shape = shd.local_shape(sh.spec, tuple(a.shape), sh.mesh)
            if kind == "normal" and a.dtype.is_floating_point:
                t = (torch.randn(shape, generator=gen, device=dev) * 0.02
                     ).to(a.dtype)
            elif a.dtype.is_floating_point:
                t = torch.full(shape, 1.0 if kind == "batch" else 0.0,
                               dtype=a.dtype, device=dev)
            elif a.dim() == 0:
                t = torch.full(shape, seq if kind == "state" else 0,
                               dtype=a.dtype, device=dev)
            else:
                t = torch.randint(0, vocab, shape, generator=gen,
                                  device=dev, dtype=a.dtype)
            return shd.from_local(t, tuple(a.shape), sh.mesh,
                                  sh.placements)
        return lambda tree, shs: dryrun.tree_map(make, tree, shs)

    out = []
    for i, (arg, shs) in enumerate(zip(prog.args, prog.in_shardings)):
        if isinstance(arg, TrainState):
            out.append(TrainState(
                params=maker("normal")(arg.params, shs.params),
                master=maker("normal")(arg.master, shs.master),
                mu=maker("zeros")(arg.mu, shs.mu),
                nu=maker("zeros")(arg.nu, shs.nu),
                step=maker("zeros")(arg.step, shs.step)))
        else:
            kind = ("normal" if i == 0 else
                    "state" if prog.mode == "decode" and i == 1
                    else "batch")
            out.append(maker(kind)(arg, shs))
    return tuple(out)


def _busy_ms(prof) -> float:
    """Union of the device intervals of a profile, ms."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def card_program(torch, shape: str, dev, seed: int) -> dict:
    """Phase dryrun (b): rank 0 of the (16, 16) fake group runs one cell's
    program on the card. Run 1 under the dry-run's counter (local ops,
    FLOPs, bytes, collectives; each collective's output filled as if every
    other rank held zeros, since the fake group writes none), its
    every output checked finite and of its shape; run 2 timed on the host
    clock, run 3 profiled (their gathers' outputs left unwritten: they
    are timed, not checked)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.roofline import roofline_terms
    cfg = configs.get_config(DRYRUN_ARCH)
    seq, batch = configs.SHAPES[shape]
    tag = f"[dryrun] (b) {shape}"
    with mesh_lib.fake_group(256):
        mesh = mesh_lib.make_production_mesh(device_type=dev.type)
        prog = specs.build_program(DRYRUN_ARCH, shape, mesh,
                                   cfg_override=cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        args = _card_args(torch, prog, seq, cfg.vocab_size, dev, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, counter, counted_s = dryrun.run_program(prog, args, cfg,
                                                     loopback=True)
        torch.cuda.synchronize()
        bad = []
        for t in dryrun.tree_leaves(out):
            loc = t.to_local() if isinstance(t, shd.DTensor) else t
            if isinstance(t, shd.DTensor) and tuple(loc.shape) != \
                    shd.local_shape_and_offset(t)[0]:
                bad.append(f"shape {tuple(loc.shape)}")
            if loc.is_floating_point() and not bool(
                    torch.isfinite(loc).all()):
                bad.append(f"non-finite {tuple(t.shape)}")
        del out
        t0 = time.perf_counter()
        out = _run_plain(prog, args, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        del out
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = _run_plain(prog, args, cfg)
            torch.cuda.synchronize()
        busy = _busy_ms(prof)
        peak = torch.cuda.max_memory_allocated() - base
        rec = {"flops_per_device": counter.flops,
               "bytes_per_device": counter.bytes,
               "collective_bytes_per_device": sum(
                   counter.coll_bytes.values()),
               "model_flops_per_device": 0.0}
        terms = roofline_terms(rec, H100_SXM5)
        del out, args
        torch.cuda.empty_cache()
    res = dict(shape=shape, mode=prog.mode, host_torch_ops=counter.ops,
               flops=counter.flops, bytes=counter.bytes,
               collective_counts=counter.coll_counts,
               collective_bytes=rec["collective_bytes_per_device"],
               counted_run_s=counted_s, wall_ms=wall, busy_ms=busy,
               peak_bytes=peak, compute_ms=terms["compute_sec"] * 1e3,
               memory_ms=terms["memory_sec"] * 1e3, bad=bad)
    log(f"{tag}: {counter.ops:,} local torch ops, {counter.flops:.4g} "
        f"FLOP, {counter.bytes:.4g} B, collectives {counter.coll_counts} "
        f"({res['collective_bytes']:,} B, not moved: fake group); wall "
        f"{wall:.1f} ms, device busy {busy:.1f} ms, peak "
        f"{peak / 2**30:.2f} GiB; roofline at {H100_SXM5.name}: compute "
        f"{res['compute_ms']:.2f} ms, memory {res['memory_ms']:.2f} ms")
    if bad:
        fail(f"{tag}: outputs {bad}")
    return res


def _run_plain(prog, args, cfg):
    """``prog.fn(*args)`` under the program's mesh and rules, uncounted."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    import torch
    mesh = dryrun.tree_leaves_shardings(prog.in_shardings)[0].mesh
    grad = contextlib.nullcontext() if prog.mode == "train" \
        else torch.no_grad()
    with shd.use_mesh(mesh, shd.build_rules(cfg, mesh)), \
            implicit_replication(), grad:
        return prog.fn(*args)


def compression_bits(torch, dev, seed: int) -> dict:
    """Phase dryrun (c): the compression calls on a one-rank ``pod ×
    data`` mesh with NCCL on the card and with gloo on the CPU (one group
    of backend ``cpu:gloo,cuda:nccl``, destroyed after), bit for bit."""
    import tempfile
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.distributed import compression as comp
    gen = torch.Generator().manual_seed(seed)
    tree = {"w": torch.randn(1024, 1024, generator=gen) * 3.0,
            "b": [torch.randn(4096, generator=gen) * 1e-3,
                  torch.randn(256, generator=gen).to(torch.bfloat16)]}
    rendezvous = tempfile.TemporaryDirectory()
    tdist.init_process_group("cpu:gloo,cuda:nccl",
                             init_method=f"file://{rendezvous.name}/pg",
                             world_size=1, rank=0)
    try:
        meshes = {k: DeviceMesh(d, torch.arange(1).view(1, 1),
                                mesh_dim_names=("pod", "data"))
                  for k, d in (("cpu", "cpu"), ("card", dev.type))}
        res = {}
        for name, fn in (
                ("psum_bf16", lambda t, m: comp.psum_bf16(
                    t, m.get_group("pod"))),
                ("psum_int8", lambda t, m: comp.psum_int8(
                    t, m.get_group("pod"))),
                ("hier_int8", lambda t, m: comp.hierarchical_grad_sync(
                    t, m, cross_pod="int8")),
                ("hier_bf16", lambda t, m: comp.hierarchical_grad_sync(
                    t, m, cross_pod="bf16")),
                ("hier_full", lambda t, m: comp.hierarchical_grad_sync(
                    t, m, cross_pod="none"))):
            on_cpu = fn(tree, meshes["cpu"])
            on_card = fn(_to(tree, dev), meshes["card"])
            torch.cuda.synchronize()
            same = all(torch.equal(a, b.cpu()) for a, b in zip(
                _flat(on_cpu), _flat(on_card)))
            res[name] = same
            log(f"[dryrun] (c) {name}: NCCL on the card "
                f"{'bit for bit' if same else 'DIFFERS from'} gloo on the "
                f"CPU ({len(_flat(on_cpu))} leaves)")
            if not same:
                fail(f"[dryrun] (c) {name} differs between NCCL and gloo")
        res["nccl_version"] = ".".join(map(str, torch.cuda.nccl.version()))
    finally:
        tdist.destroy_process_group()
        rendezvous.cleanup()
    return res


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat(v)]
    return [tree]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev)


def phase_dryrun(torch, seed: int, dev) -> dict:
    """Phase dryrun (a)-(c); ``chiprun_out/chip_smoke_dryrun.json``."""
    t_phase = time.perf_counter()
    result = dict(card=card(), arch=DRYRUN_ARCH)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    # (b)'s decode and train first, alone: the host's speed sets their
    # wall time. (a) traces on the host beside the device-bound prefill
    # (busy 0.99 of its wall) and (c).
    programs = {s: card_program(torch, s, dev, seed)
                for s in ("decode_32k", "train_4k")}
    host = subprocess.Popen(
        [sys.executable, "-c",
         "import chip_smoke as cs; cs.dryrun_records()"],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        for s in DRYRUN_SHAPES:
            if s not in programs:
                programs[s] = card_program(torch, s, dev, seed)
        result["compression"] = compression_bits(torch, dev, seed)
        stdout, stderr = host.communicate(timeout=DRYRUN_HOST_TIMEOUT_S)
    finally:
        if host.poll() is None:
            host.kill()
            host.wait()
    if host.returncode != 0:
        fail(f"[dryrun] (a) run_cell exited {host.returncode}: "
             f"{stderr[-2000:]}")
    recs = json.loads(stdout.strip().splitlines()[-1])
    for rec in recs:
        args = rec["memory"]["argument_bytes"]
        log(f"[dryrun] (a) {rec['arch']} x {rec['shape']} x {rec['mesh']}: "
            f"{rec['status']} (trace {rec['trace_sec']} s, "
            f"{rec['local_ops']:,} local ops), args {args:,} B (from the "
            f"specs {rec['argument_bytes_from_specs']:,}), out "
            f"{rec['memory']['output_bytes']:,} B, temp "
            f"{rec['memory']['temp_bytes']:,} B, {rec['flops_per_device']:.4g}"
            f" FLOP/dev, collectives {rec['collective_counts']}")
        if rec["status"] != "OK" or args != rec["argument_bytes_from_specs"]:
            fail(f"[dryrun] (a) {rec['shape']}: {rec['status']}, argument "
                 f"bytes {args} != {rec['argument_bytes_from_specs']}")
    result["records"] = recs
    result["programs"] = {s: programs[s] for s in DRYRUN_SHAPES}
    result["reduced"] = []
    result["seconds"] = time.perf_counter() - t_phase
    log(f"[dryrun] phase took {result['seconds']:.1f} s")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_dryrun.json").write_text(
        json.dumps(result, indent=1, default=str))
    return result


PAYLOAD_TREES = ("two", "mixed10")  # phase payloads (a)
#: Phase payloads (b): each example and the prefix of its estimate lines.
EXAMPLES = (("quickstart", "window "), ("network_traffic", "  "),
            ("taxi_rides", "windowed overall"),
            ("streaming_runtime", "final windowed bytes"),
            ("observability", "avg: hw95"), ("serve_telemetry", "window "))


def payload_tree(torch, gen, name: str, lead: tuple) -> dict:
    """One of phase payloads' trees, each leaf ``[*lead, *item]``:
    ``"two"`` ``{"val": f32, "key": i32}``; ``"mixed10"`` ten leaves,
    ``f32 [3]``, bf16, bool, i64 and six f32 scalars (two write groups
    of the kernel)."""
    dev = gen.device

    def f32(*item):
        return torch.randn(lead + item, generator=gen, device=dev) * 100.0

    def ints(bound, dtype):
        return torch.randint(-bound, bound, lead, generator=gen, device=dev,
                             dtype=dtype)
    if name == "two":
        return {"val": f32(), "key": ints(2 ** 31 - 1, torch.int32)}
    tree = {"vec": f32(3), "half": f32().to(torch.bfloat16),
            "flag": torch.rand(lead, generator=gen, device=dev) < 0.5,
            "id": ints(2 ** 40, torch.int64)}
    tree.update({f"f{i}": f32() for i in range(6)})
    return tree


def row_bytes(tree: dict) -> int:
    """Bytes of one item's row summed over a tree's ``[M, ...]`` leaves."""
    return sum(t[0].numel() * t.element_size() for t in tree.values())


def payloads_fold(torch, dev) -> dict:
    """(a) Kernel 1 on payload trees at the main path's chunk: the
    replacement chunk of ``fold_timing`` (the same draws) and a filling
    chunk, each folding both trees of :data:`PAYLOAD_TREES` into fresh
    random rings, every leaf and the counts bit for bit the plain
    version's, the scratch clean after every call; then the device and
    event times of the scalar call and of both trees in turns, their
    launches per call and bounds."""
    from repro_torch.kernels import ref, reservoir
    gen = torch.Generator(device=dev)
    gen.manual_seed(TIMING_SEED)
    cells = K * S
    i32 = dict(dtype=torch.int32, device=dev)
    inp = fold_inputs(
        torch, gen, M, cells,
        torch.randint(2_000_000, 3_000_000, (cells,), generator=gen, **i32),
        torch.randint(1, N_MAX + 1, (cells,), generator=gen, **i32))
    ring = torch.randn((cells, N_MAX), generator=gen, device=dev)
    trees = {n: (payload_tree(torch, gen, n, (M,)),
                 payload_tree(torch, gen, n, (cells, N_MAX)))
             for n in PAYLOAD_TREES}
    filling = dict(inp, counts=torch.zeros(cells, **i32),
                   capacity=torch.full((cells,), N_MAX, **i32))
    for case, args in (("replacement", inp), ("filling", filling)):
        for name, (pay, start) in trees.items():
            vk, vp = clone_tree(start), clone_tree(start)
            args = dict(args, payload=pay)
            ck = reservoir.reservoir_fold(values=vk, **args)
            cp = ref.reservoir_fold(values=vp, **args)
            bad = [k for k in start if not same_bits(torch, vk[k], vp[k])]
            if not torch.equal(ck, cp):
                bad.append("counts")
            written = {k: int((vk[k] != start[k]).reshape(cells * N_MAX, -1)
                              .any(dim=1).sum()) for k in start}
            clean = workspace_clean(torch)
            log(f"[payloads] (a) {name} ({len(start)} leaves), {case}: "
                f"bitwise={not bad}, cells written per leaf "
                f"{min(written.values())}-{max(written.values())}, "
                f"scratch clean={clean}")
            if bad or not clean or not all(written.values()):
                fail(f"payloads (a): the fold kernel on {name}, {case}, "
                     f"differs from its plain version in {bad}, wrote "
                     f"{written} cells or left its scratch dirty ({clean})")
            del vk, vp

    need = fold_need(torch, inp)
    n_ops = 12 * M
    calls = {"scalar": lambda: reservoir.reservoir_fold(values=ring, **inp)}
    nbytes = {"scalar": need["bytes"]}
    for name, (pay, start) in trees.items():
        calls[name] = (lambda p=pay, v=start: reservoir.reservoir_fold(
            values=v, **dict(inp, payload=p)))
        nbytes[name] = (need["bytes"] - 8 * need["won"]
                        + 2 * need["won"] * row_bytes(pay))
    order = ("scalar",) + PAYLOAD_TREES + PAYLOAD_TREES[::-1] + ("scalar",)
    device = {n: [] for n in calls}
    event = {n: [] for n in calls}
    kernels = {}
    for n in order:
        prof = device_profile(calls[n], torch)
        device[n].append(sum(v[0] for v in prof.values()))
        event[n].append(time_ms(calls[n], torch))
        kernels[n] = log_launches(f"payloads (a) {n}", prof)
    want = {"scalar": (2, 0), "two": (2, 0), "mixed10": (3, 0)}
    if kernels != want:
        fail(f"payloads (a): kernels and memsets per call {kernels}, "
             f"expected {want}")
    bound = {n: max(b / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S) * 1e3
             for n, b in nbytes.items()}
    for n in calls:
        log(f"[payloads] (a) {n}: device ms in turns "
            f"{[round(x, 5) for x in device[n]]}, events "
            f"{[round(x, 4) for x in event[n]]}, bound {bound[n]:.4f} ms "
            f"({nbytes[n]} B: {need['won']} cells won)")
    return dict(device_ms=device, event_ms=event, bound_ms=bound,
                bytes=nbytes, kernels_per_call=kernels, won=need["won"],
                order=list(order))


def run_example(torch, name: str, prefix: str) -> dict:
    """One ``examples/torch_<name>.py`` at its default size on the card,
    in this process: its wall time and its last estimate line; every
    estimate line finite. Its output goes to
    ``chiprun_out/chip_smoke_examples.txt``."""
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        mod.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    with open(ROOT / "chiprun_out" / "chip_smoke_examples.txt", "a") as f:
        f.write(f"==== examples/torch_{name}.py ({wall:.3f} s)\n{out}\n")
    lines = [l for l in out.splitlines() if l.startswith(prefix)]
    bad = [l for l in lines if re.search(r"\b(nan|inf)\b", l, re.I)]
    if not lines or bad:
        fail(f"payloads (b): {name} printed no estimate line or a "
             f"non-finite one: {bad}")
    log(f"[payloads] (b) {name}: {wall:.3f} s; last estimate: "
        f"{lines[-1].strip()}")
    return dict(wall_s=wall, last=lines[-1].strip())


def phase_payloads(torch, dev) -> dict:
    """(a) :func:`payloads_fold`; (b) the six examples of the port at
    their default sizes on the card, with the kernels' counts set to 0
    just before and read just after; ``chiprun_out/
    chip_smoke_payloads.json``."""
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    fold = payloads_fold(torch, dev)
    (ROOT / "chiprun_out" / "chip_smoke_examples.txt").write_text("")
    ops.reset_launch_counts()
    examples = {name: run_example(torch, name, prefix)
                for name, prefix in EXAMPLES}
    launches = ops.launch_counts()
    log(f"[payloads] (b) launches of the six examples: {launches}")
    if not (launches["reservoir_fold"] and launches["stratified_stats"]):
        fail(f"payloads (b): the examples did not go through the fold and "
             f"stats kernels: {launches}")
    out = dict(fold=fold, examples=examples, launches=launches,
               phase_s=time.perf_counter() - t0, card=card())
    (ROOT / "chiprun_out" / "chip_smoke_payloads.json").write_text(
        json.dumps(out, indent=1))
    log(f"[payloads] phase {out['phase_s']:.1f} s")
    return out


# Phase large_keys: the four kernels past the key counts a block's shared
# memory holds (each takes its large-key form there), at a threshold plus
# one, at a sliding-window deployment (K = 60 one-second intervals of a
# one-minute window, S = 64 sub-streams, W = 4 shards on the vmap
# placement, N_max = 512 a shard) and at a per-key stress (S = 65,536,
# K = 4, N_max = 64). The stats and the histogram, whose emission calls
# take a [G, N] view, also through their row form.
#: fold: (case, cells, N_max, items)
LK_FOLD = (("past", 1_025, 512, M), ("sliding", 15_360, 512, M),
           ("stress", 262_144, 64, 4_194_304))
#: one-shot: (case, K, S, N_max, items)
LK_ONE_SHOT = (("past", 5, 205, 512, M),
               ("sliding", 60, 64, 512, M // W_SHARDS),
               ("stress", 4, 65_536, 64, 4_194_304))
#: stats: (case, rows, slots a row), the emission's [rows x slots] view
LK_STATS = (("past", 513, 1_024), ("sliding", 15_360, 512),
            ("stress", 262_144, 64))
#: histogram: (case, rows, bins, slots a row)
LK_WHIST = (("past", 97, 33, 1_024), ("sliding", 15_360, 32, 512),
            ("stress", 262_144, 32, 64))
#: the sliding deployment's executor: a one-minute window sliding every
#: second over 64 sub-streams on 4 shards, N_max = 512 a shard; chunks of
#: LK_M_SHARD items a shard, a quarter second each, an emission every
#: LK_EMIT chunks, LK_CHUNKS chunks (two emissions).
LK_EXEC = dict(num_intervals=60, num_strata=64, num_shards=4,
               capacity=2_048, max_capacity=2_048, interval_span=1.0,
               allowed_lateness=0.5)
LK_M_SHARD, LK_EMIT, LK_CHUNKS = 8_192, 2, 4
#: launches per call of each kernel's small-key form
SMALL_FORM_LAUNCHES = {"fold": 2, "one_shot": 3, "stats": 1, "whist": 1}
#: launches per call of the fold's and the one-shot's parted form up to
#: 2**20 cells (one partition pass), one payload leaf
PARTED_LAUNCHES = {"fold": 4, "one_shot": 5}
#: the one-shot batched over shards (phase one_shot): (case, W, K, S,
#: N_max, items a shard): the paper's 4 workers (phase sharded's ring and
#: chunks, the small form) and the sliding deployment (LK_EXEC, the parted
#: form) at its executor's chunk and at the paper's
SHARD_ONE_SHOT = (("paper", W_SHARDS, K, S, N_SHARD, M_SHARD),
                  ("sliding", 4, 60, 64, 512, LK_M_SHARD),
                  ("sliding_131072", 4, 60, 64, 512, M_SHARD))
#: the shards' states of the batched checks: W -> each shard's kind
#: (:func:`shard_case`)
SHARD_KINDS = {1: ("crossing",), 2: ("late", "crossing"),
               4: ("steady", "late", "crossing", "all_masked")}
#: the fold batched over W·K folds (phase fold's ``fold_batches``): (case,
#: W, K, S, N_max, items a shard, payload leaves): one fold, one shard's
#: two slots and the paper's 4 workers' masked path (phase sharded's ring
#: and chunks), the sliding deployment's 4 x 60 slots at its executor's
#: chunk, each small-form ring also past the form's 1,025 strata
FOLD_BATCHES = (("one", 1, 1, S, N_SHARD, M_SHARD, 1),
                ("two", 1, 2, S, N_SHARD, M_SHARD, 1),
                ("paper", W_SHARDS, K, S, N_SHARD, M_SHARD, 1),
                ("paper", W_SHARDS, K, S, N_SHARD, M_SHARD, 2),
                ("sliding", 4, 60, 64, 512, LK_M_SHARD, 1),
                ("sliding", 4, 60, 64, 512, LK_M_SHARD, 2),
                ("paper_parted", W_SHARDS, K, 1_025, 512, M_SHARD, 1),
                ("paper_parted", W_SHARDS, K, 1_025, 512, M_SHARD, 2),
                ("sliding_parted", 4, 60, 1_025, 8, LK_M_SHARD, 1))
#: the batched fold's timed cases (``fold_batch_turns``): the paper's
#: masked path and the sliding deployment's
FOLD_BATCH_TURNS = (FOLD_BATCHES[2], FOLD_BATCHES[4])
#: the states of a batched fold call's folds, fold ``b`` in
#: ``FOLD_KINDS[b % 3]``
FOLD_KINDS = ("replacement", "filling", "all_masked")


def lk_timed(torch, tag, fn, need_bytes, reps: int = 5) -> dict:
    """Times one call ``fn``: CUDA events around back-to-back calls, the
    profiler's kernels and memsets per call (a Memcpy of a state restore
    shown apart), the bound from the bytes the function needs. ``whole``:
    every name's count a whole multiple of the calls traced (a window the
    tracer did not cut short); ``event_ms``: each name's mean device ms
    per event of the window kept."""
    ev = time_ms(fn, torch, reps=10, warm=2)
    prof = device_profile(fn, torch, reps=reps)
    restore = {k: prof.pop(k)[0] for k in list(prof) if "Memcpy" in k}
    kernels, memsets = log_launches(tag, prof)
    return dict(device_ms=sum(v[0] for v in prof.values()), events_ms=ev,
                kernels=kernels, memsets=memsets,
                split={k: v[0] for k, v in prof.items()}, restore=restore,
                whole=bool(prof) and all(float(n).is_integer()
                                         for _, n in prof.values()),
                event_ms={k: v[0] / v[1] for k, v in prof.items()},
                bound_ms=need_bytes / HBM_BYTES_PER_S * 1e3,
                bytes=need_bytes)


def row_timed(torch, tag, fn, need_bytes, owner) -> dict:
    """:func:`lk_timed` of a row-form call ``fn`` of the wrapper ``owner``
    over windows of 40 to 640 calls: its launches per call from the
    wrapper's own count (``owner.forms["row"]``); the profiler must show
    no memset and no kernel but the row kernel. A window the tracer cut
    short (late in the script it can drop most events of a 4 us kernel,
    window after window) gives the device ms as the mean of the events it
    kept times the launches per call."""
    before = owner.forms["row"]
    fn()
    launches = owner.forms["row"] - before
    t = lk_timed(torch, tag, fn, need_bytes, reps=40)
    kernels = [k for k in t["split"] if k != "memset"]
    if not kernels or t["memsets"] or any("rows_kernel" not in k
                                          for k in kernels):
        fail(f"{tag}: the row form's profile shows {t['split']}")
    if not t["whole"]:
        t["device_ms"] = launches * sum(t["event_ms"][k] for k in kernels)
        log(f"[{tag}] the traced windows were cut short: device "
            f"{t['device_ms']:.4f} ms from the mean of the "
            f"{kernels[0]} events kept, {launches} launch per call")
    t["kernels"] = t["kernels"] if t["whole"] else float(launches)
    return t


def large_row(torch, kernel, case, fn, need_bytes, owner, **shape) -> dict:
    """Times one parted-form call ``fn`` of the wrapper ``owner``
    (:func:`lk_timed`), its profiler split per launch beside the device
    ms, kernels per call and bound; fails unless the call ran the parted
    form (``owner.forms``) in PARTED_LAUNCHES kernels and no memset."""
    tag = f"large_keys {kernel} {case}"
    before = dict(owner.forms)
    fn()
    ran = {f: owner.forms[f] - before[f] for f in before}
    t = lk_timed(torch, tag, fn, need_bytes)
    log_split(tag, t["split"], t["events_ms"])
    log(f"[large_keys] {kernel} {case} {shape}: device {t['device_ms']:.4f} "
        f"ms ({t['kernels']:g} kernels, {t['memsets']:g} memsets per call), "
        f"events {t['events_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by "
        f"bytes ({need_bytes} B), forms {ran}; {card()}")
    if ran != {"small": 0, "parted": 1}:
        fail(f"{tag}: the call ran the forms {ran}, not the parted form")
    if t["whole"] and (t["kernels"], t["memsets"]) != (
            PARTED_LAUNCHES[kernel], 0):
        fail(f"{tag}: {t['kernels']:g} kernels and {t['memsets']:g} "
             f"memsets per call, not {PARTED_LAUNCHES[kernel]} and none")
    return dict(t, kernel=kernel, case=case, shape=shape, forms=ran)


def large_fold(torch, gen, case, cells, n_max, m) -> dict:
    from repro_torch.kernels import ref, reservoir
    dev = gen.device
    i32 = dict(dtype=torch.int32, device=dev)
    inp = fold_inputs(torch, gen, m, cells,
                      torch.randint(n_max, 4 * n_max, (cells,),
                                    generator=gen, **i32),
                      torch.randint(1, n_max + 1, (cells,), generator=gen,
                                    **i32))
    ring = torch.randn((cells, n_max), generator=gen, device=dev)
    vk, vp, v2 = ring.clone(), ring.clone(), ring.clone()
    ck = reservoir.reservoir_fold(values=vk, **inp)
    same = (torch.equal(ck, ref.reservoir_fold(values=vp, **inp))
            and same_bits(torch, vk, vp))
    clean = workspace_clean(torch)
    twice = (torch.equal(reservoir.reservoir_fold(values=v2, **inp), ck)
             and same_bits(torch, v2, vk))
    clean = clean and workspace_clean(torch)
    log(f"[large_keys] fold {case}: bitwise={same} same bits twice={twice} "
        f"scratch clean={clean}")
    if not (same and twice and clean):
        fail(f"large_keys fold {case}: differs from its plain version or "
             "from itself, or left its scratch dirty")
    need = fold_need(torch, inp, n_max)
    return large_row(torch, "fold", case,
                     lambda: reservoir.reservoir_fold(values=vk, **inp),
                     need["bytes"], reservoir.reservoir_fold, cells=cells,
                     n_max=n_max, items=m)


def large_one_shot(torch, gen, case, k, s, n_max, m) -> dict:
    """The one-shot at a replacement chunk in which every masked-in item
    is live (as ``one_shot_timing``: the frontier at 9.9 s, the items in
    [9.45, 9.85) s), the counts put back before each timed call."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.one_shot import one_shot_ingest
    items, state = shard_case(torch, gen, "steady", k, s, n_max, m)
    sk, sp, s2 = ({n: v.clone() for n, v in state.items()}
                  for _ in range(3))
    one_shot_ingest(**items, **ONE_SHOT_KW, **sk)
    ref.one_shot_ingest(**items, **ONE_SHOT_KW, **sp)
    same = all(same_bits(torch, sk[n], sp[n]) for n in state)
    clean = workspace_clean(torch)
    one_shot_ingest(**items, **ONE_SHOT_KW, **s2)
    twice = all(same_bits(torch, s2[n], sk[n]) for n in state)
    clean = clean and workspace_clean(torch)
    log(f"[large_keys] one_shot {case}: bitwise={same} same bits twice="
        f"{twice} scratch clean={clean}")
    if not (same and twice and clean):
        fail(f"large_keys one_shot {case}: differs from its plain version "
             "or from itself, or left its scratch dirty")
    need = one_shot_need(torch, items, state)
    counts0 = state["counts"].clone()

    def call():
        state["counts"].copy_(counts0)
        one_shot_ingest(**items, **ONE_SHOT_KW, **state)
    return large_row(torch, "one_shot", case, call, need["bytes"],
                     one_shot_ingest, k=k, s=s, n_max=n_max, items=m)


def rows_view(torch, gen, g, n):
    """The emission's ``[g x n]`` slot view flattened: Gaussian values,
    row ids as keys, a per-row sample size as the slot mask."""
    dev = gen.device
    x = (100.0 + 10.0 * torch.randn((g, n), generator=gen, device=dev)
         ).reshape(-1)
    taken = torch.randint(n // 2, n + 1, (g,), generator=gen, device=dev)
    mask = (torch.arange(n, device=dev)[None, :] < taken[:, None]
            ).reshape(-1)
    sid = torch.arange(g, dtype=torch.int32, device=dev).repeat_interleave(n)
    return x, sid, mask


#: launches per call of the row forms
ROW_FORM_LAUNCHES = 1
#: the per-key stress's sub-streams and items: the flat callers of the
#: stats (``query.exact_stats``, STS's ``baselines.sample_stats``) there
LK_BASELINE_S, LK_BASELINE_M = 65_536, 4_194_304


def parted_launches(kernel, keys, m) -> int:
    """Launches per call of the stats' or the histogram's parted form over
    ``keys`` keys and ``m`` items: the count, the plan's partition passes
    and the sums."""
    from repro_torch.kernels import _workspace, stratified_stats, weighted_hist
    lo = (stratified_stats.MAX_STRATA if kernel == "stats"
          else weighted_hist.PARTED_LO_KEYS)
    return 2 + _workspace.parted_plan(keys, m, lo).passes


def reduce_owner(kernel):
    from repro_torch.kernels import stratified_stats, weighted_hist
    return (stratified_stats.stratified_stats if kernel == "stats"
            else weighted_hist.weighted_hist)


def parted_timed(torch, kernel, tag, fn, need_bytes, launches) -> dict:
    """:func:`lk_timed` of a parted-form call ``fn`` of the stats or the
    histogram, its profiler split per launch logged; fails unless the
    call ran the parted form (the wrapper's ``forms``), in ``launches``
    kernels and no memset."""
    owner = reduce_owner(kernel)
    before = dict(owner.forms)
    fn()
    ran = {f: owner.forms[f] - before[f] for f in before}
    t = lk_timed(torch, tag, fn, need_bytes)
    log_split(tag, t["split"], t["events_ms"])
    if ran != {"small": 0, "row": 0, "parted": 1}:
        fail(f"{tag}: the call ran the forms {ran}, not the parted form")
    if t["whole"] and (t["kernels"], t["memsets"]) != (launches, 0):
        fail(f"{tag}: {t['kernels']:g} kernels and {t['memsets']:g} "
             f"memsets per call, not the plan's {launches} and none")
    return t


def row_turns(torch, kernel, case, row_fn, parted_fn, row_bytes,
              parted_bytes, library_fn, launches, **shape) -> dict:
    """The row form and the parted form (the flat call with row ids) of
    one case in turns (R P P R): each turn's device ms, kernels per call
    and bound; one row-form call is one kernel and no memset
    (:func:`row_timed`), a parted call the plan's ``launches`` and no
    memset (:func:`parted_timed`); the library call's events ms at the
    same size."""
    owner = reduce_owner(kernel)
    turns = []
    for form in ("row", "parted", "parted", "row"):
        tag = f"large_keys {kernel} {case} {form}"
        t = (row_timed(torch, tag, row_fn, row_bytes, owner)
             if form == "row" else parted_timed(torch, kernel, tag,
                                                parted_fn, parted_bytes,
                                                launches))
        turns.append(dict(t, form=form))
        if form == "row" and (t["kernels"], t["memsets"]) != (
                ROW_FORM_LAUNCHES, 0):
            fail(f"large_keys {kernel} {case}: the row form ran "
                 f"{t['kernels']:g} kernels, {t['memsets']:g} memsets")
    library_ms = time_ms(library_fn, torch, reps=10, warm=2)
    row = [t for t in turns if t["form"] == "row"]
    par = [t for t in turns if t["form"] == "parted"]
    log(f"[large_keys] {kernel} {case} {shape} in turns R P P R: device "
        + ", ".join(f"{t['form']} {t['device_ms']:.4f}" for t in turns)
        + f" ms; kernels per call row {row[0]['kernels']:g}, parted "
        f"{par[0]['kernels']:g}; bound row {row[0]['bound_ms']:.4f} ms "
        f"({row[0]['bytes']} B), parted {par[0]['bound_ms']:.4f} ms "
        f"({par[0]['bytes']} B), by bytes; library {library_ms:.4f} ms; "
        f"{card()}")
    return dict(kernel=kernel, case=case, shape=shape, turns=turns,
                library_ms=library_ms,
                device_ms=min(t["device_ms"] for t in row),
                parted_device_ms=min(t["device_ms"] for t in par),
                kernels=row[0]["kernels"], memsets=row[0]["memsets"],
                bound_ms=row[0]["bound_ms"], bytes=row[0]["bytes"],
                parted_bound_ms=par[0]["bound_ms"],
                parted_kernels=par[0]["kernels"])


def flat_random(torch, kernel, case, fn, need_bytes, library_fn,
                launches) -> dict:
    """The flat call of a case with ids drawn at random (the parted form,
    :func:`parted_timed`) beside the library call on the same ids."""
    tag = f"large_keys {kernel} {case} random"
    t = parted_timed(torch, kernel, tag, fn, need_bytes, launches)
    library_ms = time_ms(library_fn, torch, reps=10, warm=2)
    log(f"[large_keys] {kernel} {case} random ids: parted device "
        f"{t['device_ms']:.4f} ms ({t['kernels']:g} kernels, "
        f"{t['memsets']:g} memsets per call), bound {t['bound_ms']:.4f} ms "
        f"({need_bytes} B); library {library_ms:.4f} ms; {card()}")
    return dict(t, library_ms=library_ms)


def check_rows(torch, kernel, case, got, again, want) -> None:
    """The row form against its plain version: counts (the first output
    of the stats, the last of the histogram) bit for bit, the sums within
    STATS_RTOL, a second call's bits the first's, the scratch clean."""
    ci = 0 if kernel == "stats" else len(got) - 1
    rel = max(float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
              for i, (a, b) in enumerate(zip(got, want)) if i != ci)
    sums_bits = all(same_bits(torch, a, b)
                    for i, (a, b) in enumerate(zip(got, want)) if i != ci)
    counts = torch.equal(got[ci], want[ci])
    same = all(same_bits(torch, a, b) for a, b in zip(again, got))
    clean = workspace_clean(torch)
    log(f"[large_keys] {kernel} {case} row form: counts bitwise={counts} "
        f"sums rel err {rel:.3e} (rtol {STATS_RTOL}, bit for bit="
        f"{sums_bits}) second call same bits={same} scratch clean={clean}")
    if not (counts and rel <= STATS_RTOL and same and clean):
        fail(f"large_keys {kernel} {case}: the row form differs from its "
             "plain version")


def stats_library(torch, x, sid, mask, g):
    """Three ``index_add_`` over ``sid``: the counts, Σx and Σx²."""
    srcs = (mask.float(), torch.where(mask, x, 0.0),
            torch.where(mask, x * x, 0.0))
    acc = torch.zeros((3, g), device=x.device)
    ids = sid.long()

    def library():
        for a, v in zip(acc, srcs):
            a.zero_().index_add_(0, ids, v)
    return library


def large_stats(torch, gen, case, g, n) -> dict:
    from repro_torch.kernels import ref, stratified_stats as sk
    x, sid, mask = rows_view(torch, gen, g, n)
    rand = torch.randint(0, g, sid.shape, generator=gen, device=sid.device,
                         dtype=torch.int32)
    check_stats(torch, case + " random", x, rand, mask, g)
    check_stats(torch, case, x, sid, mask, g)
    xv, mv = x.view(g, n), mask.view(g, n)
    if sk.stats_form(g) != "row":
        fail(f"large_keys stats {case}: {g} rows do not take the row form")
    check_rows(torch, "stats", case, sk.stratified_stats_rows(xv, mv),
               sk.stratified_stats_rows(xv, mv),
               ref.stratified_stats_rows(xv, mv))
    need = stats_need(torch, x, sid, mask, g)
    live = need["live"]
    launches = parted_launches("stats", g, x.numel())
    out = row_turns(torch, "stats", case,
                    lambda: sk.stratified_stats_rows(xv, mv),
                    lambda: sk.stratified_stats(x, sid, mask, g),
                    x.numel() + 4 * live + 12 * g, need["bytes"],
                    stats_library(torch, x, sid, mask, g), launches,
                    rows=g, slots=x.numel(), live=live)
    out["random"] = flat_random(
        torch, "stats", case, lambda: sk.stratified_stats(x, rand, mask, g),
        stats_need(torch, x, rand, mask, g)["bytes"],
        stats_library(torch, x, rand, mask, g), launches)
    return out


def check_stats(torch, case, x, sid, mask, g) -> None:
    from repro_torch.kernels import ref, stratified_stats as sk
    kc, ks, kq = sk.stratified_stats(x, sid, mask, g)
    again = sk.stratified_stats(x, sid, mask, g)
    pc, ps, pq = ref.stratified_stats(x, sid, mask, g)
    rel = max(float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
              for a, b in ((ks, ps), (kq, pq)))
    same = all(same_bits(torch, a, b) for a, b in zip(again, (kc, ks, kq)))
    clean = workspace_clean(torch)
    log(f"[large_keys] stats {case}: counts bitwise={torch.equal(kc, pc)} "
        f"sums rel err {rel:.3e} (rtol {STATS_RTOL}) second call same "
        f"bits={same} scratch clean={clean}")
    if not (torch.equal(kc, pc) and rel <= STATS_RTOL and same and clean):
        fail(f"large_keys stats {case}: differs from its plain version")


def check_whist(torch, case, x, cell, w, mask, edges, g) -> None:
    from repro_torch.kernels import ref, weighted_hist as wk
    kh, kc = wk.weighted_hist(x, cell, w, mask, edges, g)
    again = wk.weighted_hist(x, cell, w, mask, edges, g)
    ph, pc = ref.weighted_hist(x, cell, w, mask, edges, g)
    rel = float(((kh - ph).abs() / ph.abs().clamp(min=1e-30)).max())
    same = all(same_bits(torch, a, c) for a, c in zip(again, (kh, kc)))
    clean = workspace_clean(torch)
    log(f"[large_keys] whist {case}: counts bitwise={torch.equal(kc, pc)} "
        f"mass rel err {rel:.3e} (rtol {STATS_RTOL}) second call same "
        f"bits={same} scratch clean={clean} in bins {int(kc.sum())}")
    if not (torch.equal(kc, pc) and rel <= STATS_RTOL and same and clean):
        fail(f"large_keys whist {case}: differs from its plain version")


def whist_library(torch, x, cell, w, mask, edges, g, b):
    """``bucketize`` + ``index_add_`` of the live weights by key."""
    key_base = cell.long() * b
    w_live = torch.where(mask, w, 0.0)
    acc = torch.zeros(g * b, device=x.device)

    def library():
        k = torch.bucketize(x, edges, right=True) - 1
        acc.zero_().index_add_(0, key_base + k.clamp(0, b - 1), w_live)
    return library


def large_whist(torch, gen, case, g, b, n) -> dict:
    from repro_torch.core.quantile import _unit_edges
    from repro_torch.kernels import ref, weighted_hist as wk
    x, cell, mask = rows_view(torch, gen, g, n)
    rw = 1.0 + 3.0 * torch.rand(g, generator=gen, device=x.device)
    w = rw[cell.long()]
    rand = torch.randint(0, g, cell.shape, generator=gen, device=x.device,
                         dtype=torch.int32)
    w_rand = rw[rand.long()]
    lo, hi = float(x[mask].min()), float(x[mask].max())
    edges = lo + (hi - lo) * _unit_edges(b, x.device)
    check_whist(torch, case, x, cell, w, mask, edges, g)
    check_whist(torch, case + " random", x, rand, w_rand, mask, edges, g)
    xv, mv = x.view(g, n), mask.view(g, n)
    if wk.hist_form(g, b) != "row":
        fail(f"large_keys whist {case}: {g} x {b} keys do not take the row "
             "form")
    check_rows(torch, "whist", case, wk.weighted_hist_rows(xv, rw, mv, edges),
               wk.weighted_hist_rows(xv, rw, mv, edges),
               ref.weighted_hist_rows(xv, rw, mv, edges))
    need = whist_need(torch, x, cell, w, mask, edges, g)
    row_bytes = (x.numel() + 4 * need["live"] + 4 * g + 4 * (b + 1)
                 + 8 * g * b)
    launches = parted_launches("whist", g * b, x.numel())
    out = row_turns(torch, "whist", case,
                    lambda: wk.weighted_hist_rows(xv, rw, mv, edges),
                    lambda: wk.weighted_hist(x, cell, w, mask, edges, g),
                    row_bytes, need["bytes"],
                    whist_library(torch, x, cell, w, mask, edges, g, b),
                    launches, rows=g, bins=b, slots=x.numel(),
                    live=need["live"])
    out["random"] = flat_random(
        torch, "whist", case,
        lambda: wk.weighted_hist(x, rand, w_rand, mask, edges, g),
        whist_need(torch, x, rand, w_rand, mask, edges, g)["bytes"],
        whist_library(torch, x, rand, w_rand, mask, edges, g, b), launches)
    return out


@contextlib.contextmanager
def plain_stats():
    """``ops.stratified_stats`` replaced by its plain version, so that a
    caller runs as on the CPU, on the card's tensors."""
    from repro_torch.kernels import ops, ref
    kernel = ops.stratified_stats
    ops.stratified_stats = ref.stratified_stats
    try:
        yield
    finally:
        ops.stratified_stats = kernel


def lk_baselines(torch, gen) -> dict:
    """The flat callers of the stats at the per-key stress's S = 65,536
    over its 4,194,304 items with random ids: ``query.exact_stats`` (the
    native baseline's ground truth) and STS's ``baselines.sample_stats``
    (pass-1 counts, a sample of 10%), each held to itself through the
    plain stats (counts bit for bit, sums within STATS_RTOL); fails
    unless each call ran the parted form."""
    from repro_torch import prng
    from repro_torch.core import baselines, query
    from repro_torch.kernels import stratified_stats as sk
    s, m, dev = LK_BASELINE_S, LK_BASELINE_M, gen.device
    values = 100.0 + 10.0 * torch.randn(m, generator=gen, device=dev)
    sid = torch.randint(0, s, (m,), generator=gen, device=dev,
                        dtype=torch.int32)
    counts = baselines.sts_counts(sid, s)
    sample = baselines.sts_sample(prng.PRNGKey(5, dev), sid, counts, 0.1)
    calls = {"exact_stats": lambda: query.exact_stats(values, sid, s),
             "sts_sample_stats": lambda: baselines.sample_stats(
                 values, sid, sample, s, counts)}
    out = {}
    for name, call in calls.items():
        before = dict(sk.stratified_stats.forms)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ran = {f: sk.stratified_stats.forms[f] - before[f] for f in before}
        with plain_stats():
            want = call()
        exact = all(torch.equal(getattr(got, f), getattr(want, f))
                    for f in ("counts", "taken"))
        rel = max(float(((getattr(got, f) - getattr(want, f)).abs()
                         / getattr(want, f).abs().clamp(min=1e-30)).max())
                  for f in ("sums", "sumsqs"))
        clean = workspace_clean(torch)
        log(f"[large_keys] {name} at S = {s} over {m} items: counts "
            f"bitwise={exact} sums rel err {rel:.3e} (rtol {STATS_RTOL}) "
            f"forms {ran} scratch clean={clean} wall {wall:.3f} ms; "
            f"{card()}")
        if not (exact and rel <= STATS_RTOL and clean):
            fail(f"large_keys {name}: differs from its plain version")
        if ran != {"small": 0, "row": 0, "parted": 1}:
            fail(f"large_keys {name}: the stats ran the forms {ran}, not "
                 "the parted form")
        out[name] = dict(forms=ran, rel_err=rel, wall_ms=wall)
    return out


def lk_registry():
    """The sliding deployment's queries: sum, mean, count and the
    median by histogram refinement (4 histograms of W·K·S x 32 keys an
    emission; no bootstrap, so the CPU twin stays in time)."""
    return linear_registry().register("median", "quantile", qs=(0.5,),
                                      method="hist", num_replicates=0)


def lk_chunks(torch, seed: int) -> list:
    """LK_CHUNKS ``[4, LK_M_SHARD]`` chunks on the CPU, a quarter second
    each, every shard on the same ramp (``stamp_sharded``): 64 Gaussian
    sub-streams, means 10 to 10,000."""
    from repro_torch.runtime.records import stamp_sharded
    gen = torch.Generator().manual_seed(seed)
    w, s = LK_EXEC["num_shards"], LK_EXEC["num_strata"]
    mus = torch.logspace(1.0, 4.0, s)
    rate = LK_M_SHARD / 0.25
    out = []
    for e in range(LK_CHUNKS):
        sid = torch.randint(0, s, (w, LK_M_SHARD), generator=gen,
                            dtype=torch.int32)
        vals = mus[sid.long()] * (1.0 + 0.1 * torch.randn(
            (w, LK_M_SHARD), generator=gen))
        out.append(stamp_sharded(vals, sid, e * LK_M_SHARD / rate, rate))
    return out


def lk_new_executor(dev, ingest):
    """The sliding deployment's pipelined executor on ``dev``."""
    from repro_torch import prng
    from repro_torch.runtime.executor import PipelinedExecutor, RuntimeConfig
    cfg = RuntimeConfig(**LK_EXEC, emit_every=LK_EMIT, ingest=ingest)
    return PipelinedExecutor(cfg, lk_registry(), prng.PRNGKey(3), device=dev)


def lk_push(ex, dev, chunks) -> None:
    from repro_torch.runtime.records import TimestampedChunk
    for c in chunks:
        ex.push(TimestampedChunk(*(getattr(c, f).to(dev) for f in (
            "values", "stratum_ids", "times", "mask"))))


def lk_executor(torch, dev, ingest, chunks) -> tuple:
    """The sliding deployment's pipelined executor on ``dev``: its
    emissions' answers and final state (numpy), the kernels' launches
    and forms in the run (the counts set to 0 just before, read just
    after), its wall s and the executor."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import convert
    ex = lk_new_executor(dev, ingest)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    lk_push(ex, dev, chunks)
    ems = list(ex.emissions)
    launches, forms = ops.launch_counts(), ops.form_counts()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([convert.results_to_numpy(em.results) for em in ems],
            convert.state_to_numpy(ex.state), launches, forms, wall, ex)


#: kernel name prefixes of the fold's and the one-shot's launches
INGEST_KERNELS = ("fold_", "parted_", "osi_")


def lk_chunk_device_ms(torch, dev, ingest, chunks) -> dict:
    """Device ms per chunk of the sliding deployment's executor on
    ``ingest``, from a ``torch.profiler`` trace of a fresh executor's
    pushes (its emissions included, the chunks' copies to the card
    not): every kernel's, the fold's or one-shot's launches' and the
    launches of each of those per chunk."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ex = lk_new_executor(dev, ingest)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lk_push(ex, dev, chunks)
        torch.cuda.synchronize()
    total, split = 0.0, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or "Memcpy" in e.name:
            continue
        us = e.time_range.elapsed_us()
        total += us
        name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
        name = name.removeprefix("void ")
        if name.startswith(INGEST_KERNELS):
            ms, n = split.get(name, (0.0, 0))
            split[name] = (ms + us / 1e3, n + 1)
    per = len(chunks)
    return dict(device_ms=total / 1e3 / per,
                ingest_ms=sum(v[0] for v in split.values()) / per,
                ingest_split={k: (v[0] / per, v[1] / per)
                              for k, v in split.items()})


@contextlib.contextmanager
def flat_route():
    """The emission's row entries (``ops.stratified_stats_rows``,
    ``ops.weighted_histogram_rows``) replaced by the flat calls with row
    ids and each row's weight on its slots, the route the emission took
    before it had the row entries: past the caps, the parted large-key
    forms."""
    from repro_torch.kernels import ops, ref
    rows = ops.stratified_stats_rows, ops.weighted_histogram_rows

    def stats(values, mask):
        g, n = values.shape
        return ops.stratified_stats(values.reshape(-1), ref.row_ids(
            g, n, values.device), mask.reshape(-1), g)

    def hist(values, row_weights, mask, edges):
        g, n = values.shape
        return ops.weighted_histogram(
            values.reshape(-1), ref.row_ids(g, n, values.device),
            row_weights.repeat_interleave(n), mask.reshape(-1), edges, g)
    ops.stratified_stats_rows, ops.weighted_histogram_rows = stats, hist
    try:
        yield
    finally:
        ops.stratified_stats_rows, ops.weighted_histogram_rows = rows


def lk_emission_turns(torch, ex) -> dict:
    """One emission's evaluation (``ex.query()``, every standing query on
    the state) by the host clock around a synchronise, median of
    LATENCY_REPS, through the row entries and through the flat route in
    turns (R F F R)."""
    out = []
    for route in ("row", "flat", "flat", "row"):
        walls = []
        with (flat_route() if route == "flat" else contextlib.nullcontext()):
            for _ in range(LATENCY_REPS + 1):          # the first warms
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ex.query()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        out.append((route, sorted(walls[1:])[len(walls[1:]) // 2]))
    return dict(turns=out, row_ms=min(v for r, v in out if r == "row"),
                flat_ms=min(v for r, v in out if r == "flat"))


def lk_paths(torch, dev) -> dict:
    """The sliding deployment through the pipelined fused and onekernel
    paths on the card, held to one fused run on the CPU (the two paths
    end in the same state bit for bit): the state bit for bit, every
    answer within ANSWER_RTOL; each path's launches checked."""
    chunks = lk_chunks(torch, 26)
    cpu_ems, cpu_state, _, _, cpu_wall, _ = lk_executor(torch, "cpu",
                                                        "fused", chunks)
    if len(cpu_ems) != LK_CHUNKS // LK_EMIT:
        fail(f"large_keys executor: {len(cpu_ems)} emissions on the CPU")
    cells = (LK_EXEC["num_shards"] * LK_EXEC["num_intervals"]
             * LK_EXEC["num_strata"])
    out = dict(cpu_wall_s=cpu_wall, cells=cells, paths={})
    for ingest in ("fused", "onekernel"):
        ems, state, launches, forms, wall, ex = lk_executor(torch, dev,
                                                            ingest, chunks)
        bad = [b for p in ("window", "slot_interval", "open_interval", "wm",
                           "metrics")
               for b in same_state(state[p], cpu_state[p], p)]
        worst = 0.0
        for a, b in zip(ems, cpu_ems):
            for name in b:
                x, y = np.asarray(a[name]["value"]), np.asarray(
                    b[name]["value"])
                worst = max(worst, float(np.max(np.abs(x - y) / np.maximum(
                    np.abs(y), 1e-30))))
        folder = ("one_shot_ingest" if ingest == "onekernel"
                  else "reservoir_fold")
        want = dict(stratified_stats=1, weighted_hist=REFINE_STEPS)
        want[folder] = 1
        missing = [k for k in want if not launches[k]]
        not_row = {k: forms[k] for k in ("stratified_stats", "weighted_hist")
                   if forms[k]["row"] != launches[k]}
        not_parted = forms[folder]["parted"] != launches[folder]
        per_chunk_calls = launches[folder] / LK_CHUNKS
        emit = lk_emission_turns(torch, ex)
        per_chunk = lk_chunk_device_ms(torch, dev, ingest, chunks)
        log(f"[large_keys] executor {ingest} on the card ({cells} cells, "
            f"W = 4, N_max 512 a shard): {len(ems)} emissions, state "
            f"bitwise to the CPU's={not bad} (differs: {bad}), answers' "
            f"worst rel err {worst:.3e} (rtol {ANSWER_RTOL}), launches "
            f"{launches}, forms {forms}, wall {wall:.3f} s (CPU twin "
            f"{cpu_wall:.3f} s); one emission's evaluation in turns "
            + ", ".join(f"{r} {v:.4f}" for r, v in emit["turns"])
            + f" ms; device ms per chunk {per_chunk['device_ms']:.4f}, of "
            f"it the {folder} launches {per_chunk['ingest_ms']:.4f} "
            + "(" + ", ".join(f"{k} {v[0]:.4f} x{v[1]:g}" for k, v in sorted(
                per_chunk["ingest_split"].items())) + f"); {card()}")
        if bad or len(ems) != len(cpu_ems) or worst > ANSWER_RTOL:
            fail(f"large_keys executor {ingest}: differs from its CPU twin")
        if missing:
            fail(f"large_keys executor {ingest}: no launch of {missing}")
        if not_row:
            fail(f"large_keys executor {ingest}: stats or histogram calls "
                 f"not in the row form: {not_row}")
        if not_parted:
            fail(f"large_keys executor {ingest}: {folder} calls not in the "
                 f"parted form: {forms[folder]}")
        if per_chunk_calls != 1:
            fail(f"large_keys executor {ingest}: {per_chunk_calls:g} "
                 f"{folder} calls per chunk of W = 4 shards, not one")
        out["paths"][ingest] = dict(launches=launches, forms=forms,
                                    wall_s=wall, worst_rel_err=worst,
                                    emission=emit, per_chunk=per_chunk)
        del ex
    return out


def phase_large_keys(torch, dev) -> dict:
    """The large-key forms of the four kernels against their plain
    versions at LK_FOLD / LK_ONE_SHOT / LK_STATS / LK_WHIST (bitwise, or
    counts bitwise and sums within STATS_RTOL, the same bits twice, the
    scratch clean), each timed with its launches and its bound by bytes,
    the stats and histogram cases in turns with their row form and with
    ids at random beside the library call; the stats' flat callers at
    the per-key stress (:func:`lk_baselines`); then the sliding
    deployment's executor (:func:`lk_paths`);
    ``chiprun_out/chip_smoke_large_keys.json``."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(TIMING_SEED)
    rows = [large_fold(torch, gen, *c) for c in LK_FOLD]
    rows += [large_one_shot(torch, gen, *c) for c in LK_ONE_SHOT]
    rows += [large_stats(torch, gen, *c) for c in LK_STATS]
    rows += [large_whist(torch, gen, *c) for c in LK_WHIST]
    base = lk_baselines(torch, gen)
    torch.cuda.empty_cache()
    paths = lk_paths(torch, dev)
    out = dict(rows=rows, baselines=base, executor=paths, card=card(),
               phase_s=time.perf_counter() - t0)
    (ROOT / "chiprun_out" / "chip_smoke_large_keys.json").write_text(
        json.dumps(out, indent=1))
    log(f"[large_keys] phase {out['phase_s']:.1f} s; {card()}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile 8 chunks of the main path "
                         "(table in chiprun_out/chip_smoke_profile.txt)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    phase_build()
    fold = phase_fold(torch, gen)
    stats = phase_stats(torch, gen)
    launches = phase_main(torch, args.seed, dev)
    one_shot = phase_one_shot(torch, gen)
    paths = phase_paths(torch, args.seed, dev)
    whist = phase_weighted_hist(torch, gen)
    nonlinear = phase_nonlinear(torch, args.seed, dev)
    phase_recovery(torch, args.seed, dev, nonlinear)
    sharded = phase_sharded(torch, args.seed, dev)["one_shot_launches"]
    rescale = phase_rescale(torch, args.seed, dev)["paths"]["b"]["launches"]
    systems = phase_systems(torch, args.seed, dev)["launches"]
    serve = phase_serve(torch, args.seed, dev)["launches"]
    train = phase_train(torch, args.seed, dev)["launches"]
    families = phase_families(torch, args.seed, dev)["launches"]
    phase_dryrun(torch, args.seed, dev)
    payloads = phase_payloads(torch, dev)["launches"]
    large_paths = phase_large_keys(torch, dev)["executor"]["paths"]
    large = {k: sum(p["launches"][k] for p in large_paths.values())
             for k in ("reservoir_fold", "stratified_stats",
                       "one_shot_ingest", "weighted_hist")}
    if args.profile:
        phase_profile(torch, args.seed, dev)

    kernels = [
        dict(name="reservoir_fold", route="cuda",
             source="src/repro_torch/kernels/csrc/reservoir_fold.cu",
             replaces="src/repro/kernels/reservoir.py:36",
             launches=launches["reservoir_fold"]
             + systems["reservoir_fold"] + serve["reservoir_fold"]
             + train["reservoir_fold"] + families["reservoir_fold"]
             + payloads["reservoir_fold"] + large["reservoir_fold"],
             **fold),
        dict(name="stratified_stats", route="cuda",
             source="src/repro_torch/kernels/csrc/stratified_stats.cu",
             replaces="src/repro/kernels/stratified_stats.py:31",
             launches=launches["stratified_stats"]
             + systems["stratified_stats"] + serve["stratified_stats"]
             + families["stratified_stats"] + payloads["stratified_stats"]
             + large["stratified_stats"], **stats),
        dict(name="one_shot_ingest", route="cuda",
             source="src/repro_torch/kernels/csrc/one_shot_ingest.cu",
             replaces="src/repro/kernels/reservoir.py:146",
             launches=paths["launches"]["one_shot_ingest"] + sharded
             + rescale["one_shot_ingest"] + large["one_shot_ingest"],
             **one_shot),
        dict(name="weighted_hist", route="cuda",
             source="src/repro_torch/kernels/csrc/weighted_hist.cu",
             replaces="src/repro/kernels/weighted_hist.py:35",
             launches=nonlinear["launches"]["weighted_hist"]
             + large["weighted_hist"], **whist),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
