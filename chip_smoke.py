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
             bytes the function needs at that chunk;
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
             through one carried state; then, as for the fold, its
             times, kernels, memsets and bound at a replacement chunk in
             which every masked-in item is live;
6. paths     the same deployment on a disordered stream (30% of items
             shifted back by U(0, 0.75) s): (a) pipelined fused, (b)
             pipelined onekernel, (c) batched onekernel, (d) pipelined
             masked, all on cadence, and (e) pipelined and (f) batched
             onekernel under watermark emission. (b)-(d) end in (a)'s
             state bit for bit and (b), (c) emit (a)'s emissions; (e) and
             (f) close the same intervals once each with the same answers;
             every answer lies within 3 sigma of the exact value over the
             items the script itself finds accepted.
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

Then it prints the kernels' JSON line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py [--seed N]
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
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
PROFILE_TRIES = 5                  # traces of one window, as needed
STATS_RTOL = 1e-5                  # kernel vs f64-accumulated plain sums
S2_RTOL = 1e-3                     # f32 s2 (three digits cancel) vs f64
ANSWER_RTOL = 1e-5                 # f32 rounding beside the 3-sigma bound


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
    whole multiple of ``reps``; the tracer now and then drops events (a
    window with no device activity, or one kernel in ten missing), and
    such a window is profiled again, up to ``PROFILE_TRIES`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        split = {}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = ("memset" if "Memset" in e.name else e.name.replace(
                    "(anonymous namespace)::", "").split("(")[0])
                us, n = split.get(name, (0.0, 0))
                split[name] = (us + e.time_range.elapsed_us(), n + 1)
        if split and all(n % reps == 0 for _, n in split.values()):
            break
        log(f"[profile] trace of {reps} calls dropped device events "
            f"({', '.join(f'{k} x{n}' for k, (_, n) in split.items())}); "
            f"profiling again")
    return {k: (us / reps / 1e3, n / reps) for k, (us, n) in split.items()}


def log_launches(tag: str, prof: dict) -> tuple:
    """Log the kernels and memsets per call of a profile; returns them."""
    memsets = sum(n for k, (_, n) in prof.items() if k == "memset")
    kernels = sum(n for k, (_, n) in prof.items() if k != "memset")
    names = ", ".join(f"{k} x{n:g}" for k, (_, n) in sorted(prof.items()))
    log(f"[{tag}] per call: {kernels:g} kernels, {memsets:g} memsets "
        f"({names}); device ms {sum(v[0] for v in prof.values()):.4f}")
    return kernels, memsets


def one_launch(tag: str, prof: dict) -> None:
    """Log a profile's kernels and memsets per call; fail unless they are
    one kernel and no memset."""
    if log_launches(tag, prof) != (1, 0):
        fail(f"{tag}: not one kernel and no memset per call")


def claim_tiles(m: int) -> int:
    """Tiles (blocks of each launch) of a fold or one-shot call."""
    from repro_torch.kernels import _build, _workspace
    return _workspace.tiles(_build.build().lib, m)


def listed_items(torch, m: int) -> int:
    """Accepted items of the last fold or one-shot call of ``m`` items:
    the entries of the per-warp lists its claim pass wrote."""
    from repro_torch.kernels import _build, _workspace
    dev = torch.device("cuda", torch.cuda.current_device())
    ws = _workspace.get(dev, torch.cuda.current_stream(dev).cuda_stream)
    lists = _build.build().lib.sa_fold_tile_lists()
    return int(ws.list_n[:claim_tiles(m) * lists].sum())


def workspace_clean(torch) -> bool:
    """The kernels' kept scratch is as the next call needs it: the winner
    table all -1, the look-back words, the counters and the tickets all
    0."""
    from repro_torch.kernels import _workspace
    dev = torch.device("cuda", torch.cuda.current_device())
    ws = _workspace.get(dev, torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    return bool((ws.winner == -1).all()) and not bool(
        ws.status.any()) and not bool(ws.counters.any()) and not bool(
        ws.tickets.any())


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
    log_launches("fold", t["prof"])
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


def fold_need(torch, inp) -> dict:
    """Bytes the fold of ``inp`` must move, from one probe call of the
    kernel: the mask of every item; the stratum of each live item; u_accept
    of each item past capacity; u_slot of each such item accepted; the
    payload and the ring word of each cell won; counts in and out and
    capacity. Scattered words count at their 4 bytes, though DRAM moves a
    32-byte sector for each."""
    from repro_torch.kernels import reservoir
    m = inp["stratum_ids"].numel()
    cells = inp["counts"].numel()
    probe = torch.full((cells, N_MAX), float("nan"),
                       device=inp["counts"].device)
    new_counts = reservoir.reservoir_fold(values=probe, **inp)
    won = int((~torch.isnan(probe)).sum())
    accepted = listed_items(torch, m)
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
    f64-summed plain version, the same bits on a second call, the tickets
    0 after it), the s2 of the emission's input against float64, then its
    times at the emission's input (``stats_timing``)."""
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
    """The §5.1 Gaussian stream, stamped in order, made on the card in
    bulk (set-up), with the exact per-interval float64 aggregates."""
    from repro_torch.runtime.records import stamp
    from repro_torch.runtime.watermark import interval_of
    from repro_torch.stream.sources import GaussianSource
    src = GaussianSource()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n_iv = int(CHUNKS * M / RATE // SPAN) + 1
    chunks, exact = [], []
    acc = torch.zeros((3, n_iv, S), dtype=torch.float64, device=dev)
    for e in range(CHUNKS):
        vals, sid = src.chunk(gen, M)
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
    from repro_torch.runtime.executor import (PipelinedExecutor,
                                              RuntimeConfig, _ingest_chunk)
    from repro_torch.runtime.registry import QueryRegistry
    chunks, exact = make_stream(torch, seed, dev)
    cfg = RuntimeConfig(num_strata=S, capacity=N_MAX, num_intervals=K,
                        interval_span=SPAN, allowed_lateness=LATENESS,
                        emit_every=EMIT_EVERY)
    reg = (QueryRegistry().register("sum", "sum").register("mean", "mean")
           .register("count", "count", predicate=lambda x: x > THRESHOLD))
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
                  max_time, open_interval, t_lo, t_hi, mask_p=0.97):
    """Full-shape inputs of one one-shot call: ``(items, state)``."""
    dev = gen.device
    i32 = dict(dtype=torch.int32, device=dev)

    def rand(n):
        return torch.rand(n, generator=gen, device=dev)
    items = dict(
        times=t_lo + (t_hi - t_lo) * rand(m),
        stratum_ids=torch.randint(0, S, (m,), generator=gen, **i32),
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
        values=torch.randn((K, S, N_MAX), generator=gen, device=dev),
        counters=torch.randint(0, 1000, (6, S), generator=gen, **i32))
    return items, state


def same_bits(torch, a, b) -> bool:
    """Equal bit for bit (f32 compared as its int32 words)."""
    if a.dtype == torch.float32:
        a, b = a.reshape(-1).view(torch.int32), b.reshape(-1).view(
            torch.int32)
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
    log_launches("one_shot", t["prof"])
    log(f"[one_shot] the counts' restore before each call: "
        f"{t['restore']} (left out of the split above)")
    return dict(max_abs_err=worst, ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=bound,
                bound_by="bytes" if need["bytes"] / HBM_BYTES_PER_S
                >= n_ops / F32_OPS_PER_S else "operations", library_ms=None)


def one_shot_timing(torch, dev, seed: int = TIMING_SEED) -> dict:
    """Times the one-shot at the main path's steady state, a replacement
    chunk made from ``seed``: counts 2-3 M above random capacities, the
    frontier at 9.9 s and the items in [9.45, 9.85) s, so every masked-in
    item is live and the frontier does not move. The counts are put back
    before each call (one 24-byte copy, shown apart from the kernels), so
    every call does the same work. Only the wrapper and the plain version
    are called, so the same inputs time any tree's kernel."""
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
    counts0 = state["counts"].clone()

    def steady(fn):
        def call():
            state["counts"].copy_(counts0)
            fn(**items, **ONE_SHOT_KW, **state)
        return call
    ms = time_ms(steady(one_shot_ingest), torch)
    plain_ms = time_ms(steady(ref.one_shot_ingest), torch, reps=5, warm=1)
    prof = device_profile(steady(one_shot_ingest), torch)
    restore = {k: prof.pop(k) for k in list(prof) if "Memcpy" in k}
    state["counts"].copy_(counts0)
    return dict(ms=ms, plain_ms=plain_ms, prof=prof, restore=restore,
                items=items, state=state)


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
    probe = dict({k: v.clone() for k, v in state.items()},
                 values=torch.full((K, S, N_MAX), float("nan"),
                                   device=state["counts"].device))
    one_shot_ingest(**items, **ONE_SHOT_KW, **probe)
    won = int((~torch.isnan(probe["values"])).sum())
    accepted = listed_items(torch, m)
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
              + 4 * (3 * K * S + 11 * S + 2 * K + 14)
              + 4 * (resets * S + (S if resets else 0)))
    return dict(need, bytes=nbytes, masked_in=masked_in, accepted=accepted,
                won=won)


def make_disordered_stream(torch, seed: int, dev):
    """The §5.1 stream from DISORDER_T0 s on, with SHIFT_P of the items
    shifted back by U(0, SHIFT_MAX) s (made on the card from a seeded
    generator), and the script's own verdict on every item, chunk by
    chunk, from the chunk times, the pre-chunk watermark and ring
    eviction: the exact float64 per-(interval, stratum) count, sum and
    count(x > THRESHOLD) over the accepted items after each chunk, and the
    accepted / on-time / late / dropped totals."""
    from repro_torch.runtime.records import TimestampedChunk
    from repro_torch.stream.sources import GaussianSource
    src = GaussianSource()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    recip = float(np.float32(1.0) / np.float32(SPAN))
    n_iv = int((DISORDER_T0 + CHUNKS * M / RATE) // SPAN) + 1
    acc = torch.zeros((3, n_iv, S), dtype=torch.float64, device=dev)
    totals = dict(on_time=0, late=0, dropped=0)
    frontier, open_iv = np.float32(-3.0e38), 0
    chunks, exact = [], []
    for e in range(CHUNKS):
        vals, sid = src.chunk(gen, M)
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
    bytes), flow sizes floored to whole bytes, stamped in order at RATE,
    made on the card from the seed."""
    from repro_torch.runtime.records import stamp
    from repro_torch.stream.sources import NetflowSource
    src = NetflowSource()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    chunks = []
    for e in range(NL_CHUNKS):
        vals, sid = src.chunk(gen, M)
        chunks.append(stamp(torch.floor(vals), sid, e * M / RATE, RATE))
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
    return dict(launches=runs["1"]["launches"], latency=lat, share=share)


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
    if args.profile:
        phase_profile(torch, args.seed, dev)

    kernels = [
        dict(name="reservoir_fold", route="cuda",
             source="src/repro_torch/kernels/csrc/reservoir_fold.cu",
             replaces="src/repro/kernels/reservoir.py:36",
             launches=launches["reservoir_fold"], **fold),
        dict(name="stratified_stats", route="cuda",
             source="src/repro_torch/kernels/csrc/stratified_stats.cu",
             replaces="src/repro/kernels/stratified_stats.py:31",
             launches=launches["stratified_stats"], **stats),
        dict(name="one_shot_ingest", route="cuda",
             source="src/repro_torch/kernels/csrc/one_shot_ingest.cu",
             replaces="src/repro/kernels/reservoir.py:146",
             launches=paths["launches"]["one_shot_ingest"], **one_shot),
        dict(name="weighted_hist", route="cuda",
             source="src/repro_torch/kernels/csrc/weighted_hist.cu",
             replaces="src/repro/kernels/weighted_hist.py:35",
             launches=nonlinear["launches"]["weighted_hist"], **whist),
    ]
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    print(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
