#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

Phases (any failure ends the run with a non-zero exit):

1. build     compile ``src/repro_torch/kernels/csrc/*.cu`` with nvcc;
2. fold      the reservoir-fold kernel against its plain version,
             bitwise, at the main path's shape ([6, 1,048,576] ring,
             524,288-item chunks): filling, replacement, all-masked and
             ragged chunks;
3. stats     the stats kernel against its plain version on [6 x 1,048,576]
             slots (counts exact, sums within rtol), and its s2 against
             float64;
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
             with every slot reset, late items, an all-masked chunk and a
             ragged one;
6. paths     the same deployment on a disordered stream (30% of items
             shifted back by U(0, 0.75) s): (a) pipelined fused, (b)
             pipelined onekernel, (c) batched onekernel, (d) pipelined
             masked, all on cadence, and (e) pipelined and (f) batched
             onekernel under watermark emission. (b)-(d) end in (a)'s
             state bit for bit and (b), (c) emit (a)'s emissions; (e) and
             (f) close the same intervals once each with the same answers;
             every answer lies within 3 sigma of the exact value over the
             items the script itself finds accepted.

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


def device_split(fn, torch, reps: int = 10) -> dict:
    """Device time per call of each kernel and memset that ``fn`` runs,
    from a ``torch.profiler`` trace of ``reps`` calls: ``{name: ms}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = ("memset" if "Memset" in e.name else e.name.replace(
                "(anonymous namespace)::", "").split("(")[0])
            split[name] = split.get(name, 0.0) + e.time_range.elapsed_us()
    return {k: v / reps / 1e3 for k, v in split.items()}


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

    # Timing at the main path's steady state: a replacement chunk.
    inp = cases["replacement"]
    ring = torch.randn((cells, N_MAX), generator=gen, device=dev)
    ms = time_ms(lambda: reservoir.reservoir_fold(values=ring, **inp), torch)
    plain_ms = time_ms(lambda: ref.reservoir_fold(values=ring, **inp),
                       torch, reps=5, warm=1)
    probe = torch.full((cells, N_MAX), float("nan"), device=dev)
    reservoir.reservoir_fold(values=probe, **inp)
    written = int((~torch.isnan(probe)).sum())
    nbytes = 17 * M + 4 * written + 12 * cells
    ops = 12 * M                       # ~a dozen integer/f32 ops per item
    bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    log(f"[fold] replacement chunk: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
        f" ms, bound {bound:.4f} ms ({nbytes} B, {written} cells written)")
    log_split("fold", device_split(
        lambda: reservoir.reservoir_fold(values=ring, **inp), torch), ms)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / F32_OPS_PER_S else "operations", library_ms=None)


def phase_stats(torch, gen):
    from repro_torch.kernels import ref, stratified_stats as sk
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
    kc, ks, kq = sk.stratified_stats(x, sid, mask, g)
    pc, ps, pq = ref.stratified_stats(x, sid, mask, g)
    torch.cuda.synchronize()
    if not torch.equal(kc, pc):
        fail(f"stats counts differ: {kc.tolist()} vs {pc.tolist()}")
    rel_s = float(((ks - ps).abs() / ps.abs()).max())
    rel_q = float(((kq - pq).abs() / pq.abs()).max())
    err = max(float((ks - ps).abs().max()), float((kq - pq).abs().max()))
    # s2 from the kernel's f32 moments against float64 on the same slots.
    from repro_torch.core.error import StratumStats
    y = taken.to(torch.int32)
    s2 = StratumStats(counts=y, taken=y, sums=ks, sumsqs=kq).s2().double()
    xd = torch.where(mask, x.double(), 0.0).reshape(g, N_MAX)
    mean = xd.sum(1) / taken
    s2_ref = ((xd - mean[:, None]) ** 2 * mask.reshape(g, N_MAX)).sum(1) \
        / (taken - 1)
    rel_s2 = float(((s2 - s2_ref).abs() / s2_ref).max())
    log(f"[stats] counts exact; sums rel err {rel_s:.3e}, sumsqs rel err "
        f"{rel_q:.3e} (rtol {STATS_RTOL}); s2 rel err vs f64 {rel_s2:.3e} "
        f"(rtol {S2_RTOL})")
    if rel_s > STATS_RTOL or rel_q > STATS_RTOL:
        fail("stats sums outside rtol")
    if rel_s2 > S2_RTOL:
        fail("stats s2 outside rtol of float64")
    again = sk.stratified_stats(x, sid, mask, g)
    if not all(torch.equal(a, b) for a, b in zip(again, (kc, ks, kq))):
        fail("stats kernel is not deterministic from run to run")

    ms = time_ms(lambda: sk.stratified_stats(x, sid, mask, g), torch)
    plain_ms = time_ms(lambda: ref.stratified_stats(x, sid, mask, g), torch,
                       reps=5, warm=1)
    stacked = torch.stack([mask.float(), torch.where(mask, x, 0.0),
                           torch.where(mask, x * x, 0.0)], dim=1)
    acc = torch.zeros((g, 3), device=dev)
    library_ms = time_ms(lambda: acc.zero_().index_add_(0, sid, stacked),
                         torch)
    n = g * N_MAX
    nbytes = 9 * n + 12 * g
    ops = 4 * n
    bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    log(f"[stats] [{g} x {N_MAX}]: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
        f" ms, index_add_ {library_ms:.4f} ms, bound {bound:.4f} ms")
    log_split("stats", device_split(
        lambda: sk.stratified_stats(x, sid, mask, g), torch), ms)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / F32_OPS_PER_S else "operations",
                library_ms=library_ms)


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
    kw = dict(span=SPAN, allowed_lateness=LATENESS)
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

    # Timing at the main path's steady state: a replacement chunk.
    items, state = cases["replacement"]
    ms = time_ms(lambda: one_shot_ingest(**items, **kw, **state), torch)
    plain_ms = time_ms(lambda: ref.one_shot_ingest(**items, **kw, **state),
                       torch, reps=5, warm=1)
    probe = dict(state, values=torch.full((K, S, N_MAX), float("nan"),
                                          device=dev))
    one_shot_ingest(**items, **kw, **probe)
    written = int((~torch.isnan(probe["values"])).sum())
    m = items["times"].numel()
    nbytes = 21 * m + 4 * written + 4 * (4 * K * S + 7 * S + K + 7)
    n_ops = 20 * m                     # ~twenty integer/f32 ops per item
    bound = max(nbytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S) * 1e3
    log(f"[one_shot] replacement chunk: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({nbytes} B, {written} "
        "cells written); no single PyTorch call does the fused ingest")
    split = device_split(lambda: one_shot_ingest(**items, **kw, **state),
                         torch)
    log_split("one_shot", split, ms)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                >= n_ops / F32_OPS_PER_S else "operations", library_ms=None)


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
