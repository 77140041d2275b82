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
        acc = exact[(em.index + 1) * EMIT_EVERY - 1]
        live = [i for i in range(em.open_interval - K + 1,
                                 em.open_interval + 1) if i >= 0]
        cnt, tot, big = (float(acc[f][live].sum()) for f in range(3))
        want = {"sum": tot, "mean": tot / cnt, "count": big}
        for name, est in em.results.items():
            v, var = float(est.value), float(est.variance)
            sigma = math.sqrt(max(var, 0.0))
            dev_ = abs(v - want[name])
            ok = dev_ <= 3 * sigma + ANSWER_RTOL * abs(want[name])
            log(f"[main] emission {em.index} {name}: {v:.9g} exact "
                f"{want[name]:.9g} |err| {dev_:.4g} sigma {sigma:.4g} "
                f"{'ok' if ok else 'OUTSIDE 3 sigma'}")
            if not ok:
                fail(f"emission {em.index} {name} outside its 3-sigma bound")
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
