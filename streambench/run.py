"""Run one benchmark cell once on the card and print its result line.

    python3 streambench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start): imports, the
card, the kernel library, the stream pool made on the card from the
seed, the executor, one warm-up emission period at the cell's shapes.
Then the window: the closed loop pushes chunks for ``--seconds`` and
ends once the card has finished them. After it, with the program's
state read and freed, the plain reference checks the window's output.
The last line of standard output is one JSON object; the numbers
compared are the last lines of standard error and the result's last
key.
"""
import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
BANNED = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    for p in (str(BENCH), str(REPO / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def banned_modules() -> list:
    """Loaded modules whose top-level name is banned, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def end_to_end(cell, run) -> dict:
    lat = [e.latency_s * 1e3 for e in run.emissions if e.in_window]
    values = {"items_per_s": (run.window_items / run.window_s, "items/s")}
    if lat:
        values["emit_ms"] = (sum(lat) / len(lat), "ms")
        if len(lat) >= 2:
            values["emit_p95_ms"] = (
                statistics.quantiles(lat, n=20, method="inclusive")[18],
                "ms")
    return values


def run_cell(name: str, seed: int, seconds: float, trace: bool) -> dict:
    """One run of cell ``name``; returns the result object."""
    _paths()
    import torch
    from harness import cells, check, device as devinfo, needs, session
    from reference import replay

    cell = cells.resolve(name)
    dev = devinfo.card(cell.chips)
    m = session.measure(cell, seed, seconds, trace, dev, PROCESS_START)
    t_check = time.perf_counter()
    routed = check.route(cell, m.pool, seed, m.run.chunks)
    verdict = check.compare(cell, m.pool, seed, m.run, m.final, routed)
    print(f"reference check: {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    result = {"correct": check.passed(verdict.numbers),
              "attempted": sum(e.in_window for e in m.run.emissions),
              "failed": verdict.failed}
    if trace:
        data = m.tracer.summarize()
        data.cell = cell
        lay = routed.layout
        first = min(it.chunk for it in data.iterations)
        last = max(it.chunk for it in data.iterations)
        _, stats = replay.replay(lay, m.pool, routed.records, routed.keys,
                                 first, last, want_ring=False)
        data.fold = dict(zip(range(first, last + 1), stats))
        data.views = check.view_sizes(lay, routed.records, data)
        metrics = {}
        for pl in cell.per_layer:
            value = cells.reader(pl["name"], cell.root)(data)
            if value is not None:
                metrics[pl["name"]] = {"value": value, "unit": pl["unit"]}
        result["metrics"] = metrics
        result["breakdown"] = {"device_ops": data.device_ops,
                               "idle_gaps": data.idle_gaps}
        device_extra = {"busy_s": data.busy_us / 1e6,
                        "window_s": data.window_us / 1e6}
        print(f"trace: {len(data.iterations)} iterations, "
              f"{data.unattributed} device activities unattributed",
              file=sys.stderr)
    else:
        e2e = end_to_end(cell, m.run)
        e2e["setup_s"] = (m.setup_s, "s")
        result["metrics"] = {k: {"value": v, "unit": u}
                             for k, (v, u) in e2e.items()
                             if any(x["name"] == k for x in cell.end_to_end)}
        device_extra = {}
    if dev.type == "cuda":
        result["device"] = dict(devinfo.describe(torch, cell.chips,
                                                 m.memory_peak),
                                **device_extra)
        print(f"card: {devinfo.power_limit()}; HBM peak "
              f"{needs.HBM_BYTES_PER_S:.3e} B/s", file=sys.stderr)
    else:
        result["device"] = {"platform": dev.type, "count": 1,
                            "memory_peak_bytes": 0, **device_extra}
    result["checks"] = check.report(verdict.numbers)
    result["_stderr"] = check.stderr_lines(verdict.numbers)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (REPO / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    _paths()
    from harness.device import RunRefused
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except RunRefused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 3
    found = banned_modules()
    if found:
        print(f"loaded modules that must not be: {found}", file=sys.stderr)
        return 4
    lines = result.pop("_stderr")
    print("\n".join(lines), file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
