"""The control of the comparison, and the program's own readings, over
many seeds in one process: the two readings each limit is set between.

    python3 streambench/control.py --workload <cell> --seconds <s> \
        --seeds 1 2 3 ... [--dtype bfloat16]

For each seed the cell runs once as ``run.py`` runs it (a short window)
and its output is compared with the reference twice: as the program gave
it, and with the reference computed in the nearest precision below the
configuration's float32 (bfloat16) put in the program's place. Prints
one JSON line per seed and a summary: the largest program reading and
the smallest control reading of each number compared.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))


def readings(cell: str, seeds: list, seconds: float,
             dtype: str = "bfloat16") -> dict:
    """Per seed, the numbers compared for the program and for the
    control."""
    import time

    import torch
    from harness import cells, check, device, session

    out = {}
    for seed in seeds:
        c = cells.resolve(cell)
        m = session.measure(c, seed, seconds, False, device.card(c.chips),
                            time.perf_counter())
        routed = check.route(c, m.pool, seed, m.run.chunks)
        prog = check.compare(c, m.pool, seed, m.run, m.final,
                             routed).numbers
        ctrl = check.compare(c, m.pool, seed, m.run, m.final, routed,
                             control_dtype=getattr(torch, dtype)).numbers
        out[seed] = {
            "program": dict({k: v for k, (v, _) in prog.items()},
                            correct=check.passed(prog)),
            "control": dict({k: v for k, (v, _) in ctrl.items()},
                            correct=check.passed(ctrl))}
        del m, routed
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args()
    out = readings(args.workload, args.seeds, args.seconds,
                   dtype=args.dtype)
    for seed, r in out.items():
        print(json.dumps({"seed": seed, **r}))
    names = [k for k in next(iter(out.values()))["program"]
             if k != "correct"]
    summary = {n: {"program_max": max(r["program"][n] for r in out.values()),
                   "control_min": min(r["control"][n]
                                      for r in out.values())}
               for n in names}
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
