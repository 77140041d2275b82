#!/usr/bin/env python3
"""Time chip_smoke.py's serve and train phases for two trees in turns on
one NVIDIA card.

    python3 chip_compare.py OTHER_TREE

``OTHER_TREE`` is another tree of this repo, e.g. a parent commit
unpacked by ``git archive`` into a directory that ``.gitignore`` lists;
``B`` is the tree this script is in. The runs go A, B, B, A; each runs
both phases of its tree in a process of its own, which puts the tree's
``src`` first on ``sys.path``, loads its ``chip_smoke.py`` and builds its
kernels. Each run prints one ``SUMMARY`` line of JSON (the phases'
decode, prefill and step times, host ops, busy share, peak memory);
together they go to ``chiprun_out/chip_compare.json``. Imports no JAX.
Exits non-zero if any run failed, or when there is no card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SERVE_KEYS = ("decode_median_ms", "decode_min_ms", "decode_max_ms",
              "prefill_ms", "tokens_per_s", "decode_host_ops",
              "decode_device_busy_ms", "decode_busy_share", "peak_bytes")
TRAIN_KEYS = ("step_median_ms", "step_min_ms", "step_max_ms",
              "update_median_ms", "tokens_per_s", "host_ops",
              "busy_share", "peak_bytes", "losses")
ORDER = "ABBA"


def run_tree(tree: Path) -> dict:
    """The phases of ``tree``'s chip_smoke.py, in this process."""
    import torch
    sys.path.insert(0, str(tree / "src"))
    spec = importlib.util.spec_from_file_location("tree_chip_smoke",
                                                  tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.ROOT = tree
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.phase_build()
    out = dict(tree=str(tree), card=cs.card())
    t0 = time.perf_counter()
    r = cs.phase_serve(torch, 0, dev)
    out["serve"] = {k: r[k] for k in SERVE_KEYS}
    r = cs.phase_train(torch, 0, dev)
    out["train"] = {k: r[k] for k in TRAIN_KEYS}
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="the other tree (A)")
    ap.add_argument("--child", action="store_true",
                    help="run the phases of OTHER in this process")
    args = ap.parse_args(argv)
    if args.child:
        print("SUMMARY " + json.dumps(run_tree(args.other.resolve()),
                                      default=str), flush=True)
        return 0

    import torch
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 2
    trees = {"A": args.other.resolve(), "B": ROOT}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    runs, rc = [], 0
    for i, letter in enumerate(ORDER):
        tree = trees[letter]
        log = out_dir / f"chip_compare_{i}_{letter}.log"
        with open(log, "w") as f:
            p = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), str(tree),
                 "--child"],
                stdout=f, stderr=subprocess.STDOUT, cwd=tree)
        lines = [ln for ln in log.read_text().splitlines()
                 if ln.startswith("SUMMARY ")]
        if p.returncode or not lines:
            print(f"chip_compare: run {i} ({letter}, {tree}) failed with "
                  f"{p.returncode}; see {log}", flush=True)
            rc = 1
            continue
        summary = dict(json.loads(lines[-1][len("SUMMARY "):]), run=i,
                       letter=letter)
        runs.append(summary)
        print(json.dumps(summary), flush=True)
    (out_dir / "chip_compare.json").write_text(json.dumps(runs, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
