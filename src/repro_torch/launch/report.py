"""Render the dry-run and roofline records as markdown tables.

Counterpart of the reference's ``launch/report.py``: the same three
tables (dry-run per mesh, roofline terms, hillclimb records), string for
string on the same records. The port's dry-run records carry
``trace_sec`` where the reference's carry ``compile_sec``; the dry-run
table's time column is headed and filled by whichever the records hold.

Usage: PYTHONPATH=src python -m repro_torch.launch.report [--dir results]
"""
from __future__ import annotations

import json


def _load(path):
    try:
        return [json.loads(l) for l in open(path)]
    except FileNotFoundError:
        return []


def _fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1000:
            return f"{b:.1f}{unit}"
        b /= 1000
    return f"{b:.1f}PB"


def _time_key(rows) -> str:
    """``trace_sec`` for the port's records, ``compile_sec`` for the
    reference's."""
    return ("trace_sec" if any("trace_sec" in r for r in rows)
            else "compile_sec")


def dryrun_table(path: str, title: str) -> str:
    rows = _load(path)
    tkey = _time_key(rows)
    out = [f"### {title}", "",
           f"| arch | shape | status | {tkey.split('_')[0]} s | args/dev | "
           "temp/dev | flops/dev | coll bytes/dev | collective ops |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "OK":
            reason = r.get("reason", r.get("error", ""))[:60]
            out.append(f"| {r['arch']} | {r['shape']} | {r['status']} | "
                       f"— | — | — | — | — | {reason} |")
            continue
        mem = r["memory"]
        cc = r.get("collective_counts", {})
        ops = " ".join(f"{k.split('-')[-1][:4]}:{v}"
                       for k, v in cc.items() if v)
        out.append(
            f"| {r['arch']} | {r['shape']} | OK | {r[tkey]} | "
            f"{_fmt_bytes(mem['argument_bytes'])} | "
            f"{_fmt_bytes(mem['temp_bytes'])} | "
            f"{r['flops_per_device']:.2e} | "
            f"{_fmt_bytes(r['collective_bytes_per_device'])} | {ops} |")
    return "\n".join(out)


_LEVERS = {
    "memory": "cut activation materialization (remat policy, SP residual, "
              "logit chunking, fused elementwise)",
    "collective": "reduce TP exchange (pure-DP for small models, dispatch "
                  "locality, shard_map all-to-alls, compute/comm overlap)",
    "compute": "remove replicated/recomputed matmuls (sharding mode, "
               "remat policy)",
}


def roofline_table(path: str) -> str:
    rows = _load(path)
    out = ["### Roofline terms (single-pod 16×16, per device; probe-"
           "extrapolated — see methodology)", "",
           "| arch | shape | compute s | memory s | collective s | "
           "bottleneck | MODEL/HLO flops | roofline frac | "
           "what moves the dominant term |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("status") != "OK":
            reason = r.get("reason", r.get("error", ""))[:60]
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"{r.get('status')} | — | — | {reason} |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_sec']:.4f} | "
            f"{r['memory_sec']:.4f} | {r['collective_sec']:.4f} | "
            f"**{r['bottleneck']}** | {r['model_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.4f} | "
            f"{_LEVERS.get(r['bottleneck'], '')} |")
    return "\n".join(out)


def hillclimb_table(path: str = "results/hillclimb.jsonl") -> str:
    rows = _load(path)
    if not rows:
        return ""
    out = ["### §Perf hillclimb records (probe-measured variants)", "",
           "| cell | iteration | compute s | memory s | collective s | "
           "MODEL/HLO | roofline frac |",
           "|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} × {r['shape']} | {r.get('label', '?')} | "
            f"{r['compute_sec']:.4f} | {r['memory_sec']:.4f} | "
            f"{r['collective_sec']:.4f} | {r['model_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.4f} |")
    return "\n".join(out)


def main(argv=None):
    import argparse
    import os
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results",
                    help="holds dryrun_16x16.jsonl, dryrun_2x16x16.jsonl, "
                         "roofline.jsonl, hillclimb.jsonl")
    args = ap.parse_args(argv)
    print(dryrun_table(os.path.join(args.dir, "dryrun_16x16.jsonl"),
                       "Dry-run — single pod (16, 16) = 256 chips"))
    print()
    print(dryrun_table(os.path.join(args.dir, "dryrun_2x16x16.jsonl"),
                       "Dry-run — multi-pod (2, 16, 16) = 512 chips"))
    print()
    print(roofline_table(os.path.join(args.dir, "roofline.jsonl")))
    print()
    print(hillclimb_table(os.path.join(args.dir, "hillclimb.jsonl")))


if __name__ == "__main__":
    main()
