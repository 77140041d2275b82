#!/usr/bin/env python3
"""Time chip_smoke.py's phases for two trees in turns on one NVIDIA
card: serve and train, or the rows of phase large_keys with the sliding
deployment's onekernel executor.

    python3 chip_compare.py OTHER_TREE [--phases serve_train|large_keys]

``OTHER_TREE`` is another tree of this repo, e.g. a parent commit
unpacked by ``git archive`` into a directory that ``.gitignore`` lists;
``B`` is the tree this script is in. The runs go A, B, B, A; each runs
the phases of its tree in a process of its own, which puts the tree's
``src`` first on ``sys.path``, loads its ``chip_smoke.py`` and builds its
kernels. Each run prints one ``SUMMARY`` line of JSON (serve and train:
the decode, prefill and step times, host ops, busy share, peak memory;
large_keys: each case's device ms, kernels per call, per-launch split and
bound, the stats' and histogram's flat calls past their caps with row
and random ids (``reduce_rows``), the small-form fold's split at the
main path's chunk, the
executor's device ms per chunk on its onekernel and masked
paths (``lk_chunk_device_ms``) and, in a tree that batches the one-shot
over shards, the batched call against W unbatched calls at each
``SHARD_ONE_SHOT`` case, and in a tree that batches the fold over a
masked chunk's W·K folds, that call against W·K unbatched calls at each
``FOLD_BATCH_TURNS`` case); together they go to
``chiprun_out/chip_compare.json``. Imports no JAX. Exits non-zero if any
run failed, or when there is no card.
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
LARGE_KEYS = ("kernel", "case", "shape", "device_ms", "events_ms",
              "kernels", "memsets", "split", "bound_ms", "bytes")
REDUCE_KEYS = ("device_ms", "events_ms", "kernels", "memsets", "split",
               "bound_ms", "bytes")


def rel_err(a, b) -> float:
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


def reduce_rows(torch, cs, dev) -> list:
    """The stats' and histogram's flat calls at phase large_keys' cases
    (``LK_STATS``, ``LK_WHIST``), past their caps, on the emission's view
    with row ids and with ids drawn at random, each through the tree's
    own wrapper (in a tree before the parted form, its radix-sorted
    form): checked against the plain version (counts bit for bit, sums
    within ``STATS_RTOL``) and timed (``lk_timed``), from one generator
    seeded as the phase seeds it, so both trees see the same inputs."""
    from repro_torch.core.quantile import _unit_edges
    from repro_torch.kernels import ref, stratified_stats as sk
    from repro_torch.kernels import weighted_hist as wk
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.TIMING_SEED)
    out = []

    def row(kernel, case, ids, got, want, fn, need):
        ci = 0 if kernel == "stats" else len(got) - 1
        ok = torch.equal(got[ci], want[ci]) and all(
            rel_err(a, b) <= cs.STATS_RTOL
            for i, (a, b) in enumerate(zip(got, want)) if i != ci)
        t = cs.lk_timed(torch, f"compare {kernel} {case} {ids}", fn, need)
        out.append(dict(kernel=kernel, case=case, ids=ids, ok=ok,
                        **{k: t[k] for k in REDUCE_KEYS}))
        if not ok:
            raise RuntimeError(f"{kernel} {case} {ids}: differs from its "
                               "plain version")

    for case, g, n in cs.LK_STATS:
        x, sid, mask = cs.rows_view(torch, gen, g, n)
        rand = torch.randint(0, g, sid.shape, generator=gen, device=dev,
                             dtype=torch.int32)
        for ids, s in (("rows", sid), ("random", rand)):
            row("stats", case, ids, sk.stratified_stats(x, s, mask, g),
                ref.stratified_stats(x, s, mask, g),
                lambda s=s: sk.stratified_stats(x, s, mask, g),
                cs.stats_need(torch, x, s, mask, g)["bytes"])
    for case, g, b, n in cs.LK_WHIST:
        x, cell, mask = cs.rows_view(torch, gen, g, n)
        rw = 1.0 + 3.0 * torch.rand(g, generator=gen, device=dev)
        rand = torch.randint(0, g, cell.shape, generator=gen, device=dev,
                             dtype=torch.int32)
        lo, hi = float(x[mask].min()), float(x[mask].max())
        edges = lo + (hi - lo) * _unit_edges(b, dev)
        for ids, c in (("rows", cell), ("random", rand)):
            w = rw[c.long()]
            row("whist", case, ids, wk.weighted_hist(x, c, w, mask, edges, g),
                ref.weighted_hist(x, c, w, mask, edges, g),
                lambda c=c, w=w: wk.weighted_hist(x, c, w, mask, edges, g),
                cs.whist_need(torch, x, c, w, mask, edges, g)["bytes"])
    return out
ORDER = "ABBA"
PHASES = ("serve_train", "large_keys")


def large_keys_rows(torch, cs, dev) -> dict:
    """The fold and one-shot rows of phase large_keys (``LK_FOLD``,
    ``LK_ONE_SHOT``): each checked against its plain version and timed by
    the tree's own ``large_fold`` / ``large_one_shot``, from one
    generator seeded as the phase seeds it; the stats' and histogram's
    flat rows (:func:`reduce_rows`); the small-form fold at the
    main path's chunk (``fold_timing``); the sliding deployment's
    onekernel and masked executors, device ms per chunk
    (``lk_chunk_device_ms``); and where the tree has them, the batched
    one-shot's turns (``one_shot_shard_turns`` at ``SHARD_ONE_SHOT``) and
    the batched fold's (``fold_batch_turns`` at ``FOLD_BATCH_TURNS``)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.TIMING_SEED)
    rows = [cs.large_fold(torch, gen, *c) for c in cs.LK_FOLD]
    rows += [cs.large_one_shot(torch, gen, *c) for c in cs.LK_ONE_SHOT]
    out = dict(rows=[{k: r[k] for k in LARGE_KEYS} for r in rows])
    torch.cuda.empty_cache()
    out["reduce_rows"] = reduce_rows(torch, cs, dev)
    torch.cuda.empty_cache()
    small = cs.fold_timing(torch, dev)
    out["small_fold"] = dict(ms=small["ms"], split={
        k: v[0] for k, v in small["prof"].items()})
    chunks = cs.lk_chunks(torch, 26)
    for ingest in ("onekernel", "masked"):
        out[f"{ingest}_chunk"] = cs.lk_chunk_device_ms(torch, dev, ingest,
                                                       chunks)
    if hasattr(cs, "one_shot_shard_turns"):
        out["shard_turns"] = [cs.one_shot_shard_turns(torch, gen, *c)
                              for c in cs.SHARD_ONE_SHOT]
    if hasattr(cs, "fold_batch_turns"):
        out["fold_batch_turns"] = [cs.fold_batch_turns(torch, gen, *c)
                                   for c in cs.FOLD_BATCH_TURNS]
    return out


def run_tree(tree: Path, phases: str) -> dict:
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
    if phases == "large_keys":
        out["large_keys"] = large_keys_rows(torch, cs, dev)
    else:
        r = cs.phase_serve(torch, 0, dev)
        out["serve"] = {k: r[k] for k in SERVE_KEYS}
        r = cs.phase_train(torch, 0, dev)
        out["train"] = {k: r[k] for k in TRAIN_KEYS}
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="the other tree (A)")
    ap.add_argument("--phases", choices=PHASES, default=PHASES[0],
                    help="serve and train (default), or the rows of "
                         "phase large_keys")
    ap.add_argument("--child", action="store_true",
                    help="run the phases of OTHER in this process")
    args = ap.parse_args(argv)
    if args.child:
        print("SUMMARY " + json.dumps(run_tree(args.other.resolve(),
                                               args.phases),
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
                 "--child", "--phases", args.phases],
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
