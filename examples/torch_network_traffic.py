"""Case study §6.2: real-time network-traffic analytics, on the port.

The PyTorch/CUDA counterpart of ``examples/network_traffic.py``: per-
protocol (TCP/UDP/ICMP) traffic totals over windows of a CAIDA-like
NetFlow replay, comparing StreamApprox (OASRS) against the native
execution and the Spark STS baseline (throughput AND accuracy), then
flow-size percentiles and the top flow-size classes, ranked through
``extract=`` as the reference ranks them. Runs on the card unless
``--device cpu``; ``--items`` sets the items per window (the reference's
65,536 by default).

Run:  PYTHONPATH=src python examples/torch_network_traffic.py --device cpu
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import baselines as bl
from repro_torch.core import error as err
from repro_torch.core import oasrs, query
from repro_torch.stream import NetflowSource, StreamAggregator
from repro_torch.utils import resolve_device

PROTOCOLS = ("TCP", "UDP", "ICMP")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def size_class(v: torch.Tensor) -> torch.Tensor:
    """A flow's size class: ``floor(log2(max(bytes, 1)))``."""
    return torch.floor(torch.log2(torch.clamp(v, min=1.0)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", type=int, default=65_536,
                    help="items per window")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    agg = StreamAggregator(NetflowSource(), seed=7, device=dev)

    state = oasrs.init(3, 2048, prng.PRNGKey(0, device=dev), device=dev)

    def per_protocol_totals(state):
        # SUM of flow bytes per stratum = W_i · Σ sampled bytes
        stats = query.stats(state)
        w = torch.where(stats.counts > stats.taken,
                        stats.counts / torch.clamp(stats.taken, min=1), 1.0)
        return w * stats.sums

    print(f"{'win':>3} {'system':<10} {'TCP(GB)':>9} {'UDP(GB)':>9} "
          f"{'ICMP(GB)':>9} {'total ±bound':>22} {'ms':>7}")
    for epoch in range(4):
        chunk = agg.interval_chunk(epoch, args.items)

        # --- StreamApprox ---
        _sync(dev)
        t0 = time.perf_counter()
        state = oasrs.reset_window(state)
        state = oasrs.update_chunk(state, chunk.stratum_ids, chunk.values)
        totals = per_protocol_totals(state)
        est = query.query_sum(state)
        _sync(dev)
        dt = (time.perf_counter() - t0) * 1e3
        print(f"{epoch:3d} {'oasrs':<10} "
              + " ".join(f"{float(t) / 1e9:9.3f}" for t in totals)
              + f" {float(est.value) / 1e9:10.3f}"
                f"±{float(est.error_bound(0.95)) / 1e9:.3f}GB {dt:7.1f}")

        # --- native (exact) ---
        t0 = time.perf_counter()
        stats = query.exact_stats(chunk.values, chunk.stratum_ids, 3)
        exact = err.estimate_sum(stats)
        _sync(dev)
        dt = (time.perf_counter() - t0) * 1e3
        print(f"{epoch:3d} {'native':<10} "
              + " ".join(f"{float(s) / 1e9:9.3f}" for s in stats.sums)
              + f" {float(exact.value) / 1e9:10.3f}"
                f"±0.000GB {dt:7.1f}")

        # --- Spark STS baseline (2-pass, synchronizing) ---
        t0 = time.perf_counter()
        gc = bl.sts_counts(chunk.stratum_ids, 3)
        s = bl.sts_sample(prng.PRNGKey(epoch, device=dev),
                          chunk.stratum_ids, gc, 0.3)
        sts_est = err.estimate_sum(
            bl.sample_stats(chunk.values, chunk.stratum_ids, s, 3, gc))
        _sync(dev)
        dt = (time.perf_counter() - t0) * 1e3
        print(f"{epoch:3d} {'sts':<10} {'':>29} "
              f"{float(sts_est.value) / 1e9:10.3f}"
              f"±{float(sts_est.error_bound(0.95)) / 1e9:.3f}GB {dt:7.1f}")

        # --- nonlinear queries: flow-size percentiles + top talkers ---
        qs = (0.5, 0.9, 0.99)
        t0 = time.perf_counter()
        q_est = query.query_quantile(state, qs, num_replicates=32)
        _sync(dev)
        dt = (time.perf_counter() - t0) * 1e3
        exact_q = np.quantile(chunk.values.cpu().numpy(), qs)
        line = "  ".join(
            f"p{int(q * 100)}={float(v) / 1e3:.1f}"
            f"±{float(b) / 1e3:.1f}KB (exact {e / 1e3:.1f})"
            for q, v, b, e in zip(qs, q_est.value,
                                  q_est.error_bound(0.95), exact_q))
        print(f"{epoch:3d} {'quantiles':<10} {line} {dt:7.1f}ms")

        # Heavy hitters over coarse flow-size classes (log2 buckets): the
        # Eq. 6-bounded COUNT of the k most frequent classes.
        t0 = time.perf_counter()
        hh = query.query_heavy_hitters(state, 3, extract=size_class)
        _sync(dev)
        dt = (time.perf_counter() - t0) * 1e3
        line = "  ".join(
            f"2^{int(k)}B×{float(v) / 1e3:.1f}k"
            f"±{float(b) / 1e3:.1f}k"
            for k, v, b in zip(hh.keys, hh.estimate.value,
                               hh.estimate.error_bound(0.95)))
        print(f"{epoch:3d} {'top-sizes':<10} {line} {dt:7.1f}ms")


if __name__ == "__main__":
    main()
