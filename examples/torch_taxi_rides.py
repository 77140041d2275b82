"""Case study §6.3: NYC taxi-ride analytics, on the port.

The PyTorch/CUDA counterpart of ``examples/taxi_rides.py``: average trip
distance per borough over a sliding window (w=2 intervals, slide=1),
with 95% error bounds (the paper's Figure 10 query). Runs on the card
unless ``--device cpu``; ``--items`` sets the items per slide (the
reference's 32,768 by default).

Run:  PYTHONPATH=src python examples/torch_taxi_rides.py --device cpu
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np

from repro_torch import prng
from repro_torch.core import oasrs, window
from repro_torch.stream import StreamAggregator, TaxiSource
from repro_torch.utils import resolve_device

BOROUGHS = ("Manhattan", "Brooklyn", "Queens", "Bronx", "StatenIs",
            "Newark")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", type=int, default=32_768,
                    help="items per slide")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    agg = StreamAggregator(TaxiSource(), seed=11, device=dev)
    win = window.init(2, 6, 512, prng.PRNGKey(0, device=dev), device=dev)

    def slide(win, values, sids, key):
        iv = oasrs.init(6, 512, key, device=dev)
        iv = oasrs.update_chunk(iv, sids, values)
        return window.slide(win, iv)

    header = " ".join(f"{b:>10}" for b in BOROUGHS)
    print(f"{'slide':>5} {header}")
    for epoch in range(6):
        chunk = agg.interval_chunk(epoch, args.items)
        win = slide(win, chunk.values, chunk.stratum_ids,
                    prng.fold_in(prng.PRNGKey(1, device=dev), epoch))
        # per-borough mean distance over the merged window strata
        stats = window.window_stats(win)
        k = 6
        # fold the (interval × borough) cells back to boroughs
        sums = stats.sums.cpu().numpy().reshape(-1, k).sum(0)
        taken = stats.taken.cpu().numpy().reshape(-1, k).sum(0)
        means = sums / np.maximum(taken, 1)
        line = " ".join(f"{m:7.2f} mi" for m in means)
        print(f"{epoch:5d} {line}")
    est = window.query_mean(win)
    print(f"\nwindowed overall mean distance: {float(est.value):.3f} mi "
          f"± {float(est.error_bound(0.95)):.3f} (95% CI)")


if __name__ == "__main__":
    main()
