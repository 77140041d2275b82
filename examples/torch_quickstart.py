"""Quickstart: approximate stream analytics in 60 lines, on the port.

The PyTorch/CUDA counterpart of ``examples/quickstart.py``: samples a
skewed 3-sub-stream Gaussian stream with OASRS, answers SUM/MEAN/COUNT
queries with rigorous error bounds, and shows the adaptive feedback loop
(paper Algorithm 2). Runs on the card unless ``--device cpu``;
``--items`` sets the window's size (the reference's 65,536 by default).

Run:  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import torch

from repro_torch import prng
from repro_torch.core import adaptive, oasrs, query
from repro_torch.stream import GaussianSource, StreamAggregator, skewed
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", type=int, default=65_536,
                    help="items per window")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. A stream with three sub-streams (80% / 19% / 1% arrival shares,
    #    heavy values concentrated in the rare sub-stream).
    agg = StreamAggregator(skewed(GaussianSource(), (0.8, 0.19, 0.01)),
                           seed=0, device=dev)

    # 2. OASRS state: reservoir of 256 per stratum (≈1.2% of the window).
    state = oasrs.init(num_strata=3, capacity=256,
                       key=prng.PRNGKey(42, device=dev),
                       payload_spec=oasrs.PayloadSpec((), torch.float32),
                       device=dev)

    budget = adaptive.accuracy_budget(target_half_width=5.0,
                                      confidence=0.95)

    for epoch in range(5):
        chunk = agg.interval_chunk(epoch, args.items)
        state = oasrs.reset_window(state)
        state = oasrs.update_chunk(state, chunk.stratum_ids, chunk.values)

        s = query.query_sum(state)
        m = query.query_mean(state)
        c = query.query_count(state, lambda v: v > 5000.0)
        exact_sum = float(torch.sum(chunk.values))

        print(f"window {epoch}: SUM={float(s.value):12.0f} "
              f"± {float(s.error_bound(0.95)):8.0f} "
              f"(exact {exact_sum:12.0f})   "
              f"MEAN={float(m.value):8.2f} ± "
              f"{float(m.error_bound(0.95)):5.2f}   "
              f"COUNT(v>5k)={float(c.value):9.0f} "
              f"± {float(c.error_bound(0.95)):7.0f}")

        # 3. Adaptive feedback: resize next window's reservoirs to hit the
        #    accuracy budget (Neyman allocation from observed spreads).
        stats = query.stats(state)
        new_cap = adaptive.next_capacity(budget, stats, realized=m)
        state = oasrs.OASRSState(values=state.values, counts=state.counts,
                                 capacity=torch.clamp(
                                     new_cap, max=state.max_capacity),
                                 key=state.key)
        share = float(torch.sum(torch.clamp(new_cap, max=256)))
        print(f"          adaptive capacities → {new_cap.tolist()} "
              f"(sampling {100.0 * share / args.items:.1f}% next window)")


if __name__ == "__main__":
    main()
