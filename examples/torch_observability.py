"""Observability tour on the port: device counters, event log, live
report.

The PyTorch/CUDA counterpart of ``examples/observability.py``. One
watermark-driven run with the full ``repro_torch.obs`` stack attached:

* a :class:`MeteredStream` counts the OFFERED load;
* the runtime's device counters (rows folded inside the ingest, the hot
  loop unchanged) account for every item's fate: accepted / late /
  dropped / replaced, per stratum;
* a :class:`Telemetry` + :class:`EventLog` pair records emissions with
  CI half-widths, watermark closes, controller adaptations and
  checkpoint costs to append-only JSONL;
* the same log then renders three ways: the conservation ledger
  (offered == ingested == accepted + dropped), a Prometheus ``/metrics``
  scrape, and the ``python -m repro_torch.obs.summarize`` run report.

Runs on the card unless ``--device cpu``; ``--chunk`` sets the items per
chunk (the reference's 1,024 by default; the event rate scales with it).
The event log goes to a new directory under the system's temporary
directory.

Run:  PYTHONPATH=src python examples/torch_observability.py --device cpu
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import tempfile

import numpy as np

from repro_torch import prng
from repro_torch.obs import EventLog, Telemetry
from repro_torch.obs import export as obx
from repro_torch.obs import metrics as obm
from repro_torch.obs import summarize
from repro_torch.runtime import Checkpointer
from repro_torch.runtime.executor import PipelinedExecutor, RuntimeConfig
from repro_torch.runtime.registry import QueryRegistry
from repro_torch.stream import (GaussianSource, MeteredStream,
                                ReplayableStream, StreamAggregator)
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunk", type=int, default=1024,
                    help="items per chunk (event rate: 4 chunks per s)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    stream = ReplayableStream(
        StreamAggregator(GaussianSource(), seed=11, device=dev),
        chunk_size=args.chunk, rate=4.0 * args.chunk, disorder=0.3,
        disorder_seed=4)
    registry = (QueryRegistry()
                .register("avg", "mean")
                .register("total", "sum"))
    cfg = RuntimeConfig(num_strata=3, capacity=256, num_intervals=4,
                        interval_span=1.0, allowed_lateness=0.25,
                        emission="watermark")

    log_path = os.path.join(tempfile.mkdtemp(prefix="obs_demo_"),
                            "events.jsonl")
    with EventLog(log_path) as log:
        ex = PipelinedExecutor(cfg, registry, prng.PRNGKey(0), device=dev,
                               checkpointer=Checkpointer(every_chunks=8),
                               telemetry=Telemetry(log))
        metered = MeteredStream(stream.prefix(32))
        ex.run(metered)

        # --- the conservation ledger: offered vs accounted ------------
        c = {k: np.asarray(v)
             for k, v in obm.counters(ex.state.metrics).items()}
        print("=== item accounting (device counters vs metered source) ===")
        print(f"offered   : {metered.items} items in {metered.chunks} "
              f"chunks over {metered.event_span:.2f}s of event time")
        print(f"ingested  : {int(np.sum(c['ingested']))} "
              f"(per stratum {c['ingested'].tolist()})")
        print(f"accepted  : {int(np.sum(c['accepted']))}   "
              f"late: {int(np.sum(c['late']))}   "
              f"dropped: {int(np.sum(c['dropped']))}   "
              f"replaced: {int(np.sum(c['replaced']))}")
        print(f"occupancy : {c['occupancy'].tolist()} "
              f"resident samples per stratum")
        if metered.items != int(np.sum(c["ingested"])) or \
                int(np.sum(c["ingested"])) != (int(np.sum(c["accepted"]))
                                               + int(np.sum(c["dropped"]))):
            raise RuntimeError("the item accounting does not balance")
        print("conservation holds: offered == ingested == "
              "accepted + dropped\n")

        # --- a Prometheus scrape (what /metrics would serve) ----------
        print("=== /metrics (first lines) ===")
        print("\n".join(obx.prometheus_text(ex).splitlines()[:12]), "\n...")

        # hot-loop guarantee, stated with receipts
        print(f"\nhot loop with telemetry attached: trace_count="
              f"{ex.trace_count} (sentinels: "
              + ", ".join(f"{s.name}={s.traces}"
                          for s in ex._sentinels.values()) + ")\n")

    # --- the run report, from the JSONL file ALONE --------------------
    print(f"=== python -m repro_torch.obs.summarize {log_path} ===")
    summarize.main([log_path])


if __name__ == "__main__":
    main()
