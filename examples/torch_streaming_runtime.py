"""Streaming runtime demo on the port: standing queries over a live
netflow stream.

The PyTorch/CUDA counterpart of ``examples/streaming_runtime.py``.
Registers four standing queries once, then serves them continuously from
BOTH execution modes (batched, the Spark-Streaming analog, and
pipelined, the Flink analog) over the same out-of-order event-time
stream, printing per-emission answers with error bounds plus the
watermark accounting (on-time / late / dropped) and the backpressure
controller's capacity. Then a crash-recovery demo: kill mid-stream,
restore the latest serialized checkpoint into a fresh executor, replay
the suffix, and show that the answers match an uninterrupted run
bitwise, with the recovery latency read back off the recovering
process's own event log (``repro_torch.obs``). Ends with a sessionized
demo: watermark-driven emission over bursty per-key traffic, with
per-key tumbling panes and gap-timeout session windows answered from the
same ring.

Runs on the card unless ``--device cpu``; ``--chunk`` sets the items per
chunk (the reference's 2,048 by default; the event rate scales with it,
so the windows hold the same number of chunks).

Run:  PYTHONPATH=src python examples/torch_streaming_runtime.py --device cpu
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import dataclasses
import time

from repro_torch import prng
from repro_torch.core import adaptive
from repro_torch.obs import EventLog, Telemetry
from repro_torch.runtime import Checkpointer
from repro_torch.runtime.controller import ControllerConfig
from repro_torch.runtime.executor import (BatchedExecutor,
                                          PipelinedExecutor, RuntimeConfig)
from repro_torch.runtime.records import (perturb_event_times,
                                         timestamped_stream)
from repro_torch.runtime.registry import QueryRegistry
from repro_torch.stream import (NetflowSource, ReplayableStream,
                                StreamAggregator)
from repro_torch.utils import resolve_device

CHUNKS = 24           # 4 live 1s intervals of traffic at 6 chunks/s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunk", type=int, default=2048,
                    help="items per chunk (event rate: 6 chunks per s)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    chunk, rate = args.chunk, 6.0 * args.chunk

    agg = StreamAggregator(NetflowSource(), seed=23, device=dev)
    chunks = list(timestamped_stream(agg, chunk, CHUNKS, rate))
    # Event-time disorder bounded by 0.3s; lateness budget absorbs most.
    chunks = perturb_event_times(chunks, prng.PRNGKey(1, device=dev),
                                 max_displacement=0.3)

    registry = (QueryRegistry()
                .register("bytes", "sum")
                .register("mean_flow", "mean")
                .register("p99", "quantile", qs=(0.99,), num_replicates=16)
                .register("elephants", "count",
                          predicate=lambda x: x > 1e5))
    cfg = RuntimeConfig(
        num_strata=3, capacity=512, num_intervals=4, interval_span=1.0,
        allowed_lateness=0.25, batch_chunks=6, emit_every=6,
        accuracy_query="mean_flow",
        controller=ControllerConfig(
            budget=adaptive.accuracy_budget(50.0, max_per_stratum=2048),
            latency_budget_s=0.25))

    for make in (BatchedExecutor, PipelinedExecutor):
        ex = make(cfg, registry, prng.PRNGKey(0), device=dev)
        print(f"\n=== {ex.mode} executor ===")
        for em in ex.run(chunks):
            mean = em.results["mean_flow"]
            p99 = em.results["p99"]
            lo, hi = mean.interval(0.95)
            print(f"emit {em.index}: watermark={em.watermark:6.2f}s  "
                  f"mean={float(mean.value):9.1f}B "
                  f"[{float(lo):9.1f}, {float(hi):9.1f}]  "
                  f"p99={float(p99.value[0]):10.1f}B  "
                  f"elephants≈{float(em.results['elephants'].value):8.0f}  "
                  f"late={em.late} dropped={em.dropped}  "
                  f"cap={[int(c) for c in em.capacity]}  "
                  f"step={em.latency_s * 1e3:.1f}ms")
        final = ex.query()
        print(f"final windowed bytes ≈ {float(final['bytes'].value):.3e} "
              f"± {float(final['bytes'].error_bound(0.95)):.2e} (95%)")

    crash_recovery_demo(registry, cfg, dev, chunk, rate)
    sessionized_demo(dev, chunk // 2)


def sessionized_demo(dev, chunk):
    """Watermark-driven emission + session/per-key windows: user class 1
    sends in 1.5s bursts separated by 2.5s of silence; answers for each
    1s interval fire exactly when its watermark closes it."""
    print("\n=== sessionized traffic (watermark-driven emission) ===")
    stream = ReplayableStream(
        StreamAggregator(NetflowSource(), seed=29, device=dev),
        chunk_size=chunk, rate=4.0 * chunk, disorder=0.2, disorder_seed=7,
        key_gaps=((1, 1.5, 2.5),))
    registry = (QueryRegistry()
                .register("bytes", "sum")
                .register("key_bytes", "sum", window="per_key")
                .register("sess_mean", "mean", window="session",
                          session_gap=1.0))
    cfg = RuntimeConfig(num_strata=3, capacity=512, num_intervals=6,
                        interval_span=1.0, allowed_lateness=0.25,
                        emission="watermark", batch_chunks=2)
    ex = PipelinedExecutor(cfg, registry, prng.PRNGKey(0), device=dev)
    for em in ex.run(stream.prefix(28)):
        kb = [f"{float(v):9.3e}" for v in em.results["key_bytes"].value]
        sm = [f"{float(v):7.1f}" for v in em.results["sess_mean"].value]
        print(f"interval {em.interval} closed @ watermark="
              f"{em.watermark:5.2f}s (emission #{em.index}): "
              f"bytes={float(em.results['bytes'].value):.3e}  "
              f"per-key={kb}  session-mean={sm}")
    print("(key 1's session mean goes quiet between bursts — the gap "
          "timeout cuts old bursts out of its current session)")


def crash_recovery_demo(registry, cfg, dev, chunk, rate):
    """Kill an executor mid-stream, recover from the serialized
    checkpoint, replay the suffix — answers match bitwise."""
    print("\n=== crash recovery (exactly-once) ===")
    # Accuracy feedback is deterministic; wall-clock backpressure is
    # not, so bitwise replay demos run without a latency budget.
    cfg = dataclasses.replace(
        cfg, controller=dataclasses.replace(cfg.controller,
                                            latency_budget_s=None))
    # The stream must be offset-addressable so a fresh process can
    # regenerate the suffix; disorder is keyed by absolute offset too.
    stream = ReplayableStream(
        StreamAggregator(NetflowSource(), seed=23, device=dev),
        chunk_size=chunk, rate=rate, disorder=0.3, disorder_seed=1)
    reference = PipelinedExecutor(cfg, registry, prng.PRNGKey(0),
                                  device=dev)
    ref = reference.run(stream.prefix(CHUNKS))

    ck = Checkpointer(every_chunks=6)
    victim = PipelinedExecutor(cfg, registry, prng.PRNGKey(0), device=dev,
                               checkpointer=ck)
    crash_after = 17
    for e in range(crash_after):
        victim.push(stream.chunk_at(e))
    print(f"CRASH after chunk {crash_after}; latest checkpoint at offset "
          f"{ck.latest_offset} ({len(ck.latest) / 1024:.1f} KiB survives)")

    # The recovering process carries an event log: restore time and the
    # replayed suffix are operator-visible, not just demo prints.
    log = EventLog()
    fresh = PipelinedExecutor(cfg, registry, prng.PRNGKey(42), device=dev,
                              telemetry=Telemetry(log))
    t0 = time.perf_counter()
    fresh.restore(ck.latest)                 # any key — state is overwritten
    for e in range(fresh.chunks_pushed, CHUNKS):
        fresh.push(stream.chunk_at(e))
    recovered = fresh.finalize()
    total_s = time.perf_counter() - t0
    restore_ev = log.of_type("checkpoint_restore")[-1]
    print(f"recovery latency: restore {restore_ev['restore_s'] * 1e3:.1f}ms "
          f"(from the checkpoint_restore event) + replay of "
          f"{CHUNKS - restore_ev['stream_offset']} chunks "
          f"= {total_s * 1e3:.1f}ms total")

    a, b = ref[-1], recovered[-1]
    same = (float(a.results["bytes"].value) == float(b.results["bytes"].value)
            and (a.on_time, a.late, a.dropped) ==
                (b.on_time, b.late, b.dropped))
    print(f"replayed chunks {ck.latest_offset}..{CHUNKS}; final emission "
          f"#{b.index}: bytes={float(b.results['bytes'].value):.6e} "
          f"late={b.late} dropped={b.dropped}")
    print("recovered run == uninterrupted run (bitwise):", same)
    if not same:
        raise RuntimeError("the recovered run differs from the "
                           "uninterrupted one")


if __name__ == "__main__":
    main()
