"""The system under test, built from a cell: the port's
``PipelinedExecutor`` with the cell's standing queries, fed the pooled
chunks. Everything the benchmark takes from the program passes here."""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
COUNTERS = ("ingested", "accepted", "late", "dropped")


def registry(queries: list):
    from repro_torch.runtime.registry import QueryRegistry
    reg = QueryRegistry()
    for q in queries:
        kw = {"window": q.get("window", "merged")}
        if "gt" in q:
            kw["predicate"] = (lambda x, t=float(q["gt"]): x > t)
        reg.register(q["name"], q["kind"], **kw)
    return reg


def executor(cell, seed: int, device):
    """A fresh executor whose key is the seed's: ``[0, seed mod 2**32]``
    (two u32 words)."""
    from repro_torch.runtime.executor import PipelinedExecutor, RuntimeConfig
    c, m = cell.config, cell.mix
    if c["executor"] != "pipelined":
        raise ValueError(f"executor {c['executor']!r} has no driver here")
    cfg = RuntimeConfig(
        num_strata=cell.num_strata, capacity=cell.capacity,
        num_intervals=c["num_intervals"],
        interval_span=c["interval_span_s"],
        allowed_lateness=c["allowed_lateness_s"],
        num_shards=c["num_shards"], ingest=c["ingest"],
        emission=m["emission"], emit_every=m["emit_every"])
    key = torch.tensor([0, int(seed) & MASK32], dtype=torch.int64)
    return PipelinedExecutor(cfg, registry(cell.queries), key,
                             device=device)


def chunk(values, sids, times, mask):
    from repro_torch.runtime.records import TimestampedChunk
    return TimestampedChunk(values=values, stratum_ids=sids, times=times,
                            mask=mask)


def answers(em) -> dict:
    """One emission's answers as host numbers: per query its values and
    95% half-widths (lists), read back in one copy."""
    names = list(em.results)
    parts = [(em.results[n].value.reshape(-1),
              em.results[n].variance.reshape(-1)) for n in names]
    flat = torch.stack([torch.cat([p[0] for p in parts]),
                        torch.cat([p[1] for p in parts])]).cpu().numpy()
    out, at = {}, 0
    for n, (v, _) in zip(names, parts):
        k = v.numel()
        var = flat[1, at:at + k].astype(np.float64)
        out[n] = (flat[0, at:at + k].astype(np.float64).tolist(),
                  (2.0 * np.sqrt(np.maximum(var, 0.0))).tolist())
        at += k
    return out


def snapshot(ex) -> dict:
    """The sample as the window left it after a push, copied on the card
    without a wait: the ring's values, the cell counts and the slot
    table."""
    st = ex.state
    return {"values": st.window.intervals.values.clone(),
            "counts": st.window.intervals.counts.clone(),
            "slots": st.slot_interval.clone()}


def final_state(ex) -> dict:
    """What the comparison reads of the state after the window: the
    per-stratum counters (u32 words), the cell counts and slot table."""
    st = ex.state
    out = {n: (getattr(st.metrics, n).cpu().numpy().astype(np.int64)
               & MASK32) for n in COUNTERS}
    out["counts"] = st.window.intervals.counts.cpu().numpy().astype(
        np.int64)
    out["slots"] = tuple(int(x) for x in st.slot_interval.cpu().tolist())
    out["chunks"] = int(st.metrics.chunks.item()) & MASK32
    return out
