"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
False. This file imports neither JAX nor the reference package, so it
runs on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda.py

It also holds the numpy input makers that ``test_torch_kernels.py``
shares.
"""
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.kernels import (one_shot, ops, ref, reservoir,
                                 stratified_stats, weighted_hist)
from repro_torch.runtime import convert
from repro_torch.runtime import executor as tex
from repro_torch.runtime import registry as treg
from repro_torch.runtime.records import TimestampedChunk

#: phase -> (initial counts, capacity) for S = 4 strata, N_max = 64.
PHASES = {
    "filling": ([0, 0, 0, 0], [64, 32, 16, 8]),
    "crossing": ([10, 30, 14, 0], [16, 32, 16, 8]),
    "replacement": ([100, 400, 70, 9], [16, 64, 5, 8]),
}


def fold_inputs(seed, m, counts, capacity, mask_p=0.9, s=4, n_max=64):
    """numpy inputs of one fold: a chunk, counts, capacity and a ring."""
    rng = np.random.default_rng(seed)
    return dict(
        stratum_ids=rng.integers(0, s, m).astype(np.int32),
        payload=rng.normal(100.0, 30.0, m).astype(np.float32),
        u_accept=rng.random(m, dtype=np.float32),
        u_slot=rng.random(m, dtype=np.float32),
        mask=rng.random(m) < mask_p,
        counts=np.asarray(counts, np.int32),
        capacity=np.asarray(capacity, np.int32),
        values=rng.normal(0.0, 1.0, (s, n_max)).astype(np.float32))


#: One-shot ingest cases: overrides of ``one_shot_inputs``' defaults.
#: "crossing" starts at open interval 3 (slots holding 3, 1, 2) and runs
#: the frontier to interval 4: slot 1 resets, items in [2.7, 3) are late,
#: items below the watermark 2.7 drop.
ONE_SHOT_CASES = {
    "filling": dict(counts_hi=1, cap=64, t_lo=0.0, t_hi=0.9),
    "ragged": dict(m=300),
    "all_masked": dict(mask_p=0.0),
    "single_cell": dict(k=1, s=1, m=77),
    "i32_payload": dict(payload="i32"),
    "over_capacity": dict(counts_hi=400, cap=None),
    "crossing": dict(max_time=3.2, open_interval=3, t_lo=2.6, t_hi=4.4),
}


def one_shot_inputs(seed, k=3, s=4, n_max=64, m=256, mask_p=0.9,
                    payload="f32", counts_hi=8, cap=5, t_lo=0.0, t_hi=3.5,
                    max_time=0.7, open_interval=0):
    """numpy ``(items, state)`` of one one-shot ingest call: a disordered
    chunk of ``m`` items and a pre-loaded ``[k, s, n_max]`` ring whose
    slot table matches ``open_interval``. ``cap=None`` draws random cell
    capacities (and an ``adopt`` below ``n_max``)."""
    rng = np.random.default_rng(seed)
    if payload == "i32":
        pay = rng.integers(0, 9999, m).astype(np.int32)
        values = rng.integers(0, 9999, (k, s, n_max)).astype(np.int32)
    else:
        pay = rng.normal(size=m).astype(np.float32)
        values = rng.normal(size=(k, s, n_max)).astype(np.float32)
    if cap is None:
        capacity = rng.integers(1, n_max + 1, (k, s)).astype(np.int32)
        adopt = rng.integers(1, n_max, s).astype(np.int32)
    else:
        capacity = np.full((k, s), min(cap, n_max), np.int32)
        adopt = np.full((s,), min(cap, n_max), np.int32)
    slots = np.arange(k)
    items = dict(
        times=rng.uniform(t_lo, t_hi, m).astype(np.float32),
        stratum_ids=rng.integers(0, s, m).astype(np.int32),
        payload=pay, mask=rng.random(m) < mask_p,
        u_accept=rng.random(m, dtype=np.float32),
        u_slot=rng.random(m, dtype=np.float32))
    state = dict(
        max_time=np.float32(max_time), open_interval=np.int32(open_interval),
        on_time=np.int32(3), late=np.int32(1), dropped=np.int32(2),
        chunks=np.int32(4), items=np.int32(50),
        slot_interval=(open_interval
                       - np.mod(open_interval - slots, k)).astype(np.int32),
        adopt=adopt,
        counts=rng.integers(0, counts_hi, (k, s)).astype(np.int32),
        capacity=capacity, values=values,
        counters=rng.integers(0, 3, (6, s)).astype(np.int32))
    return items, state


ONE_SHOT_FIELDS = ("values", "counts", "capacity", "slot_interval",
                   "max_time", "open_interval", "on_time", "late", "dropped",
                   "chunks", "items", "counters")


def stats_inputs(seed, m, s=4, mask_p=0.8):
    """numpy ``(values, stratum_ids, mask)`` of one stats pass."""
    rng = np.random.default_rng(seed)
    sid = rng.integers(0, s, m).astype(np.int32)
    mus = np.array([10.0, 1000.0, 50.0, 300.0], np.float32)[:s]
    vals = (mus[sid] * (1.0 + 0.1 * rng.standard_normal(m))).astype(
        np.float32)
    return vals, sid, rng.random(m) < mask_p


#: Weighted-histogram cases: overrides of ``whist_inputs``' defaults.
WHIST_CASES = {
    "uniform": {},
    "log2": dict(edges="log2"),
    "all_masked": dict(mask_p=0.0),
    "collapsed": dict(edges="collapsed"),
    "on_edges": dict(values="on_edges"),
    "duplicate_edges": dict(edges="duplicates", values="on_edges"),
    "ragged": dict(ragged=True),
    "max_cells_bins": dict(g=100),
}


def whist_inputs(seed, m, g=6, edges="uniform", values="spread",
                 mask_p=0.9, ragged=False):
    """numpy ``(values, cell_ids, weights, mask, edges)`` of one weighted
    histogram over ``g`` cells (32 bins; 24 with ``edges="log2"``).

    ``edges``: ``"uniform"`` (33 edges over [10, 90]), ``"log2"``
    (``2^0 ... 2^24``, values log-normal flow sizes floored to whole
    bytes), ``"collapsed"`` (all 33 edges and every value equal, as the
    refinement's bracket of a window of one repeated value), or
    ``"duplicates"`` (uniform with interior edges repeated). ``values``:
    ``"spread"`` or ``"on_edges"`` (every value exactly an edge, ``e_B``
    included, plus some outside the edges)."""
    rng = np.random.default_rng(seed)
    if ragged:
        m = m * 97 // 96 + 13
    if edges == "log2":
        e = 2.0 ** np.arange(25, dtype=np.float32)
        x = np.floor(rng.lognormal(7.5, 1.8, m)).astype(np.float32)
    elif edges == "collapsed":
        e = np.full(33, 1480.0, np.float32)
        x = np.full(m, 1480.0, np.float32)
    else:
        e = np.linspace(10.0, 90.0, 33).astype(np.float32)
        if edges == "duplicates":
            e[[5, 6, 20]] = e[[4, 4, 19]]
        x = rng.uniform(0.0, 100.0, m).astype(np.float32)
    if values == "on_edges":
        x = rng.choice(np.concatenate([e, [e[0] - 1.0, e[-1] + 1.0]]),
                       m).astype(np.float32)
    w = rng.uniform(1.0, 5.0, g).astype(np.float32)
    cell = rng.integers(0, g, m).astype(np.int32)
    return (x, cell, w[cell], rng.random(m) < mask_p, e)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py covers "
                    "the kernels on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("phase", sorted(PHASES))
@pytest.mark.parametrize("m,mask_p", [(256, 0.9), (300, 0.9), (300, 0.0)])
def test_cuda_fold_matches_plain(cuda_device, phase, m, mask_p):
    inp = {k: torch.from_numpy(np.array(v)).to(cuda_device)
           for k, v in fold_inputs(7, m, *PHASES[phase],
                                   mask_p=mask_p).items()}
    ring_k, ring_p = inp["values"].clone(), inp.pop("values")
    before = reservoir.reservoir_fold.launches
    ck = reservoir.reservoir_fold(values=ring_k, **inp)
    cp = ref.reservoir_fold(values=ring_p, **inp)
    assert reservoir.reservoir_fold.launches == before + 1
    assert torch.equal(ring_k.view(torch.int32), ring_p.view(torch.int32))
    assert torch.equal(ck, cp)


@pytest.mark.cuda
@pytest.mark.parametrize("m,mask_p", [(1024, 0.8), (1000, 0.8), (0, 1.0)])
def test_cuda_stats_matches_plain(cuda_device, m, mask_p):
    vals, sid, mask = (torch.from_numpy(a).to(cuda_device)
                       for a in stats_inputs(9, m, mask_p=mask_p))
    kc, ks, kq = stratified_stats.stratified_stats(vals, sid, mask, 4)
    pc, ps, pq = ref.stratified_stats(vals, sid, mask, 4)
    assert torch.equal(kc, pc)
    torch.testing.assert_close(ks, ps, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(kq, pq, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
def test_cuda_executor_matches_cpu_executor(cuda_device):
    """The whole pipelined path on the card (through both kernels) and on
    the CPU (plain versions): the same state bit for bit, the same
    answers within rtol."""
    rng = np.random.default_rng(4)
    cfg = tex.RuntimeConfig(num_strata=3, capacity=16, num_intervals=3,
                            interval_span=1.0, allowed_lateness=0.5,
                            emit_every=4, max_capacity=32)
    chunks = []
    for e in range(12):
        sid = rng.integers(0, 3, 256).astype(np.int32)
        vals = (np.array([10.0, 100.0, 1000.0])[sid]
                * (1 + 0.2 * rng.standard_normal(256))).astype(np.float32)
        t = ((e * 256 + np.arange(256)) / 1024.0
             - (rng.random(256) < 0.3) * rng.random(256)).clip(0)
        chunks.append((vals, sid, t.astype(np.float32),
                       rng.random(256) > 0.05))
    runs = {}
    ops.reset_launch_counts()
    for dev in ("cpu", cuda_device):
        reg = (treg.QueryRegistry().register("total", "sum")
               .register("avg", "mean")
               .register("big", "count", predicate=lambda x: x > 500.0))
        ex = tex.PipelinedExecutor(cfg, reg, prng.PRNGKey(3), device=dev)
        for c in chunks:
            ex.push(TimestampedChunk(*(torch.from_numpy(a).to(dev)
                                       for a in c)))
        runs[str(dev)] = (ex.finalize(), convert.state_to_numpy(ex.state))
    assert ops.launch_counts() == {"reservoir_fold": 12,
                                   "stratified_stats": 6,
                                   "one_shot_ingest": 0,
                                   "weighted_hist": 0}
    (ce, cs), (ge, gs) = runs["cpu"], runs[str(cuda_device)]
    for part in ("window", "slot_interval", "open_interval", "wm",
                 "metrics"):
        np.testing.assert_equal(gs[part], cs[part])
    for a, b in zip(ce, ge):
        assert (a.index, a.on_time, a.late, a.dropped) == \
            (b.index, b.on_time, b.late, b.dropped)
        for name in a.results:
            np.testing.assert_allclose(float(b.results[name].value),
                                       float(a.results[name].value),
                                       rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ONE_SHOT_CASES))
@pytest.mark.parametrize("size", ["small", "medium"])
def test_cuda_one_shot_matches_plain(cuda_device, case, size):
    kw = dict(ONE_SHOT_CASES[case])
    if size == "medium":
        kw.update(m=kw.get("m", 256) * 97 + 13, n_max=4096)
        if kw.get("cap") == 64:
            kw["cap"] = 4096
    items, state = one_shot_inputs(17, **kw)
    runs = []
    for _ in range(2):
        t = {k: torch.from_numpy(np.array(v)).to(cuda_device)
             for k, v in state.items()}
        runs.append(t)
    it = {k: torch.from_numpy(np.array(v)).to(cuda_device)
          for k, v in items.items()}
    before = ops.launch_counts()["one_shot_ingest"]
    one_shot.one_shot_ingest(**it, span=1.0, allowed_lateness=0.5,
                             **runs[0])
    ref.one_shot_ingest(**it, span=1.0, allowed_lateness=0.5, **runs[1])
    torch.cuda.synchronize()
    assert ops.launch_counts()["one_shot_ingest"] == before + 1
    for f in ONE_SHOT_FIELDS:
        a, b = runs[0][f], runs[1][f]
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a.view(-1).view(torch.int32)
                           if a.dtype == torch.float32 else a,
                           b.view(-1).view(torch.int32)
                           if b.dtype == torch.float32 else b), f


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["pipelined", "batched"])
@pytest.mark.parametrize("emission", ["cadence", "watermark"])
def test_cuda_onekernel_executor_matches_cpu(cuda_device, mode, emission):
    """The one-kernel ingest path of each executor on the card and on the
    CPU: the same state bit for bit, the same emissions."""
    rng = np.random.default_rng(6)
    cfg = tex.RuntimeConfig(num_strata=3, capacity=16, num_intervals=3,
                            interval_span=1.0, allowed_lateness=0.5,
                            emit_every=4, max_capacity=32,
                            ingest="onekernel", emission=emission)
    chunks = []
    for e in range(12):
        sid = rng.integers(0, 3, 256).astype(np.int32)
        vals = (np.array([10.0, 100.0, 1000.0])[sid]
                * (1 + 0.2 * rng.standard_normal(256))).astype(np.float32)
        t = ((e * 256 + np.arange(256)) / 1024.0
             - (rng.random(256) < 0.3) * rng.random(256)).clip(0)
        chunks.append((vals, sid, t.astype(np.float32),
                       rng.random(256) > 0.05))
    cls = tex.PipelinedExecutor if mode == "pipelined" else \
        tex.BatchedExecutor
    runs = {}
    for dev in ("cpu", cuda_device):
        ops.reset_launch_counts()
        reg = (treg.QueryRegistry().register("total", "sum")
               .register("avg", "mean")
               .register("big", "count", predicate=lambda x: x > 500.0))
        ex = cls(cfg, reg, prng.PRNGKey(3), device=dev)
        for c in chunks:
            ex.push(TimestampedChunk(*(torch.from_numpy(a).to(dev)
                                       for a in c)))
        runs[str(dev)] = (ex.finalize(), convert.state_to_numpy(ex.state),
                          ops.launch_counts())
    (ce, cs, cl), (ge, gs, gl) = runs["cpu"], runs[str(cuda_device)]
    print(cl, gl)
    assert cl["one_shot_ingest"] == 0 and gl["one_shot_ingest"] == 12
    assert gl["reservoir_fold"] == 0
    for part in ("window", "slot_interval", "open_interval", "wm",
                 "metrics"):
        np.testing.assert_equal(gs[part], cs[part])
    assert len(ce) == len(ge) > 0
    for a, b in zip(ce, ge):
        assert (a.index, a.interval, a.on_time, a.late, a.dropped) == \
            (b.index, b.interval, b.on_time, b.late, b.dropped)
        for name in a.results:
            np.testing.assert_allclose(float(b.results[name].value),
                                       float(a.results[name].value),
                                       rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WHIST_CASES))
@pytest.mark.parametrize("m", [1000, 200_003])
def test_cuda_weighted_hist_matches_plain(cuda_device, case, m):
    """Counts bit for bit, mass within rtol of the f64-summed plain
    version, and the same bits on a second run."""
    kw = dict(WHIST_CASES[case])
    g = kw.get("g", 6)
    x, cell, w, mask, e = (torch.from_numpy(a).to(cuda_device)
                           for a in whist_inputs(11, m, **kw))
    before = weighted_hist.weighted_hist.launches
    kh, kc = weighted_hist.weighted_hist(x, cell, w, mask, e, g)
    ph, pc = ref.weighted_hist(x, cell, w, mask, e, g)
    again = weighted_hist.weighted_hist(x, cell, w, mask, e, g)
    torch.cuda.synchronize()
    assert weighted_hist.weighted_hist.launches == before + 2
    assert torch.equal(kc, pc)
    torch.testing.assert_close(kh, ph, rtol=1e-5, atol=0.0)
    assert torch.equal(again[0].view(torch.int32), kh.view(torch.int32))
    assert torch.equal(again[1], kc)
    if case == "collapsed":
        assert float(kc[:, :-1].sum()) == 0.0 and float(kc.sum()) > 0


@pytest.mark.cuda
def test_cuda_weighted_hist_too_many_cells_bins_raises(cuda_device):
    x, cell, w, mask, e = (torch.from_numpy(a).to(cuda_device)
                           for a in whist_inputs(1, 100, g=101))
    with pytest.raises(ValueError, match="MAX_CELLS_BINS"):
        weighted_hist.weighted_hist(x, cell, w, mask, e, 101)


def _above_500(x):
    return x > 500.0


#: Every kind under every window it takes: ``(name, kind, keywords)``.
NONLINEAR_QUERIES = (
    ("total", "sum", {}),
    ("per_key", "sum", dict(window="per_key")),
    ("session", "sum", dict(window="session", session_gap=1.0)),
    ("avg_key", "mean", dict(window="per_key")),
    ("avg_session", "mean", dict(window="session", session_gap=3.0)),
    ("big_key", "count", dict(window="per_key", predicate=_above_500)),
    ("big_session", "count", dict(window="session", session_gap=2.0,
                                  predicate=_above_500)),
    ("q_sort", "quantile", dict(qs=(0.5, 0.9), num_replicates=8)),
    ("q_hist", "quantile", dict(qs=(0.25, 0.9), method="hist",
                                num_replicates=8)),
    ("q_key", "quantile", dict(qs=(0.5,), window="per_key",
                               num_replicates=4)),
    ("q_session", "quantile", dict(qs=(0.9,), window="session",
                                   session_gap=1.0, method="hist",
                                   num_replicates=4)),
    ("hist", "histogram", dict(edges=(0.0, 10.0, 50.0, 100.0, 500.0,
                                      1000.0, 2000.0))),
    ("top", "heavy_hitters", dict(k=4)),
    ("distinct", "distinct", dict(num_replicates=8)),
)


def nonlinear_registry(module=treg):
    """``NONLINEAR_QUERIES`` registered in ``module``'s registry (the
    port's by default; the parity tests pass the reference's)."""
    reg = module.QueryRegistry()
    for name, kind, kw in NONLINEAR_QUERIES:
        reg.register(name, kind, **kw)
    return reg


def nonlinear_chunks(seed, n, m=256):
    """numpy chunks of a disordered 3-stratum stream (a quarter interval
    each at span 1) with values floored to tens, so keys repeat."""
    rng = np.random.default_rng(seed)
    chunks = []
    for e in range(n):
        sid = rng.integers(0, 3, m).astype(np.int32)
        vals = np.floor(np.array([10.0, 100.0, 1000.0])[sid]
                        * (1 + 0.2 * rng.standard_normal(m)) / 10.0) * 10.0
        t = ((e * m + np.arange(m)) / (4.0 * m)
             - (rng.random(m) < 0.3) * rng.random(m)).clip(0)
        chunks.append((vals.astype(np.float32), sid, t.astype(np.float32),
                       rng.random(m) > 0.05))
    return chunks


@pytest.mark.cuda
@pytest.mark.parametrize("ingest,emission", [("fused", "cadence"),
                                             ("onekernel", "watermark")])
def test_cuda_nonlinear_registry_matches_cpu(cuda_device, ingest, emission):
    """The nonlinear registry on the card (through the weighted_hist
    kernel) and on the CPU: the same state bit for bit, the same heavy
    hitter keys and bootstrap answers. Capacity 16 makes every HT weight
    C/16 dyadic, so the cumulative weights are exact on both devices."""
    cfg = tex.RuntimeConfig(num_strata=3, capacity=16, num_intervals=3,
                            interval_span=1.0, allowed_lateness=0.5,
                            emit_every=4, max_capacity=32, ingest=ingest,
                            emission=emission)
    chunks = nonlinear_chunks(8, 12)
    runs = []
    for dev in ("cpu", cuda_device):
        ops.reset_launch_counts()
        ex = tex.PipelinedExecutor(cfg, nonlinear_registry(), prng.PRNGKey(5),
                                   device=dev)
        for c in chunks:
            ex.push(TimestampedChunk(*(torch.from_numpy(a).to(dev)
                                       for a in c)))
        ems = ex.finalize()
        runs.append(([convert.results_to_numpy(em.results) for em in ems],
                     convert.state_to_numpy(ex.state), ops.launch_counts()))
    (ce, cs, cl), (ge, gs, gl) = runs
    # Per emission: one histogram, and Q * num_steps per key holding
    # the hist quantiles (2 merged levels, 1 session level for 3 keys).
    assert cl["weighted_hist"] == 0
    assert gl["weighted_hist"] == len(ge) * (1 + 2 * 4 + 3 * 4) > 0
    for part in ("window", "slot_interval", "open_interval", "wm",
                 "metrics"):
        np.testing.assert_equal(gs[part], cs[part])
    assert len(ce) == len(ge)
    for a, b in zip(ce, ge):
        assert a.keys() == b.keys()
        for name in a:
            if "keys" in a[name]:
                np.testing.assert_array_equal(b[name]["keys"],
                                              a[name]["keys"])
            np.testing.assert_allclose(b[name]["value"], a[name]["value"],
                                       rtol=1e-5)
            np.testing.assert_allclose(b[name]["variance"],
                                       a[name]["variance"], rtol=1e-3,
                                       atol=1e-6)
