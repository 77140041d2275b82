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
from repro_torch.kernels import (_workspace, one_shot, ops, ref, reservoir,
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
    "narrow": dict(edges="narrow"),
    "outside": dict(edges="outside"),
}


def whist_inputs(seed, m, g=6, edges="uniform", values="spread",
                 mask_p=0.9, ragged=False):
    """numpy ``(values, cell_ids, weights, mask, edges)`` of one weighted
    histogram over ``g`` cells (32 bins; 24 with ``edges="log2"``).

    ``edges``: ``"uniform"`` (33 edges over [10, 90]), ``"log2"``
    (``2^0 ... 2^24``, values log-normal flow sizes floored to whole
    bytes), ``"collapsed"`` (all 33 edges and every value equal, as the
    refinement's bracket of a window of one repeated value), or
    ``"duplicates"`` (uniform with interior edges repeated), ``"narrow"``
    (33 edges over [50, 50.5], a later refinement round's bracket: most
    values outside) or ``"outside"`` (33 edges over [200, 300], above
    every value). ``values``:
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
        lo, hi = {"narrow": (50.0, 50.5), "outside": (200.0, 300.0)}.get(
            edges, (10.0, 90.0))
        e = np.linspace(lo, hi, 33).astype(np.float32)
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
    assert_workspace_clean(cuda_device)


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


#: Many-tile fold cases at M = 200,003 (98 tiles of the claim, the last
#: ragged): ``(S, N_max, counts, capacity)``. "collisions" folds the chunk
#: into a [4, 64] ring in replacement, so thousands of items race per cell.
BIG_FOLD = {
    "filling": (4, 65_536, [0, 0, 0, 0], [65_536, 40_000, 20_000, 100]),
    "replacement": (4, 65_536, [100_000, 400_000, 70_000, 9],
                    [65_536, 30_000, 5, 64]),
    "collisions": (4, 64, [1_000, 5_000, 64, 0], [64, 64, 64, 64]),
}

#: Many-tile one-shot cases at M = 200,003: overrides of
#: ``one_shot_inputs``' defaults ("collisions": a [2, 2, 64] ring).
BIG_ONE_SHOT = {
    "filling": dict(counts_hi=1, cap=4096, n_max=4096),
    "replacement": dict(counts_hi=400_000, cap=None, n_max=4096),
    "collisions": dict(k=2, s=2, n_max=64, counts_hi=5000, cap=None),
    "crossing": dict(n_max=4096, max_time=3.2, open_interval=3, t_lo=2.6,
                     t_hi=4.4),
}

BIG_M = 200_003


def _to(dev, arrays):
    return {k: torch.from_numpy(np.array(v)).to(dev)
            for k, v in arrays.items()}


def assert_workspace_clean(dev, stream=None):
    """The scratch the kernels keep is as the next call needs it: the
    winner table all -1, the look-back words, counters and tickets all
    0 (the workspace of ``stream``, by default the current one)."""
    torch.cuda.synchronize()
    stream = stream or torch.cuda.current_stream(dev)
    ws = _workspace.get(dev, stream.cuda_stream)
    assert bool((ws.winner == -1).all())
    assert not bool(ws.status.any())
    assert not bool(ws.counters.any())
    assert not bool(ws.tickets.any())


def assert_same_bits(a, b, name=""):
    assert a.dtype == b.dtype and a.shape == b.shape, name
    if a.dtype == torch.float32:
        a, b = a.reshape(-1).view(torch.int32), b.reshape(-1).view(
            torch.int32)
    assert torch.equal(a, b), name


def _fold_both(inp, ring_k, ring_p):
    ck = reservoir.reservoir_fold(values=ring_k, **inp)
    cp = ref.reservoir_fold(values=ring_p, **inp)
    assert_same_bits(ring_k, ring_p, "values")
    assert torch.equal(ck, cp)
    return ck


def _one_shot_both(items, sk, sp, span=1.0):
    one_shot.one_shot_ingest(**items, span=span, allowed_lateness=0.5, **sk)
    ref.one_shot_ingest(**items, span=span, allowed_lateness=0.5, **sp)
    for f in ONE_SHOT_FIELDS:
        assert_same_bits(sk[f], sp[f], f)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BIG_FOLD))
def test_cuda_fold_many_tiles_matches_plain(cuda_device, case):
    s, n_max, counts, capacity = BIG_FOLD[case]
    inp = _to(cuda_device, fold_inputs(21, BIG_M, counts, capacity, s=s,
                                       n_max=n_max))
    ring_p = inp.pop("values")
    _fold_both(inp, ring_p.clone(), ring_p)
    assert_workspace_clean(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BIG_ONE_SHOT))
def test_cuda_one_shot_many_tiles_matches_plain(cuda_device, case):
    items, state = one_shot_inputs(23, m=BIG_M, **BIG_ONE_SHOT[case])
    it = _to(cuda_device, items)
    _one_shot_both(it, _to(cuda_device, state), _to(cuda_device, state))
    assert_workspace_clean(cuda_device)


@pytest.mark.cuda
def test_cuda_fold_sequence_matches_plain(cuda_device):
    """Four chunks into one ring, each folded on the counts the last one
    left: bitwise after each call, the scratch clean after each."""
    inp = _to(cuda_device, fold_inputs(25, BIG_M, [50_000] * 4,
                                       [4096, 1000, 64, 7], n_max=4096))
    ring_k, ring_p = inp["values"].clone(), inp.pop("values")
    for i in range(4):
        inp["counts"] = _fold_both(inp, ring_k, ring_p)
        assert_workspace_clean(cuda_device)
        nxt = _to(cuda_device, fold_inputs(26 + i, BIG_M, [0] * 4,
                                           [1] * 4, n_max=4096))
        for k in ("stratum_ids", "payload", "u_accept", "u_slot", "mask"):
            inp[k] = nxt[k]


@pytest.mark.cuda
def test_cuda_one_shot_sequence_matches_plain(cuda_device):
    """Four successive chunks through one carried state (the frontier
    moving on by an interval each chunk): bitwise after each call."""
    _, state = one_shot_inputs(27, m=8, n_max=4096, counts_hi=400_000,
                               cap=None)
    sk, sp = _to(cuda_device, state), _to(cuda_device, state)
    for i in range(4):
        items, _ = one_shot_inputs(28 + i, m=BIG_M, n_max=4096,
                                   t_lo=0.5 + i, t_hi=1.6 + i)
        _one_shot_both(_to(cuda_device, items), sk, sp)
        assert_workspace_clean(cuda_device)


@pytest.mark.cuda
def test_cuda_fold_and_one_shot_interleaved(cuda_device):
    """A fold on a [4, 65,536] ring and a one-shot ingest on a
    [3, 4, 1024] ring, in turns, share one scratch: bitwise after each."""
    inp = _to(cuda_device, fold_inputs(29, BIG_M, [100_000] * 4,
                                       [65_536, 100, 7, 30_000],
                                       n_max=65_536))
    ring_k, ring_p = inp["values"].clone(), inp.pop("values")
    _, state = one_shot_inputs(30, m=8, n_max=1024, counts_hi=50_000,
                               cap=None)
    sk, sp = _to(cuda_device, state), _to(cuda_device, state)
    for i in range(3):
        inp["counts"] = _fold_both(inp, ring_k, ring_p)
        items, _ = one_shot_inputs(31 + i, m=BIG_M // 2 + i, n_max=1024,
                                   t_lo=0.2 + i, t_hi=1.4 + i)
        _one_shot_both(_to(cuda_device, items), sk, sp)
        assert_workspace_clean(cuda_device)


@pytest.mark.cuda
def test_cuda_masked_path_folds_on_ring_views(cuda_device):
    """The masked ingest's K folds per chunk, each into the [S, N_max]
    view of one ring slot with that slot's mask: bitwise after each."""
    k, s, n_max = 3, 4, 4096
    rng = np.random.default_rng(32)
    base = _to(cuda_device, fold_inputs(33, BIG_M, [0] * s, [1] * s, s=s,
                                        n_max=n_max))
    slot = torch.from_numpy(rng.integers(0, k, BIG_M)).to(cuda_device)
    ring = torch.from_numpy(rng.normal(size=(k, s, n_max)).astype(
        np.float32)).to(cuda_device)
    ring_k, ring_p = ring.clone(), ring.clone()
    counts = torch.from_numpy(rng.integers(0, 20_000, (k, s)).astype(
        np.int32)).to(cuda_device)
    capacity = torch.from_numpy(rng.integers(1, n_max + 1, (k, s)).astype(
        np.int32)).to(cuda_device)
    for j in range(k):
        inp = dict(base, mask=base["mask"] & (slot == j), counts=counts[j],
                   capacity=capacity[j])
        inp.pop("values")
        _fold_both(inp, ring_k[j], ring_p[j])
        assert_same_bits(ring_k, ring_p, "ring")
        assert_workspace_clean(cuda_device)


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
    assert_workspace_clean(cuda_device)
    if case == "collapsed":
        assert float(kc[:, :-1].sum()) == 0.0 and float(kc.sum()) > 0
    if case == "outside":
        assert float(kc.sum()) == 0.0 and float(kh.abs().sum()) == 0.0


@pytest.mark.cuda
def test_cuda_weighted_hist_too_many_cells_bins_raises(cuda_device):
    x, cell, w, mask, e = (torch.from_numpy(a).to(cuda_device)
                           for a in whist_inputs(1, 100, g=101))
    with pytest.raises(ValueError, match="MAX_CELLS_BINS"):
        weighted_hist.weighted_hist(x, cell, w, mask, e, 101)


#: Flat-input layouts the stats and histogram kernels take: ``(M,
#: element offsets of (values, ids, weights, mask))``. An offset of 1 to 3
#: starts a view off a 16-byte boundary (a mask view off a 4-byte one);
#: M = 2**22 + 13 takes more tiles than the grid has blocks (512 blocks
#: of 2,048 items), so the blocks walk the tiles with a grid stride.
LAYOUTS = {
    "ragged": (200_003, (0, 0, 0, 0)),
    "ragged_2e20": (2**20 + 77, (0, 0, 0, 0)),
    "offset_1": (200_003, (1, 1, 1, 1)),
    "offset_2": (2**20 + 77, (2, 2, 2, 2)),
    "offset_3": (2**20 + 77, (3, 3, 3, 3)),
    "offset_mixed": (200_003, (1, 3, 2, 0)),
    "mask_offset": (4099, (0, 0, 0, 1)),
    "tiny": (3, (1, 2, 3, 1)),
    "grid_stride": (2**22 + 13, (0, 1, 0, 2)),
}


def at_offset(dev, a, off):
    """numpy ``a`` on ``dev`` as a view ``off`` elements into its buffer."""
    buf = np.concatenate([np.zeros(off, a.dtype), a])
    return torch.from_numpy(buf).to(dev)[off:]


def _stats_call(vals, sid, mask, s, calls=2):
    """``calls`` back-to-back stats calls against one plain call: counts
    bit for bit, sums within rtol 1e-5 of the f64-summed plain version,
    every call the first one's bits, the tickets 0 after them."""
    before = stratified_stats.stratified_stats.launches
    runs = [stratified_stats.stratified_stats(vals, sid, mask, s)
            for _ in range(calls)]
    pc, ps, pq = ref.stratified_stats(vals, sid, mask, s)
    assert stratified_stats.stratified_stats.launches == before + calls
    kc, ks, kq = runs[0]
    assert torch.equal(kc, pc)
    torch.testing.assert_close(ks, ps, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(kq, pq, rtol=1e-5, atol=0.0)
    for run in runs[1:]:
        for a, b, name in zip(run, runs[0], ("counts", "sums", "sumsqs")):
            assert_same_bits(a, b, name)
    assert_workspace_clean(vals.device)
    return runs[0]


def _whist_call(x, cell, w, mask, e, g, calls=2):
    """As ``_stats_call``, for the weighted histogram."""
    before = weighted_hist.weighted_hist.launches
    runs = [weighted_hist.weighted_hist(x, cell, w, mask, e, g)
            for _ in range(calls)]
    ph, pc = ref.weighted_hist(x, cell, w, mask, e, g)
    assert weighted_hist.weighted_hist.launches == before + calls
    kh, kc = runs[0]
    assert torch.equal(kc, pc)
    torch.testing.assert_close(kh, ph, rtol=1e-5, atol=0.0)
    for run in runs[1:]:
        assert_same_bits(run[0], kh, "whist")
        assert_same_bits(run[1], kc, "counts")
    assert_workspace_clean(x.device)
    return runs[0]


def rows_stats_inputs(seed, m, s=4, mask_p=0.8):
    """``stats_inputs`` with the strata in runs, as the emission's
    flattened ``[S, N]`` view has them (row ids)."""
    vals, sid, mask = stats_inputs(seed, m, s, mask_p)
    return vals, np.sort(sid), mask


@pytest.mark.cuda
@pytest.mark.parametrize("strata", ["random", "rows"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cuda_stats_layouts_match_plain(cuda_device, layout, strata):
    """Views off a 16-byte boundary, ragged M and a grid-stride M."""
    m, (ov, oi, _, om) = LAYOUTS[layout]
    make = stats_inputs if strata == "random" else rows_stats_inputs
    vals, sid, mask = make(41, m)
    _stats_call(at_offset(cuda_device, vals, ov),
                at_offset(cuda_device, sid, oi),
                at_offset(cuda_device, mask, om), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("edges", ["uniform", "narrow", "outside"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cuda_weighted_hist_layouts_match_plain(cuda_device, layout, edges):
    """Views off a 16-byte boundary, ragged M and a grid-stride M, with
    most items in a bin, few, and none."""
    m, offsets = LAYOUTS[layout]
    x, cell, w, mask, e = whist_inputs(43, m, edges=edges)
    views = [at_offset(cuda_device, a, o)
             for a, o in zip((x, cell, w, mask), offsets)]
    kh, kc = _whist_call(*views, torch.from_numpy(e).to(cuda_device), 6)
    if edges == "outside":
        assert float(kc.sum()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["max_strata", "all_masked"])
@pytest.mark.parametrize("m", [1000, 200_003])
def test_cuda_stats_limits_match_plain(cuda_device, case, m):
    """S = MAX_STRATA strata, and a call with every slot masked out."""
    rng = np.random.default_rng(45)
    s = stratified_stats.MAX_STRATA if case == "max_strata" else 4
    vals = rng.normal(100.0, 10.0, m).astype(np.float32)
    sid = rng.integers(0, s, m).astype(np.int32)
    mask = rng.random(m) < (0.8 if case == "max_strata" else 0.0)
    kc, _, _ = _stats_call(*(torch.from_numpy(a).to(cuda_device)
                             for a in (vals, sid, mask)), s)
    assert float(kc.sum()) == float(mask.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["stats", "weighted_hist"])
def test_cuda_fifty_calls_give_the_same_bits(cuda_device, kernel):
    """50 back-to-back calls over 2**21 + 5 items (all 512 blocks, their
    last tickets taken in whatever order they finish): one result."""
    m = 2**21 + 5
    if kernel == "stats":
        _stats_call(*(torch.from_numpy(a).to(cuda_device)
                      for a in stats_inputs(47, m)), 4, calls=50)
    else:
        x, cell, w, mask, e = (torch.from_numpy(a).to(cuda_device)
                               for a in whist_inputs(47, m, edges="log2"))
        _whist_call(x, cell, w, mask, e, 6, calls=50)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["stats", "weighted_hist"])
def test_cuda_same_phase_gives_the_same_bits(cuda_device, kernel):
    """The same data at element offsets 1 and 5 (one 16-byte phase, in
    two buffers): the same bits, as the wrappers state."""
    m = 300_007
    if kernel == "stats":
        arrays, extra = stats_inputs(51, m), (4,)
        run = stratified_stats.stratified_stats
    else:
        x, cell, w, mask, e = whist_inputs(51, m, edges="log2")
        arrays, extra = (x, cell, w, mask), (
            torch.from_numpy(e).to(cuda_device), 6)
        run = weighted_hist.weighted_hist
    a = run(*(at_offset(cuda_device, v, 1) for v in arrays), *extra)
    b = run(*(at_offset(cuda_device, v, 5) for v in arrays), *extra)
    for got, want in zip(b, a):
        assert_same_bits(got, want)
    assert_workspace_clean(cuda_device)


@pytest.mark.cuda
def test_cuda_reductions_on_two_streams(cuda_device):
    """Stats and histogram calls issued on two streams at once, each
    stream with its own workspace: the bits of calls on the current
    stream, and every workspace's tickets 0 afterwards."""
    sv = [torch.from_numpy(a).to(cuda_device)
          for a in stats_inputs(49, 300_007)]
    hv = [torch.from_numpy(a).to(cuda_device)
          for a in whist_inputs(49, 300_007, edges="log2")]
    want = (stratified_stats.stratified_stats(*sv, 4),
            weighted_hist.weighted_hist(*hv, 6))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    got = []
    for _ in range(4):
        for st in streams:
            with torch.cuda.stream(st):
                got.append((stratified_stats.stratified_stats(*sv, 4),
                            weighted_hist.weighted_hist(*hv, 6)))
    torch.cuda.synchronize()
    for stats, hist in got:
        for a, b in zip(stats + hist, want[0] + want[1]):
            assert_same_bits(a, b)
    for st in streams + [None]:
        assert_workspace_clean(cuda_device, st)


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
