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


def two_leaves(items, state, seed):
    """A one-shot case with a payload of two leaves, ``{"val": f32, "key":
    i32}`` (the heavy-hitter keys riding beside the values, as the
    reference's pytree payloads), the ring likewise: ``val`` is the
    case's own f32 payload and ring, ``key`` drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    m = items["times"].shape[0]
    ring = state["values"]
    return (dict(items, payload={
                "val": items["payload"],
                "key": rng.integers(0, 9999, m).astype(np.int32)}),
            dict(state, values={
                "val": ring,
                "key": rng.integers(0, 9999, ring.shape).astype(np.int32)}))


def to_tree(dev, arrays):
    """numpy arrays (and dicts of them) as tensors on ``dev``."""
    return {k: to_tree(dev, v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)).to(dev)
            for k, v in arrays.items()}


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
@pytest.mark.parametrize("case", ["collisions", "crossing", "replacement"])
def test_cuda_one_shot_two_leaves_matches_plain(cuda_device, case):
    """A payload of an f32 and an i32 leaf: one launch of the kernel,
    every field and both ring leaves bit for bit the plain version's, the
    f32 leaf bit for bit a one-leaf call's on the same state (one set of
    decisions), the scratch clean after it."""
    one, state = one_shot_inputs(23, m=BIG_M, **BIG_ONE_SHOT[case])
    items, state2 = two_leaves(one, state, 41)
    it, sk, sp = (to_tree(cuda_device, d) for d in (items, state2, state2))
    before = ops.launch_counts()["one_shot_ingest"]
    one_shot.one_shot_ingest(**it, span=1.0, allowed_lateness=0.5, **sk)
    assert ops.launch_counts()["one_shot_ingest"] == before + 1
    ref.one_shot_ingest(**it, span=1.0, allowed_lateness=0.5, **sp)
    single = to_tree(cuda_device, state)
    one_shot.one_shot_ingest(**to_tree(cuda_device, one), span=1.0,
                             allowed_lateness=0.5, **single)
    for f in ONE_SHOT_FIELDS:
        if f == "values":
            for leaf in ("val", "key"):
                assert_same_bits(sk[f][leaf], sp[f][leaf], leaf)
            assert_same_bits(sk[f]["val"], single[f], "one leaf")
        else:
            assert_same_bits(sk[f], sp[f], f)
            assert_same_bits(sk[f], single[f], f)
    assert not torch.equal(sk["values"]["key"].cpu(),
                           torch.from_numpy(state2["values"]["key"]))
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


# ---------------------------------------------------------------------------
# Checkpoint and recovery on the card.
# ---------------------------------------------------------------------------

def _device_chunks(dev, seed=8, n=12):
    return [TimestampedChunk(*(torch.from_numpy(a).to(dev) for a in c))
            for c in nonlinear_chunks(seed, n)]


def _linear_registry():
    return (treg.QueryRegistry().register("total", "sum")
            .register("avg", "mean")
            .register("big", "count", predicate=_above_500))


def _recovery_cfg(ingest, emission):
    return tex.RuntimeConfig(num_strata=3, capacity=16, num_intervals=3,
                             interval_span=1.0, allowed_lateness=0.5,
                             emit_every=4, batch_chunks=4, max_capacity=32,
                             ingest=ingest, emission=emission)


def _state_bytes(state) -> dict:
    """Leaf bytes by path, less the wall-clock controller leaves."""
    return {p: a.tobytes() for p, a in convert.named_leaves(
        convert.host_state(state))
        if p not in (".ctrl.latency_ema", ".ctrl.pressure")}


def _emission_bytes(em) -> tuple:
    res = {name: {f: a.tobytes() for f, a in r.items()}
           for name, r in convert.results_to_numpy(em.results).items()}
    return (em.index, em.interval, em.watermark, em.open_interval,
            em.on_time, em.late, em.dropped, em.items,
            em.capacity.tobytes(), res)


@pytest.mark.cuda
def test_cuda_payload_round_trip(cuda_device):
    """A snapshot on the card, through its bytes, into a fresh executor
    on the card (another key): every leaf on the card in an allocation
    of its own, the same bits, and the same continuation."""
    from repro_torch.runtime import checkpoint as ckp
    cfg = _recovery_cfg("onekernel", "cadence")
    chunks = _device_chunks(cuda_device)
    a = tex.PipelinedExecutor(cfg, nonlinear_registry(), prng.PRNGKey(5),
                              device=cuda_device)
    for c in chunks[:6]:
        a.push(c)
    payload = ckp.to_bytes(a.snapshot())
    b = tex.PipelinedExecutor(cfg, nonlinear_registry(), prng.PRNGKey(9),
                              device=cuda_device)
    ckpt = b.restore(payload)
    assert (ckpt.stream_offset, ckpt.chunks_since_emit) == (6, 2)
    leaves = convert.named_leaves(b.state)
    assert all(t.device == cuda_device for _, t in leaves)
    mine = {t.data_ptr() for _, t in leaves}
    assert len(mine) == len(leaves)
    assert not mine & {t.data_ptr() for _, t in convert.named_leaves(a.state)}
    assert _state_bytes(a.state) == _state_bytes(b.state)
    for c in chunks[6:]:
        a.push(c)
        b.push(c)
    ea, eb = a.finalize(), b.finalize()
    assert [_emission_bytes(e) for e in ea[1:]] == \
        [_emission_bytes(e) for e in eb]
    assert _state_bytes(a.state) == _state_bytes(b.state)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,ingest,emission,registry", [
    ("pipelined", "fused", "cadence", "nonlinear"),
    ("batched", "onekernel", "cadence", "linear"),
    ("pipelined", "onekernel", "watermark", "nonlinear"),
    ("batched", "onekernel", "watermark", "linear")])
def test_cuda_crash_sweep_bitwise(cuda_device, mode, ingest, emission,
                                  registry):
    """Kill after every chunk on the card; recovery from the payload
    into an executor built with another key; the deduped emissions and
    the final state bit for bit the uninterrupted card run's."""
    from repro_torch.runtime import checkpoint as ckp
    cfg = _recovery_cfg(ingest, emission)
    cls = tex.PipelinedExecutor if mode == "pipelined" else \
        tex.BatchedExecutor

    def make(seed):
        reg = (nonlinear_registry() if registry == "nonlinear"
               else _linear_registry())
        return cls(cfg, reg, prng.PRNGKey(seed), device=cuda_device)
    chunks = _device_chunks(cuda_device)
    victim, recovery = make(5), make(77)
    reference = [_emission_bytes(e) for e in victim.run(chunks)]
    final = _state_bytes(victim.state)
    assert len(reference) >= 2
    for k in range(1, len(chunks)):
        victim.reset(prng.PRNGKey(5))
        victim.checkpointer = ckp.Checkpointer(every_chunks=5)
        victim.checkpointer.save(victim)
        for c in chunks[:k]:
            victim.push(c)
        payload = victim.checkpointer.latest
        victim.checkpointer = None
        ckpt = recovery.restore(payload)
        for c in chunks[ckpt.stream_offset:]:
            recovery.push(c)
        out = victim.emissions[:ckpt.emissions_done] + recovery.finalize()
        assert [_emission_bytes(e) for e in out] == reference, k
        assert _state_bytes(recovery.state) == final, k


@pytest.mark.cuda
@pytest.mark.parametrize("ingest,emission,shards", [
    ("fused", "cadence", 1), ("onekernel", "watermark", 1),
    ("fused", "cadence", 4), ("onekernel", "watermark", 4)])
def test_cuda_reductions_see_phase_zero_values(cuda_device, monkeypatch,
                                               ingest, emission, shards):
    """The stats and histogram sums' bits depend on the values' 16-byte
    address phase: every call the emissions of a fresh executor and of
    one restored from a payload make hands them values at phase 0, on
    one shard and on W = 4 (the merged ``[W·K·S, N]`` view and its
    interval restrictions)."""
    from repro_torch.runtime import checkpoint as ckp
    phases = []
    stats, whist = ops.stratified_stats, ops.weighted_histogram

    def stats_at(values, *a, **kw):
        phases.append(("stats", values.data_ptr() % 16))
        return stats(values, *a, **kw)

    def whist_at(values, *a, **kw):
        phases.append(("whist", values.data_ptr() % 16))
        return whist(values, *a, **kw)
    monkeypatch.setattr(ops, "stratified_stats", stats_at)
    monkeypatch.setattr(ops, "weighted_histogram", whist_at)
    cfg = _recovery_cfg(ingest, emission)
    chunks = _device_chunks(cuda_device)
    if shards > 1:
        cfg = _sharded_cfg(ingest, emission, shards)
        chunks = _sharded_device_chunks(cuda_device, shards)
    fresh = tex.PipelinedExecutor(cfg, nonlinear_registry(), prng.PRNGKey(5),
                                  device=cuda_device)
    for c in chunks[:7]:
        fresh.push(c)
    payload = ckp.to_bytes(fresh.snapshot())
    restored = tex.PipelinedExecutor(cfg, nonlinear_registry(),
                                     prng.PRNGKey(6), device=cuda_device)
    restored.restore(payload)
    for c in chunks[7:]:
        fresh.push(c)
        restored.push(c)
    assert fresh.finalize() and restored.finalize()
    assert {k for k, _ in phases} == {"stats", "whist"}
    assert [p for _, p in phases] == [0] * len(phases), phases


# ---------------------------------------------------------------------------
# Sharded execution (placement="vmap") on the card.
# ---------------------------------------------------------------------------

def _sharded_cfg(ingest, emission, shards=4):
    """``_recovery_cfg`` over ``shards`` shards: 16 per shard, a power of
    two, so the nonlinear answers' weights stay dyadic."""
    return tex.RuntimeConfig(num_strata=3, capacity=16 * shards,
                             num_intervals=3, interval_span=1.0,
                             allowed_lateness=0.5, emit_every=4,
                             batch_chunks=4, max_capacity=32,
                             num_shards=shards, ingest=ingest,
                             emission=emission)


def _sharded_device_chunks(dev, shards=4, seed=8, n=12, m=128):
    """``nonlinear_chunks`` as ``[W, M]`` chunks: shard ``w``'s row is
    stream ``seed + w``, all on the same event-time ramp."""
    rows = [nonlinear_chunks(seed + w, n, m) for w in range(shards)]
    return [TimestampedChunk(*(torch.from_numpy(np.stack(
        [rows[w][e][f] for w in range(shards)])).to(dev)
        for f in range(4))) for e in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,ingest,emission", [
    ("pipelined", "fused", "cadence"),
    ("pipelined", "masked", "cadence"),
    ("pipelined", "onekernel", "watermark"),
    ("batched", "onekernel", "cadence"),
    ("batched", "fused", "watermark")])
def test_cuda_sharded_paths_match_cpu(cuda_device, mode, ingest, emission):
    """W = 4 on the card and on the CPU: the same state bit for bit, the
    same emissions (answers within rtol); per chunk ONE fold over the
    ``W·K·S`` cells (``fused``), one per (shard, slot) (``masked``) or W
    one-shot calls (``onekernel``); two stats calls per emission."""
    cfg = _sharded_cfg(ingest, emission)
    cls = tex.PipelinedExecutor if mode == "pipelined" else \
        tex.BatchedExecutor
    runs = []
    for dev in ("cpu", cuda_device):
        chunks = _sharded_device_chunks(dev)
        ex = cls(cfg, _linear_registry(), prng.PRNGKey(5), device=dev)
        ops.reset_launch_counts()
        ems = ex.run(chunks)
        torch.cuda.synchronize()
        runs.append((ems, convert.state_to_numpy(ex.state),
                     ops.launch_counts()))
    (ce, cs, cl), (ge, gs, gl) = runs
    assert not any(cl.values())
    n, w, k = 12, 4, cfg.num_intervals
    want = {"fused": (n, 0), "masked": (n * w * k, 0),
            "onekernel": (0, n * w)}[ingest]
    assert (gl["reservoir_fold"], gl["one_shot_ingest"]) == want
    assert gl["stratified_stats"] == 2 * len(ge) > 0
    for part in ("window", "slot_interval", "open_interval", "wm",
                 "metrics"):
        np.testing.assert_equal(gs[part], cs[part])
    assert [_emission_bytes(e)[:9] for e in ce] == \
        [_emission_bytes(e)[:9] for e in ge]
    for a, b in zip(ce, ge):
        for name in a.results:
            np.testing.assert_allclose(float(b.results[name].value),
                                       float(a.results[name].value),
                                       rtol=1e-5)
    assert_workspace_clean(cuda_device)


@pytest.mark.cuda
def test_cuda_sharded_nonlinear_matches_cpu(cuda_device):
    """The nonlinear registry at W = 4 (pipelined onekernel): the same
    state and heavy-hitter keys on both devices, answers within rtol."""
    cfg = _sharded_cfg("onekernel", "cadence")
    runs = []
    for dev in ("cpu", cuda_device):
        ex = tex.PipelinedExecutor(cfg, nonlinear_registry(),
                                   prng.PRNGKey(5), device=dev)
        ems = ex.run(_sharded_device_chunks(dev))
        runs.append(([convert.results_to_numpy(em.results) for em in ems],
                     convert.state_to_numpy(ex.state)))
    (ce, cs), (ge, gs) = runs
    for part in ("window", "slot_interval", "open_interval", "wm",
                 "metrics"):
        np.testing.assert_equal(gs[part], cs[part])
    assert len(ce) == len(ge) > 0
    for a, b in zip(ce, ge):
        for name in a:
            if "keys" in a[name]:
                np.testing.assert_array_equal(b[name]["keys"],
                                              a[name]["keys"])
            np.testing.assert_allclose(b[name]["value"], a[name]["value"],
                                       rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pipelined-cadence", "batched-watermark"])
def test_cuda_rescale_kill_sweep(cuda_device, name):
    """The 4→8→4 rescale on the card (``test_torch_rescale``'s harness,
    numpy ramp chunks), killed after every chunk: bitwise exactly-once
    against the uninterrupted card run, whose state is the CPU run's bit
    for bit and whose answers are within rtol."""
    from test_torch_rescale import (KEY, SCHEDULES, SEGMENTS, port_executor,
                                    ramp_chunk, run_schedule,
                                    segment_bounds, sweep_rescale)
    disorder = SCHEDULES[name][3]
    runs = {}
    ops.reset_launch_counts()
    for dev in ("cpu", cuda_device):
        streams = {w: (lambda o, w=w, d=dev: ramp_chunk(
            o, w, disorder=disorder, device=d)) for w in (4, 8)}
        executors = {w: port_executor(name, w, KEY + w, device=dev)
                     for w in (4, 8)}
        if dev == "cpu":
            ems, last = run_schedule(executors, streams, SEGMENTS,
                                     prng.PRNGKey(KEY))
        else:
            total = segment_bounds(SEGMENTS)[-1][2]
            ems = sweep_rescale(executors, streams, SEGMENTS,
                                prng.PRNGKey(KEY), every_chunks=2,
                                crash_points=range(total + 1))
            ems, last = run_schedule(executors, streams, SEGMENTS,
                                     prng.PRNGKey(KEY))
        runs[str(dev)] = (ems, convert.state_to_numpy(last.state))
    kernel = "one_shot_ingest" if SCHEDULES[name][1] == "onekernel" else \
        "reservoir_fold"
    launches = ops.launch_counts()
    assert launches[kernel] > 0 and launches["stratified_stats"] > 0
    (ce, cs), (ge, gs) = runs["cpu"], runs[str(cuda_device)]
    for part in ("window", "slot_interval", "open_interval", "wm",
                 "metrics"):
        np.testing.assert_equal(gs[part], cs[part])
    assert len(ce) == len(ge) > 0
    for a, b in zip(ce, ge):
        assert (a.index, a.interval, a.on_time, a.late, a.dropped) == \
            (b.index, b.interval, b.on_time, b.late, b.dropped)
        for q in a.results:
            np.testing.assert_allclose(
                convert.results_to_numpy({q: b.results[q]})[q]["value"],
                convert.results_to_numpy({q: a.results[q]})[q]["value"],
                rtol=1e-5)


# ---------------------------------------------------------------------------
# The stream substrate and the baselines on the card.
# ---------------------------------------------------------------------------

def _on_both(fn, dev):
    """``fn(device)`` on the CPU and on the card, each on its own."""
    return fn("cpu"), fn(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["GaussianSource", "PoissonSource",
                                  "NetflowSource", "TaxiSource"])
def test_cuda_sources_and_replay_match_cpu(cuda_device, name):
    """Ids, times and masks bit for bit on the card; Gaussian and Poisson
    values bit for bit (every multiply-add of ``prng.normal`` is an f64
    step rounded once), NetFlow's and Taxi's within rtol 1e-5 (``exp``,
    ``log`` and ``pow`` are each device's own)."""
    from repro_torch import stream

    def make(dev):
        agg = stream.StreamAggregator(getattr(stream, name)(), seed=7,
                                      device=dev)
        rs = stream.ReplayableStream(agg, chunk_size=4096, rate=8192.0,
                                     disorder=0.3, disorder_seed=5,
                                     key_gaps=((1, 0.5, 0.25),))
        rs4 = stream.ReplayableStream(agg, chunk_size=1024, rate=2048.0,
                                      num_shards=4, disorder=0.2)
        return [rs.chunk_at(e) for e in (0, 5)] + [rs4.chunk_at(3)]
    cpu, gpu = _on_both(make, cuda_device)
    for a, b in zip(cpu, gpu):
        for f in ("stratum_ids", "times", "mask"):
            assert torch.equal(getattr(a, f), getattr(b, f).cpu()), f
        if name in ("GaussianSource", "PoissonSource"):
            assert torch.equal(a.values, b.values.cpu())
        else:
            close = torch.isclose(b.values.cpu(), a.values, rtol=1e-5)
            if name == "TaxiSource":      # a flipped rejection redraws
                assert close.double().mean() > 0.99
            else:
                assert bool(close.all())


@pytest.mark.cuda
def test_cuda_baselines_match_cpu(cuda_device):
    """SRS and STS at 1,048,576 items (with a mask): masks and weights on
    the card bit for bit the CPU's, and the stats counts."""
    from repro_torch.core import baselines as bl
    rng = np.random.default_rng(3)
    m = 1 << 20
    sid = torch.from_numpy(rng.choice(3, m, p=[0.8, 0.19, 0.01])
                           .astype(np.int32))
    vals = torch.from_numpy(rng.normal(100.0, 10.0, m).astype(np.float32))
    mask = torch.from_numpy(rng.random(m) < 0.9)

    def run(dev):
        s, v, mk = sid.to(dev), vals.to(dev), mask.to(dev)
        key = prng.PRNGKey(11, device=dev)
        srs = bl.srs_sample(key, m, 419_430, mk)
        gc = bl.sts_counts(s, 3, mk)
        sts = bl.sts_sample(key, s, gc, 0.4, mk)
        return (srs, sts, bl.srs_stats(v, srs).counts,
                bl.sample_stats(v, s, sts, 3, gc).taken)
    (a_srs, a_sts, a_c, a_t), (b_srs, b_sts, b_c, b_t) = _on_both(
        run, cuda_device)
    for a, b in ((a_srs, b_srs), (a_sts, b_sts)):
        assert torch.equal(a.mask, b.mask.cpu())
        assert torch.equal(a.weights, b.weights.cpu())
    assert torch.equal(a_c, b_c.cpu()) and torch.equal(a_t, b_t.cpu())


@pytest.mark.cuda
def test_cuda_pipelined_chunks_match_cpu(cuda_device):
    """``update_pipelined_chunks`` at lane 256 through the fold kernel:
    the state on the card bit for bit the CPU's (the plain fold)."""
    from repro_torch.core import oasrs
    rng = np.random.default_rng(5)
    t = 256 * 64
    sid = torch.from_numpy(rng.integers(0, 3, t).astype(np.int32))
    pay = torch.from_numpy(rng.normal(50.0, 5.0, t).astype(np.float32))

    def run(dev):
        st = oasrs.init(3, 700, prng.PRNGKey(2, device=dev), device=dev)
        return oasrs.update_pipelined_chunks(st, sid.to(dev), pay.to(dev),
                                             lane=256)
    ops.reset_launch_counts()
    a, b = _on_both(run, cuda_device)
    assert ops.launch_counts()["reservoir_fold"] == t // 256
    for f in ("values", "counts", "capacity", "key"):
        assert torch.equal(getattr(a, f), getattr(b, f).cpu()), f


# ---------------------------------------------------------------------------
# The serving path (models/, serve/) on the card.
# ---------------------------------------------------------------------------

class _StepClock:
    """A ``time`` stand-in whose ``perf_counter`` advances by a fixed,
    varying step per call: the same latencies on both devices."""

    def __init__(self):
        self.t, self.n = 0.0, 0

    def perf_counter(self) -> float:
        self.n += 1
        self.t += (1 + self.n % 7) * 2.0 ** -12
        return self.t


def _smoke_params(dev, dtype=torch.float32):
    from repro_torch import configs
    from repro_torch.models import api, param
    cfg = configs.get_config("phi4-mini-3.8b", smoke=True).replace(
        dtype=dtype)
    return cfg, param.init_params(api.skeleton(cfg), prng.PRNGKey(0),
                                  device=dev)


@pytest.mark.cuda
def test_cuda_server_generate_matches_cpu(cuda_device, monkeypatch):
    """Smoke-width ``Server.generate`` on the card: the CPU's tokens, and
    its telemetry state bit for bit (one fold kernel launch per step)."""
    from repro_torch.serve import serve_step
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, 512, (6, 24)).astype(np.int32))
    tenants = torch.from_numpy(rng.integers(0, 4, 6).astype(np.int32))

    def run(dev):
        monkeypatch.setattr(serve_step, "time", _StepClock())
        cfg, params = _smoke_params(dev)
        server = serve_step.Server(cfg, params, num_tenants=4,
                                   telemetry_capacity=4, device=dev)
        out = server.generate({"tokens": toks.to(dev)}, steps=7,
                              tenant_ids=tenants.to(dev))
        return out, server.telemetry
    ops.reset_launch_counts()
    (a, ta), (b, tb) = _on_both(run, cuda_device)
    assert ops.launch_counts()["reservoir_fold"] == 7
    assert torch.equal(a, b.cpu())
    for f in ("values", "counts", "capacity", "key"):
        assert torch.equal(getattr(ta, f), getattr(tb, f).cpu()), f


@pytest.mark.cuda
@pytest.mark.parametrize("position,window,slot", [
    (5, 0, 5), (8, 0, 7), (11, 0, 7), (9, 4, 1), (6, 16, 6)])
def test_cuda_clamped_write(cuda_device, position, window, slot):
    """The write slot is clamped to ``Smax - 1`` on the card as on the
    CPU, with no read back to the host."""
    from repro_torch.models import kvcache
    lk = torch.zeros(2, 8, 2, 4, device=cuda_device)
    lv = torch.zeros_like(lk)
    kn = torch.ones(2, 1, 2, 4, device=cuda_device)
    cache = kvcache.KVCache(k=lk[None], v=lv[None], position=torch.full(
        (), position, dtype=torch.int32, device=cuda_device), window=window)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kvcache.write_token(lk, lv, cache, kn, 2 * kn)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    written = (lk != 0).any(-1).any(-1).any(0).cpu()
    assert written.tolist() == [i == slot for i in range(8)]
    assert bool((lv[:, slot] == 2).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sliced_init_params(cuda_device, monkeypatch, dtype):
    """``init_params`` on the card, in slices of 1,000 elements, bit for
    bit the CPU's whole draws."""
    from repro_torch.models import param
    _, cpu = _smoke_params("cpu", dtype)
    monkeypatch.setattr(param, "INIT_SLICE", 1000)
    _, card = _smoke_params(cuda_device, dtype)
    for (p, a), (_, b) in zip(param.leaves(cpu), param.leaves(card)):
        assert b.device.type == "cuda" and b.dtype == a.dtype
        words = torch.int16 if a.element_size() == 2 else torch.int32
        assert torch.equal(a.view(words), b.cpu().view(words)), p


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dot_f32_gradients(cuda_device, dtype):
    """``dot_f32`` on the card (f32 out of cuBLAS, its own backward) and
    on the CPU, 2-D and batched: values and both operands' grads within
    the operands' rounding of the largest magnitude (the card rounds the
    f32 cotangent to bf16 before its products; one element of 90 was
    0.047 off, 0.4% of the largest, on an H100)."""
    from repro_torch.models import layers
    g = torch.Generator().manual_seed(3)
    for shapes in (((6, 5), (5, 7)), ((3, 6, 5), (3, 5, 7))):
        a, b = (torch.randn(s, generator=g).to(dtype) for s in shapes)
        outs = []
        for dev in ("cpu", cuda_device):
            x = a.to(dev).requires_grad_(True)
            y = b.to(dev).requires_grad_(True)
            out = layers.dot_f32(x, y)
            assert out.dtype == torch.float32
            gx, gy = torch.autograd.grad(out.square().sum(), (x, y))
            assert gx.dtype == gy.dtype == dtype
            outs.append([t.detach().float().cpu() for t in (out, gx, gy)])
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        for u, v in zip(*outs):
            torch.testing.assert_close(v, u, rtol=tol,
                                       atol=tol * float(u.abs().max()))


@pytest.mark.cuda
def test_cuda_train_matches_cpu(cuda_device):
    """``launch/train.train`` at the phi4 smoke config on the card and on
    the CPU: the same sampled batch every step (the fold kernel against
    its plain version), the losses within bf16 rounding (rtol 1e-2), one
    fold launch per step."""
    from repro_torch.launch import train as tlt
    seen = {}
    real = tlt.assemble_batch

    def record(*a, **kw):
        out = real(*a, **kw)
        seen.setdefault(str(a[0].device.type), []).append(
            {k: v.cpu() for k, v in out.items()})
        return out
    tlt.assemble_batch = record
    try:
        run = tlt.RunConfig(arch="phi4-mini-3.8b", steps=4)
        quiet = lambda *_: None     # noqa: E731
        cpu = tlt.train(run, device="cpu", log=quiet)
        ops.reset_launch_counts()
        card = tlt.train(run, device=cuda_device, log=quiet)
        assert ops.launch_counts()["reservoir_fold"] == 4
    finally:
        tlt.assemble_batch = real
    for a, b in zip(seen["cpu"], seen["cuda"]):
        assert torch.equal(a["tokens"], b["tokens"])
        assert torch.equal(a["weights"], b["weights"])
    np.testing.assert_allclose(card, cpu, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-350m", "granite-moe-3b-a800m",
                                  "recurrentgemma-9b"])
def test_cuda_family_matches_cpu(cuda_device, monkeypatch, arch):
    """A decoder-only family (ssm, moe, hybrid) at its smoke config in
    f32 on the card and on the CPU: ``init_params`` bit for bit; prefill
    and three decode steps, each decode step with no read back to the
    host (sync debug mode "error"), logits and every state leaf within
    rtol 1e-4 / atol 1e-4; the weighted loss within 1e-4 and its grads
    within rtol 1e-3 or 1e-5 of the largest grad (a gate whose gradient
    is 0 but for rounding, behind the max-stabilizer's winning branch,
    keeps only noise: 4.4e-9 seen on an H100); ``Server.generate`` the CPU's
    tokens and telemetry state bit for bit, one fold launch per step."""
    from repro_torch import configs
    from repro_torch.models import api, param
    from repro_torch.serve import serve_step
    cfg = configs.get_config(arch, smoke=True).replace(dtype=torch.float32)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, 512, (4, 20)).astype(np.int32))
    w = torch.from_numpy(rng.uniform(0.5, 2.0, 4).astype(np.float32))

    def run(dev):
        params = param.init_params(api.skeleton(cfg), prng.PRNGKey(0),
                                   device=dev)
        seen = []
        with torch.inference_mode():
            logits, state = api.prefill_fn(cfg)(params,
                                                {"tokens": toks.to(dev)})
            seen.append((logits, param.map_tree(
                lambda _p, t: t.clone(), api.state_tree(state))))
            for t in range(3):
                nxt = toks[:, t:t + 1].to(dev)
                if dev != "cpu":
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    logits, state = api.decode_fn(cfg)(params, state, nxt)
                finally:
                    if dev != "cpu":
                        torch.cuda.set_sync_debug_mode(0)
                seen.append((logits, param.map_tree(
                    lambda _p, t: t.clone(), api.state_tree(state))))
        live = param.map_tree(lambda _p, t: t.clone().requires_grad_(True),
                              params)
        loss, _ = api.loss_fn(cfg)(live, {"tokens": toks.to(dev),
                                          "weights": w.to(dev)})
        grads = torch.autograd.grad(loss, [t for _, t in
                                           param.leaves(live)])
        monkeypatch.setattr(serve_step, "time", _StepClock())
        server = serve_step.Server(cfg, params, num_tenants=4,
                                   telemetry_capacity=4, device=dev)
        out = server.generate({"tokens": toks.to(dev)}, steps=5,
                              tenant_ids=toks[:, 0].to(dev) % 4)
        return params, seen, loss.detach(), grads, out, server.telemetry

    ops.reset_launch_counts()
    cpu, card = _on_both(run, cuda_device)
    assert ops.launch_counts()["reservoir_fold"] == 5
    for (p, a), (_, b) in zip(param.leaves(cpu[0]), param.leaves(card[0])):
        assert torch.equal(a, b.cpu()), p
    for (la, sa), (lb, sb) in zip(cpu[1], card[1]):
        torch.testing.assert_close(lb.cpu(), la, rtol=1e-4, atol=1e-4)
        for (p, a), (_, b) in zip(param.leaves(sa), param.leaves(sb)):
            torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4,
                                       msg=p)
    torch.testing.assert_close(card[2].cpu(), cpu[2], rtol=1e-4, atol=0.0)
    largest = max(float(g.abs().max()) for g in cpu[3])
    for ga, gb in zip(cpu[3], card[3]):
        torch.testing.assert_close(gb.cpu(), ga, rtol=1e-3,
                                   atol=1e-5 * largest)
    assert torch.equal(cpu[4], card[4].cpu())
    for f in ("values", "counts", "capacity", "key"):
        assert torch.equal(getattr(cpu[5], f), getattr(card[5], f).cpu()), f


@pytest.mark.cuda
def test_cuda_compression_nccl_matches_gloo(cuda_device, tmp_path):
    """``distributed/compression`` on a one-rank ``pod × data`` mesh: NCCL
    on the card bit for bit the same calls over gloo on the CPU (one group
    of backend ``cpu:gloo,cuda:nccl``, destroyed after)."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.distributed import compression as comp
    gen = torch.Generator().manual_seed(5)
    tree = {"w": torch.randn(64, 48, generator=gen) * 3.0,
            "b": [torch.randn(300, generator=gen) * 1e-3,
                  torch.randn(17, generator=gen).to(torch.bfloat16)]}
    tdist.init_process_group("cpu:gloo,cuda:nccl",
                             init_method=f"file://{tmp_path}/pg",
                             world_size=1, rank=0)
    try:
        meshes = [DeviceMesh(d, torch.arange(1).view(1, 1),
                             mesh_dim_names=("pod", "data"))
                  for d in ("cpu", "cuda")]
        calls = [lambda t, m: comp.psum_bf16(t, m.get_group("pod")),
                 lambda t, m: comp.psum_int8(t, m.get_group("pod"))] + [
            lambda t, m, k=k: comp.hierarchical_grad_sync(t, m, cross_pod=k)
            for k in ("int8", "bf16", "none")]
        for fn in calls:
            on_cpu = fn(tree, meshes[0])
            on_card = fn({"w": tree["w"].to(cuda_device),
                          "b": [t.to(cuda_device) for t in tree["b"]]},
                         meshes[1])
            assert torch.equal(on_cpu["w"], on_card["w"].cpu())
            for a, b in zip(on_cpu["b"], on_card["b"]):
                assert torch.equal(a, b.cpu())
    finally:
        tdist.destroy_process_group()
