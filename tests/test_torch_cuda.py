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

#: Shards of one batched one-shot call, each in another state (overrides
#: of ``one_shot_inputs``' defaults): every item masked out; a frontier
#: crossing an interval with late and dropped items; cells over capacity
#: (the items inside the open interval, so no slot resets); a chunk
#: filling empty cells.
SHARDS = {"all_masked": ONE_SHOT_CASES["all_masked"],
          "crossing": ONE_SHOT_CASES["crossing"],
          "over_capacity": dict(ONE_SHOT_CASES["over_capacity"], t_hi=0.9),
          "filling": ONE_SHOT_CASES["filling"]}


def stack_shards(parts):
    """numpy arrays (and dicts of them) stacked on a new leading axis."""
    if isinstance(parts[0], dict):
        return {k: stack_shards([p[k] for p in parts]) for k in parts[0]}
    return np.stack(parts)


def shard_inputs(cases, seed, **kw):
    """numpy ``(items, state)`` of one one-shot call batched over
    ``len(cases)`` shards: shard ``w`` is ``one_shot_inputs`` of
    ``SHARDS[cases[w]]`` (with ``kw``), from seed ``seed + w``."""
    shards = [one_shot_inputs(seed + w, **dict(SHARDS[c], **kw))
              for w, c in enumerate(cases)]
    return (stack_shards([items for items, _ in shards]),
            stack_shards([state for _, state in shards]))


#: The states of a batched fold call's folds, fold ``b`` in
#: ``FOLD_KINDS[b % 3]``: counts over random capacities, empty cells, every
#: item masked out.
FOLD_KINDS = ("replacement", "filling", "all_masked")


def fold_batch_inputs(seed, w, k, s=4, n_max=64, m=300, leaves=1):
    """numpy inputs of one fold call batched over ``w`` shards' ``k`` ring
    slots, as the masked ingest makes them: items ``[w, m]``, each masked
    into one slot of its shard (9 in 10 masked in at all), so mask ``[w,
    k, m]``; counts, capacity ``[w, k, s]`` and ring ``[w, k, s, n_max]``
    by ``FOLD_KINDS``. ``leaves=2``: payload and ring ``{"val": f32,
    "key": i32}``."""
    rng = np.random.default_rng(seed)
    kinds = np.array([FOLD_KINDS[b % 3] for b in range(w * k)]).reshape(w, k)
    slot = rng.integers(0, k, (w, m))
    mask = ((slot[:, None, :] == np.arange(k)[None, :, None])
            & (rng.random((w, m)) < 0.9)[:, None, :])
    mask[kinds == "all_masked"] = False
    counts = rng.integers(n_max, 4 * n_max, (w, k, s)).astype(np.int32)
    counts[kinds == "filling"] = 0
    out = dict(
        stratum_ids=rng.integers(0, s, (w, m)).astype(np.int32),
        payload=rng.normal(100.0, 30.0, (w, m)).astype(np.float32),
        u_accept=rng.random((w, m), dtype=np.float32),
        u_slot=rng.random((w, m), dtype=np.float32), mask=mask,
        counts=counts,
        capacity=rng.integers(1, n_max + 1, (w, k, s)).astype(np.int32),
        values=rng.normal(0.0, 1.0, (w, k, s, n_max)).astype(np.float32))
    if leaves == 2:
        out["payload"] = {"val": out["payload"], "key": rng.integers(
            0, 9999, (w, m)).astype(np.int32)}
        out["values"] = {"val": out["values"], "key": rng.integers(
            0, 9999, (w, k, s, n_max)).astype(np.int32)}
    return out


def fold_of(inp, i, j):
    """Fold ``(i, j)`` of a batched call's inputs: shard ``i``'s items,
    slot ``j``'s mask, counts, capacity and ring (views)."""
    def at(v, lead):
        if isinstance(v, dict):
            return {n: at(x, lead) for n, x in v.items()}
        return v[lead]
    folds = ("mask", "counts", "capacity", "values")
    return {n: at(v, (i, j) if n in folds else i) for n, v in inp.items()}


def two_leaves(items, state, seed):
    """A one-shot case with a payload of two leaves, ``{"val": f32, "key":
    i32}`` (the heavy-hitter keys riding beside the values, as the
    reference's pytree payloads), the ring likewise: ``val`` is the
    case's own f32 payload and ring, ``key`` drawn from ``seed`` (of the
    items' shape: ``[M]``, or ``[W, M]`` batched over shards)."""
    rng = np.random.default_rng(seed)
    ring = state["values"]
    return (dict(items, payload={
                "val": items["payload"],
                "key": rng.integers(0, 9999, items["times"].shape
                                    ).astype(np.int32)}),
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
                 mask_p=0.9, ragged=False, bins=32):
    """numpy ``(values, cell_ids, weights, mask, edges)`` of one weighted
    histogram over ``g`` cells (``bins`` bins; 24 with ``edges="log2"``).

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
        e = np.linspace(lo, hi, bins + 1).astype(np.float32)
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


#: Payload trees of the fold kernel, as phase payloads (a) of
#: ``chip_smoke.py`` folds them: leaf -> (item shape, dtype). "mixed10"
#: takes two write launches (8 + 2 leaves); "bytes" has rows that are no
#: multiple of 4 bytes (copied in bytes).
FOLD_TREES = {
    "two": {"val": ((), torch.float32), "key": ((), torch.int32)},
    "mixed10": {"vec": ((3,), torch.float32), "half": ((), torch.bfloat16),
                "flag": ((), torch.bool), "id": ((), torch.int64),
                **{f"f{i}": ((), torch.float32) for i in range(6)}},
    "bytes": {"i8": ((), torch.int8), "flag": ((), torch.bool),
              "half3": ((3,), torch.bfloat16)},
}


def tree_leaf(gen, shape, dtype):
    """A seeded leaf of ``shape`` and ``dtype`` (on the CPU)."""
    if dtype == torch.bool:
        return torch.rand(shape, generator=gen) < 0.5
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=gen) * 100.0).to(dtype)
    return torch.randint(-100, 100, shape, generator=gen, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("tree", sorted(FOLD_TREES))
@pytest.mark.parametrize("phase", ["filling", "replacement"])
def test_cuda_fold_tree_matches_plain(cuda_device, tree, phase):
    """Kernel 1 on a payload tree: every leaf and the counts bit for bit
    the plain version's, one launch counted, the scratch clean after."""
    inp = {k: torch.from_numpy(np.array(v)).to(cuda_device)
           for k, v in fold_inputs(8, 1000, *PHASES[phase]).items()}
    inp.pop("values")
    gen = torch.Generator().manual_seed(3)
    leaves = FOLD_TREES[tree]
    inp["payload"] = {k: tree_leaf(gen, (1000,) + sh, dt).to(cuda_device)
                      for k, (sh, dt) in leaves.items()}
    start = {k: tree_leaf(gen, (4, 64) + sh, dt).to(cuda_device)
             for k, (sh, dt) in leaves.items()}
    vk = {k: v.clone() for k, v in start.items()}
    vp = {k: v.clone() for k, v in start.items()}
    before = reservoir.reservoir_fold.launches
    ck = reservoir.reservoir_fold(values=vk, **inp)
    cp = ref.reservoir_fold(values=vp, **inp)
    assert reservoir.reservoir_fold.launches == before + 1
    assert torch.equal(ck, cp)
    for k in leaves:
        a, b = vk[k], vp[k]
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), k
        assert bool((vk[k] != start[k]).any()), k
    assert_workspace_clean(cuda_device)


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
    winner table all -1, the look-back words, counters and tickets and
    the parted form's totals and tickets all 0 (the workspace of
    ``stream``, by default the current one)."""
    torch.cuda.synchronize()
    stream = stream or torch.cuda.current_stream(dev)
    ws = _workspace.get(dev, stream.cuda_stream)
    assert bool((ws.winner == -1).all())
    assert not bool(ws.status.any())
    assert not bool(ws.counters.any())
    assert not bool(ws.tickets.any())
    assert not bool(ws.part_zeroed.any())


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


#: Cells of the parted fold and one-shot cases: one past the small-key
#: form's 1,024, either side of the plan's balanced splits (4,095: 6 + 6
#: bits, 4,097: 7 + 6, 16,385: 8 + 7, 65,535: 8 + 8, 65,537: 9 + 8), the
#: per-key stress's 262,144, and 2**20 + 1, which takes a second
#: partition pass.
LARGE_CELLS = (1_025, 4_095, 4_097, 16_385, 65_535, 65_537, 262_144,
               2**20 + 1)
#: The parted cases' keys: uniform; every live item in one cell (one part
#: spans every tile); the keys skewed to one part; every item masked out;
#: a chunk of one item.
PARTED_KEYS = ("uniform", "one_cell", "one_part", "all_masked", "one_item")
#: (cells, keys) of the parted cases: every cell count with uniform keys,
#: the other keys at the threshold and at the stress.
PARTED_CASES = ([(c, "uniform") for c in LARGE_CELLS]
                + [(c, k) for c in (1_025, 262_144) for k in PARTED_KEYS[1:]])


def parted_chunk(items, keys, cells, lo_bits, one_shot_k=1):
    """``items`` (numpy, in place) re-keyed as ``keys`` names: the stratum
    ids of a fold (``one_shot_k`` 1) or of a one-shot's ``[K, S]`` ring
    (its times then all in one interval, so every live item lands in one
    slot); returns the items, cut to one for ``"one_item"``."""
    s = cells // one_shot_k
    sid = items["stratum_ids"]
    if keys == "one_cell":
        sid[:] = s // 2
    elif keys == "one_part":
        sid[:] = sid % min(s, 2**lo_bits)
    elif keys == "all_masked":
        items["mask"][:] = False
    if one_shot_k > 1 and keys in ("one_cell", "one_part"):
        items["times"][:] = items["times"].max()
    if keys == "one_item":
        items = {k: v[:1] for k, v in items.items()}
    return items


def _fold_twice(inp, ring_k, ring_p, start):
    """Both versions on one chunk, then the kernel again on ``start``:
    the same bits."""
    ck = _fold_both(inp, ring_k, ring_p)
    again = start.clone()
    assert torch.equal(reservoir.reservoir_fold(values=again, **inp), ck)
    assert_same_bits(again, ring_k, "twice")
    return ck


@pytest.mark.cuda
@pytest.mark.parametrize("cells,keys", PARTED_CASES)
@pytest.mark.parametrize("phase", ["filling", "replacement"])
def test_cuda_fold_large_keys_matches_plain(cuda_device, cells, phase, keys):
    """The fold past MAX_STRATA strata (the parted form): ring and counts
    bit for bit the plain version's, the same bits twice, the parted form
    counted, the scratch clean after it, over two chunks into one ring."""
    assert cells > reservoir.MAX_STRATA
    rng = np.random.default_rng(cells)
    n_max = 8
    counts = (np.zeros(cells) if phase == "filling"
              else rng.integers(0, 40, cells)).astype(np.int32)
    capacity = rng.integers(1, n_max + 1, cells).astype(np.int32)
    lo_bits = _workspace.parted_plan(cells, BIG_M).lo_bits
    first = fold_inputs(51, BIG_M, counts, capacity, s=cells, n_max=n_max)
    ring_p = torch.from_numpy(first.pop("values")).to(cuda_device)
    ring_k = ring_p.clone()
    inp = {k: torch.from_numpy(v).to(cuda_device) for k, v in first.items()}
    for i in range(2):
        nxt = parted_chunk(fold_inputs(52 + i, BIG_M, counts, capacity,
                                       s=cells, n_max=n_max), keys, cells,
                           lo_bits)
        for k in ("stratum_ids", "payload", "u_accept", "u_slot", "mask"):
            inp[k] = torch.from_numpy(nxt[k]).to(cuda_device)
        start = ring_k.clone()
        before = dict(reservoir.reservoir_fold.forms)
        inp["counts"] = _fold_twice(inp, ring_k, ring_p, start)
        assert reservoir.reservoir_fold.forms["parted"] == before["parted"] + 2
        assert reservoir.reservoir_fold.forms["small"] == before["small"]
        assert_workspace_clean(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("cells,keys", PARTED_CASES)
@pytest.mark.parametrize("case", ["replacement", "crossing"])
def test_cuda_one_shot_large_keys_matches_plain(cuda_device, cells, case,
                                                keys):
    """The one-shot past MAX_CELLS cells K*S (the parted form): every
    field bit for bit the plain version's over two chunks, the same bits
    twice, the parted form counted, the scratch clean after each."""
    k = next((d for d in (5, 4, 3) if cells % d == 0), 1)
    kw = dict(k=k, s=cells // k, n_max=8, counts_hi=20, cap=None)
    if case == "crossing":
        kw.update(max_time=3.2, open_interval=3, t_lo=2.6, t_hi=4.4)
    lo_bits = _workspace.parted_plan(cells, BIG_M).lo_bits
    _, state = one_shot_inputs(53, m=8, **kw)
    sk, sp = _to(cuda_device, state), _to(cuda_device, state)
    for i in range(2):
        items, _ = one_shot_inputs(54 + i, m=BIG_M, **dict(
            kw, t_lo=kw.get("t_lo", 0.0) + i, t_hi=kw.get("t_hi", 3.5) + i))
        it = _to(cuda_device, parted_chunk(items, keys, cells, lo_bits, k))
        again = {f: v.clone() for f, v in sk.items()}
        before = dict(one_shot.one_shot_ingest.forms)
        _one_shot_both(it, sk, sp)
        one_shot.one_shot_ingest(**it, span=1.0, allowed_lateness=0.5,
                                 **again)
        for f in ONE_SHOT_FIELDS:
            assert_same_bits(again[f], sk[f], f)
        assert one_shot.one_shot_ingest.forms["parted"] == (
            before["parted"] + 2)
        assert_workspace_clean(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["filling", "replacement"])
def test_cuda_fold_parted_tree_matches_plain(cuda_device, phase):
    """The parted fold on the ten-leaf tree (two write launches): every
    leaf and the counts bit for bit the plain version's."""
    cells = 1_025
    rng = np.random.default_rng(61)
    counts = (np.zeros(cells) if phase == "filling"
              else rng.integers(0, 40, cells)).astype(np.int32)
    inp = _to(cuda_device, fold_inputs(
        62, BIG_M, counts, rng.integers(1, 9, cells).astype(np.int32),
        s=cells, n_max=8))
    inp.pop("values")
    gen = torch.Generator().manual_seed(5)
    leaves = FOLD_TREES["mixed10"]
    inp["payload"] = {k: tree_leaf(gen, (BIG_M,) + sh, dt).to(cuda_device)
                      for k, (sh, dt) in leaves.items()}
    start = {k: tree_leaf(gen, (cells, 8) + sh, dt).to(cuda_device)
             for k, (sh, dt) in leaves.items()}
    vk = {k: v.clone() for k, v in start.items()}
    vp = {k: v.clone() for k, v in start.items()}
    assert torch.equal(reservoir.reservoir_fold(values=vk, **inp),
                       ref.reservoir_fold(values=vp, **inp))
    for k in leaves:
        a, b = vk[k], vp[k]
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), k
    assert_workspace_clean(cuda_device)


@pytest.mark.cuda
def test_cuda_parted_and_small_calls_interleaved(cuda_device):
    """Small and parted folds and one-shots in turns on one stream, one
    scratch: bitwise after each, the scratch clean after each."""
    rng = np.random.default_rng(63)
    folds = []
    for cells in (4, 1_025, 15_360):
        counts = rng.integers(0, 40, cells).astype(np.int32)
        cap = rng.integers(1, 9, cells).astype(np.int32)
        inp = _to(cuda_device, fold_inputs(64, BIG_M, counts, cap, s=cells,
                                           n_max=8))
        ring = inp.pop("values")
        folds.append((inp, ring.clone(), ring))
    shots = []
    for k, s in ((3, 4), (5, 205), (60, 64)):
        _, state = one_shot_inputs(65, k=k, s=s, m=8, n_max=8, cap=None)
        shots.append((k, s, _to(cuda_device, state),
                      _to(cuda_device, state)))
    for i in range(2):
        for (inp, rk, rp), (k, s, sk, sp) in zip(folds, shots):
            inp["counts"] = _fold_both(inp, rk, rp)
            assert_workspace_clean(cuda_device)
            items, _ = one_shot_inputs(66 + i, k=k, s=s, m=BIG_M // 2 + i,
                                       n_max=8, t_lo=0.2 + i, t_hi=1.4 + i)
            _one_shot_both(_to(cuda_device, items), sk, sp)
            assert_workspace_clean(cuda_device)


@pytest.mark.cuda
def test_cuda_parted_plan_is_the_librarys(cuda_device):
    """The library takes every plan ``_workspace.parted_plan`` makes, and
    refuses one whose grid or split is off."""
    import ctypes
    from repro_torch.kernels import _build
    lib = _build.build().lib
    assert lib.sa_fold_tile_items() == _workspace.TILE_ITEMS
    for cells in (1_025, 3_840, 15_360, 262_144, 2**20, 2**20 + 1,
                  2**31 - 2):
        for m in (0, 1, 2_049, 524_288, 4_194_304):
            ints = _workspace.parted_plan(cells, m).ints()
            arr = (ctypes.c_int * len(ints))(*ints)
            assert lib.sa_parted_plan_ok(arr, cells, m) == 1
            bad = list(ints)
            bad[4] += 1                           # the claim's grid
            arr = (ctypes.c_int * len(bad))(*bad)
            assert lib.sa_parted_plan_ok(arr, cells, m) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cells", [12, 1_025])
def test_cuda_one_shot_ten_leaves_matches_plain(cuda_device, cells):
    """A payload of ten leaves (two write launches of 8 and 2), in both
    forms: every leaf and field bit for bit the plain version's."""
    k = 3 if cells == 12 else 5
    one, state = one_shot_inputs(56, k=k, s=cells // k, n_max=64, m=BIG_M,
                                 counts_hi=40, cap=None)
    rng = np.random.default_rng(57)
    items = dict(one, payload={f"l{i}": (1000 * rng.normal(
        size=BIG_M)).astype(np.float32 if i % 2 else np.int32)
        for i in range(10)})
    ring = {f"l{i}": (1000 * rng.normal(size=state["values"].shape)).astype(
        np.float32 if i % 2 else np.int32) for i in range(10)}
    it = to_tree(cuda_device, items)
    sk = to_tree(cuda_device, dict(state, values=ring))
    sp = to_tree(cuda_device, dict(state, values=ring))
    one_shot.one_shot_ingest(**it, span=1.0, allowed_lateness=0.5, **sk)
    ref.one_shot_ingest(**it, span=1.0, allowed_lateness=0.5, **sp)
    for f in ONE_SHOT_FIELDS:
        if f == "values":
            for leaf in ring:
                assert_same_bits(sk[f][leaf], sp[f][leaf], leaf)
        else:
            assert_same_bits(sk[f], sp[f], f)
    assert_workspace_clean(cuda_device)


#: The batched one-shot's cases: shards -> the cases of its shards, and
#: each form's ring (the small form's 3 x 4 cells, the parted 5 x 205).
SHARD_MIXES = {1: ("crossing",), 2: ("all_masked", "crossing"),
               4: ("all_masked", "crossing", "over_capacity", "filling")}
SHARD_FORMS = {"small": dict(k=3, s=4, n_max=64),
               "parted": dict(k=5, s=205, n_max=8)}


def _tree_bits(a, b, name):
    if isinstance(a, dict):
        for leaf in a:
            assert_same_bits(a[leaf], b[leaf], f"{name}.{leaf}")
    else:
        assert_same_bits(a, b, name)


@pytest.mark.cuda
@pytest.mark.parametrize("leaves", [1, 2])
@pytest.mark.parametrize("form", sorted(SHARD_FORMS))
@pytest.mark.parametrize("w", sorted(SHARD_MIXES))
def test_cuda_one_shot_shards_match_plain(cuda_device, w, form, leaves):
    """One call batched over W shards (all masked, crossing with late and
    dropped items, over capacity, filling) in each form: every field of
    every shard bit for bit the batched plain version's, twice (the same
    bits from the same start), one launch and one call of the form
    counted per call whatever W is, the scratch (winner table, look-back
    words, counters, the parted form's totals) clean after each call."""
    items, state = shard_inputs(SHARD_MIXES[w], 71, m=BIG_M,
                                **SHARD_FORMS[form])
    if leaves == 2:
        items, state = two_leaves(items, state, 72)
    it = to_tree(cuda_device, items)
    start = to_tree(cuda_device, state)
    sp = to_tree(cuda_device, state)
    ref.one_shot_ingest(**it, span=1.0, allowed_lateness=0.5, **sp)
    for _ in range(2):
        sk = to_tree(cuda_device, state)
        launches = one_shot.one_shot_ingest.launches
        forms = dict(one_shot.one_shot_ingest.forms)
        one_shot.one_shot_ingest(**it, span=1.0, allowed_lateness=0.5, **sk)
        assert one_shot.one_shot_ingest.launches == launches + 1
        assert one_shot.one_shot_ingest.forms[form] == forms[form] + 1
        assert_workspace_clean(cuda_device)
        for f in ONE_SHOT_FIELDS:
            _tree_bits(sk[f], sp[f], f)
    late = sp["late"] - start["late"]
    assert int(late[SHARD_MIXES[w].index("crossing")]) > 0


@pytest.mark.cuda
def test_cuda_batched_and_unbatched_one_shots_interleaved(cuda_device):
    """Batched calls of both forms (W = 3 and W = 2) and unbatched calls
    in turns on one stream, one scratch: each bit for bit its plain
    version, the scratch clean after each."""
    runs = []
    for cases, form in ((("crossing", "over_capacity", "filling"), "small"),
                        (("over_capacity", "crossing"), "parted"),
                        (("crossing",), "small"), (("crossing",), "parted")):
        _, state = shard_inputs(cases, 73, m=8, **SHARD_FORMS[form])
        if len(cases) == 1:               # an unbatched call
            state = {k: v[0] for k, v in state.items()}
        runs.append((cases, form, _to(cuda_device, state),
                     _to(cuda_device, state)))
    for i in range(2):
        for cases, form, sk, sp in runs:
            items, _ = shard_inputs(cases, 74 + i, m=BIG_M // 2 + i,
                                    **SHARD_FORMS[form])
            if len(cases) == 1:
                items = {k: v[0] for k, v in items.items()}
            _one_shot_both(_to(cuda_device, items), sk, sp)
            assert_workspace_clean(cuda_device)


#: The batched fold's cases: W·K -> (W, K, items a shard): one fold, two
#: slots, the paper's 4 workers' K = 2 (phase sharded's masked path), the
#: sliding deployment's 4 x 60 at its executor's chunk; and each form's
#: ring (S, N_max).
FOLD_BATCHES = {1: (1, 1, BIG_M), 2: (1, 2, BIG_M), 8: (4, 2, BIG_M),
                240: (4, 60, 8_192)}
FOLD_BATCH_FORMS = {"small": (4, 64), "parted": (1_025, 8)}


@pytest.mark.cuda
@pytest.mark.parametrize("leaves", [1, 2])
@pytest.mark.parametrize("form", sorted(FOLD_BATCH_FORMS))
@pytest.mark.parametrize("folds", sorted(FOLD_BATCHES))
def test_cuda_fold_batches_match_plain(cuda_device, folds, form, leaves):
    """One fold call batched over W·K folds (replacement, filling and all
    masked in turn) in each form: every fold's ring and counts bit for bit
    the batched plain version's and its own unbatched kernel call's, one
    launch and one call of the form counted per call whatever W·K is, the
    scratch clean after each call."""
    w, k, m = FOLD_BATCHES[folds]
    s, n_max = FOLD_BATCH_FORMS[form]
    inp = to_tree(cuda_device, fold_batch_inputs(
        93 + folds, w, k, s=s, n_max=n_max, m=m, leaves=leaves))
    start = inp.pop("values")
    vk, vp, vu = (start.clone() if leaves == 1
                  else {n: t.clone() for n, t in start.items()}
                  for _ in range(3))
    launches = reservoir.reservoir_fold.launches
    forms = dict(reservoir.reservoir_fold.forms)
    ck = reservoir.reservoir_fold(values=vk, **inp)
    assert reservoir.reservoir_fold.launches == launches + 1
    assert reservoir.reservoir_fold.forms[form] == forms[form] + 1
    assert_workspace_clean(cuda_device)
    cp = ref.reservoir_fold(values=vp, **inp)
    assert torch.equal(ck, cp)
    _tree_bits(vk, vp, "values")
    for i in range(w):
        for j in range(k):
            one = fold_of(dict(inp, values=vu), i, j)
            assert torch.equal(reservoir.reservoir_fold(**one), ck[i, j])
    assert_workspace_clean(cuda_device)
    _tree_bits(vu, vk, "unbatched")
    for a, b in ([(vk, start)] if leaves == 1
                 else [(vk[n], start[n]) for n in start]):
        assert bool((a != b).any())


@pytest.mark.cuda
@pytest.mark.parametrize("entry", [2, 4])
@pytest.mark.parametrize("keys,m", [(513, 1_000), (4_096, 200_003),
                                    (2**19 + 1, 1_048_583)])
def test_cuda_partition_is_stable(cuda_device, keys, m, entry):
    """The parted forms' shared count and partition launches alone
    (``sa_stats_partition``) with both payloads: the stats' ``(stratum,
    x)`` (``entry`` 2) and the fold's ``(item, stratum, u_accept,
    u_slot)`` (4). The last pass's entries are the live items' in a
    stable order by part (item order inside a part), every other zeroed
    word 0 after it (the look-back words, which the sums launch clears
    in a call, cleared here)."""
    from repro_torch.kernels import _build
    lib = _build.build().lib
    dev = cuda_device
    rng = np.random.default_rng(keys + entry)
    sid = rng.integers(-3, keys + 3, m).astype(np.int32)
    mask = rng.random(m) < 0.8
    x, ua, us = (rng.random(m).astype(np.float32) for _ in range(3))
    plan = _workspace.parted_plan(keys, m, stratified_stats.MAX_STRATA)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace.get(dev, stream)
    # room for entries of `entry` words: m * entry / 2 entries of two
    ints, pt = ws.parted_reduce(plan, m * entry // 2, 2)
    t = [torch.from_numpy(a).to(dev) for a in (x, sid, mask, ua, us)]
    assert lib.sa_stats_partition(*(a.data_ptr() for a in t), m, keys,
                                  entry, ints, pt, stream) == 0
    torch.cuda.synchronize()
    live = np.flatnonzero(mask & (sid >= 0) & (sid < keys))
    order = live[np.argsort(sid[live] >> plan.lo_bits, kind="stable")]
    first = entry * m if plan.passes % 2 == 0 else 0
    got = ws.part_items[first:first + entry * len(order)].view(
        -1, entry).cpu().numpy()
    bits = [a.view(np.int32) for a in (x, ua, us)]
    want = (np.stack([sid[order], bits[0][order]], 1) if entry == 2 else
            np.stack([order.astype(np.int32), sid[order], bits[1][order],
                      bits[2][order]], 1))
    np.testing.assert_array_equal(got, want)
    ws.status.zero_()
    assert_workspace_clean(dev)


#: The parted stats' cases: (strata, items); 2**19 + 1 strata take two
#: partition passes.
PARTED_STATS = {"past": (513, 200_003), "4096": (4_096, 200_003),
                "two_passes": (2**19 + 1, 1_048_583)}
#: The parted histogram's cases: (cells, bins, items).
PARTED_HIST = {"past": (97, 33, 200_003), "sliding": (15_360, 32, 1_048_583)}
#: The keys of a parted case: in row order (each key's items one run, as
#: the emission's view), at random, or every item masked out.
PARTED_IDS = ("rows", "random", "all_masked")


def parted_ids(rng, ids, keys, m):
    """``m`` int32 ids of ``keys`` keys, and a mask (0.8 live, or none)."""
    sid = (np.arange(m) * keys // m if ids == "rows"
           else rng.integers(0, keys, m)).astype(np.int32)
    return sid, rng.random(m) < (0.0 if ids == "all_masked" else 0.8)


#: The parted form's launches, by the kernels' names.
PARTED_KERNELS = ("parted_count", "parted_partition", "parted_sums")


def launches_per_call(fn, tries=4, calls=3):
    """Device activities per call of ``fn``, by kind (each of
    PARTED_KERNELS, ``"memset"``, ``"other"``), from a ``torch.profiler``
    trace of ``calls`` calls after a warm-up step of as many (the tracer
    can drop a trace's first events); a window whose counts are not whole
    multiples of the calls is traced again."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        kinds = {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA or \
                    e.name.startswith("ProfilerStep"):
                continue
            kind = ("memset" if "Memset" in e.name else next(
                (k for k in PARTED_KERNELS if k in e.name), "other"))
            kinds[kind] = kinds.get(kind, 0) + 1
        if kinds and all(n % calls == 0 for n in kinds.values()):
            return {k: n // calls for k, n in kinds.items()}
    raise AssertionError(f"no whole trace of {calls} calls: {kinds}")


def parted_launches(passes):
    """The parted form's launches a call over a plan of ``passes``."""
    return {"parted_count": 1, "parted_partition": passes, "parted_sums": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("ids", PARTED_IDS)
@pytest.mark.parametrize("case", sorted(PARTED_STATS))
def test_cuda_stats_parted_matches_plain(cuda_device, case, ids):
    """Past MAX_STRATA the parted form: counts bit for bit, sums within
    1e-5 of the f64-summed plain version, a second call the same bits,
    the scratch clean; 2 + the plan's passes kernels a call, no memset."""
    s, m = PARTED_STATS[case]
    rng = np.random.default_rng(s)
    sid, mask = parted_ids(rng, ids, s, m)
    vals = rng.normal(100.0, 10.0, m).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (vals, sid, mask)]
    forms = dict(stratified_stats.stratified_stats.forms)
    kc, _, _ = _stats_call(*args, s)
    assert stratified_stats.stratified_stats.forms["parted"] == \
        forms["parted"] + 2
    assert float(kc.sum()) == float(mask.sum())
    plan = _workspace.parted_plan(s, m, stratified_stats.MAX_STRATA)
    assert launches_per_call(lambda: stratified_stats.stratified_stats(
        *args, s)) == parted_launches(plan.passes)


@pytest.mark.cuda
@pytest.mark.parametrize("ids", PARTED_IDS)
@pytest.mark.parametrize("case", sorted(PARTED_HIST))
def test_cuda_weighted_hist_parted_matches_plain(cuda_device, case, ids):
    """Past MAX_CELLS_BINS the parted form, as the stats' (the mass
    within 1e-5 of the f64-summed plain version)."""
    g, b, m = PARTED_HIST[case]
    rng = np.random.default_rng(g * b)
    cell, mask = parted_ids(rng, ids, g, m)
    x = rng.uniform(0.0, 100.0, m).astype(np.float32)
    w = rng.uniform(1.0, 5.0, g).astype(np.float32)[cell]
    e = np.linspace(10.0, 90.0, b + 1).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (x, cell, w, mask,
                                                          e)]
    forms = dict(weighted_hist.weighted_hist.forms)
    _, kc = _whist_call(*args, g)
    assert weighted_hist.weighted_hist.forms["parted"] == forms["parted"] + 2
    assert float(kc.sum()) == float((mask & (x >= 10.0) & (x <= 90.0)).sum())
    plan = _workspace.parted_plan(g * b, m, weighted_hist.PARTED_LO_KEYS)
    assert launches_per_call(lambda: weighted_hist.weighted_hist(
        *args, g)) == parted_launches(plan.passes)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["prefix", "random", "none"])
def test_cuda_weighted_hist_view_past_row_bins(cuda_device, mask):
    """A ``[G, N]`` view over 4,097 bins takes the parted form on the flat
    view: held to the plain row version, the same bits twice, its 3
    kernels a call (beside the row ids and weights the wrapper builds)."""
    g, n, bins = 5, 3_000, weighted_hist.MAX_ROW_BINS + 1
    x, w, live, e = (torch.from_numpy(a).to(cuda_device)
                     for a in rows_inputs(66, g, n, mask, bins=bins))
    got, want = _rows_calls(weighted_hist.weighted_hist_rows,
                            ref.weighted_hist_rows, [x, w, live, e],
                            "parted")
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0.0)
    got = launches_per_call(lambda: weighted_hist.weighted_hist_rows(
        x, w, live, e))
    assert {k: got.get(k) for k in PARTED_KERNELS} == parted_launches(1)


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
    """K unbatched folds of one chunk, each into the [S, N_max] view of
    one ring slot with that slot's mask (the masked ingest's folds, one
    call each): bitwise after each."""
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
@pytest.mark.parametrize("m", [100, 200_003])
def test_cuda_weighted_hist_many_cells_bins_matches_plain(cuda_device, m):
    """G*B = 101 x 100, past MAX_CELLS_BINS: the parted form, held to
    the plain version as the one-launch form is, the same bits twice."""
    assert 101 * 100 > weighted_hist.MAX_CELLS_BINS
    x, cell, w, mask, e = (torch.from_numpy(a).to(cuda_device)
                           for a in whist_inputs(1, m, g=101, bins=100))
    _whist_call(x, cell, w, mask, e, 101)


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


#: Strata of the stats limit cases: the one-launch form's most, the
#: parted form past it and at 65,536, and an all-masked call.
STATS_LIMITS = {"max_strata": 512, "past_max": 513, "many": 65_536,
                "all_masked": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(STATS_LIMITS))
@pytest.mark.parametrize("m", [1000, 200_003])
def test_cuda_stats_limits_match_plain(cuda_device, case, m):
    """S = MAX_STRATA strata, past it (the parted form), and a call
    with every slot masked out."""
    rng = np.random.default_rng(45)
    s = STATS_LIMITS[case]
    vals = rng.normal(100.0, 10.0, m).astype(np.float32)
    sid = rng.integers(0, s, m).astype(np.int32)
    mask = rng.random(m) < (0.0 if case == "all_masked" else 0.8)
    kc, _, _ = _stats_call(*(torch.from_numpy(a).to(cuda_device)
                             for a in (vals, sid, mask)), s)
    assert float(kc.sum()) == float(mask.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["stats", "weighted_hist", "stats_large",
                                    "weighted_hist_large"])
def test_cuda_fifty_calls_give_the_same_bits(cuda_device, kernel):
    """50 back-to-back calls over 2**21 + 5 items (all 512 blocks, their
    last tickets taken in whatever order they finish; the parted forms'
    partition and part tiles likewise): one result."""
    m = 2**21 + 5
    if kernel.startswith("stats"):
        s = 600 if kernel.endswith("large") else 4
        vals, _, mask = stats_inputs(47, m)
        sid = np.random.default_rng(48).integers(0, s, m).astype(np.int32)
        _stats_call(*(torch.from_numpy(a).to(cuda_device)
                      for a in (vals, sid, mask)), s, calls=50)
    else:
        g = 200 if kernel.endswith("large") else 6
        x, cell, w, mask, e = (torch.from_numpy(a).to(cuda_device)
                               for a in whist_inputs(47, m, g=g,
                                                     edges="log2"))
        _whist_call(x, cell, w, mask, e, g, calls=50)


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


def rows_inputs(seed, g, n, mask="prefix", bins=32):
    """numpy ``(values [g, n], row weights [g], mask [g, n], edges)`` of a
    row-form call: Gaussian values, weights in [1, 4), 33 (``bins + 1``)
    edges uniform over the live values. ``mask``: ``"prefix"`` (a sample
    size per row, as the emission's slot mask, some rows with none),
    ``"random"`` (a general mask) or ``"none"`` (every slot dead)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(100.0, 10.0, (g, n)).astype(np.float32)
    w = rng.uniform(1.0, 4.0, g).astype(np.float32)
    if mask == "prefix":
        taken = rng.integers(0, n + 1, g)
        taken[::7] = 0
        live = np.arange(n)[None, :] < taken[:, None]
    else:
        live = rng.random((g, n)) < (0.7 if mask == "random" else 0.0)
    lo, hi = (float(x[live].min()), float(x[live].max())) if live.any() \
        else (0.0, 1.0)
    e = np.linspace(lo, hi, bins + 1).astype(np.float32)
    return x, w, live, e


def _rows_calls(fn, plain, args, form, calls=2):
    """``calls`` back-to-back row-form calls of ``fn`` (a wrapper of
    ``kernels``) against one call of ``plain``: the runs, the plain
    result; every run the first one's bits, each call a launch of
    ``form``, the scratch clean after them."""
    owner = (stratified_stats.stratified_stats
             if fn is stratified_stats.stratified_stats_rows
             else weighted_hist.weighted_hist)
    before = owner.launches, dict(owner.forms)
    runs = [fn(*args) for _ in range(calls)]
    want = plain(*args)
    assert owner.launches == before[0] + calls
    assert owner.forms[form] == before[1][form] + calls
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert_same_bits(a, b)
    assert_workspace_clean(args[0].device)
    return runs[0], want


#: Slots a row of the row-form cases: a slot, rows off 16-byte boundaries
#: (3, 5, 513), the stress view's 64, and rows cut into parts (stats past
#: 4,096 slots, the histogram past 8,192).
ROW_NS = [1, 3, 5, 64, 513, 4_100, 17_000]


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["prefix", "random", "none"])
@pytest.mark.parametrize("n", ROW_NS)
def test_cuda_stats_rows_match_plain(cuda_device, n, mask):
    """G = MAX_STRATA + 1 rows: the row form, counts bit for bit, sums
    within rtol 1e-5 of the plain version, the same bits twice."""
    g = stratified_stats.MAX_STRATA + 1
    x, _, live, _ = rows_inputs(61, g, n, mask)
    args = [torch.from_numpy(a).to(cuda_device) for a in (x, live)]
    (kc, ks, kq), (pc, ps, pq) = _rows_calls(
        stratified_stats.stratified_stats_rows, ref.stratified_stats_rows,
        args, "row")
    assert torch.equal(kc, pc)
    torch.testing.assert_close(ks, ps, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(kq, pq, rtol=1e-5, atol=0.0)
    assert float(kc.sum()) == float(live.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["prefix", "random", "none"])
@pytest.mark.parametrize("n", ROW_NS)
def test_cuda_weighted_hist_rows_match_plain(cuda_device, n, mask):
    """G = 101 rows x 32 bins, past MAX_CELLS_BINS: the row form, counts
    and mass bit for bit the plain version's (a count times its row's
    weight, rounded once, is the f64 sum rounded once), the same bits
    twice."""
    x, w, live, e = rows_inputs(62, 101, n, mask)
    args = [torch.from_numpy(a).to(cuda_device) for a in (x, w, live, e)]
    (kh, kc), (ph, pc) = _rows_calls(
        weighted_hist.weighted_hist_rows, ref.weighted_hist_rows, args,
        "row")
    assert 101 * 32 > weighted_hist.MAX_CELLS_BINS
    assert torch.equal(kc, pc)
    assert_same_bits(kh, ph, "whist")
    assert float(kc.sum()) == float(live.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("edges", ["narrow", "outside", "collapsed"])
def test_cuda_weighted_hist_rows_edges(cuda_device, edges):
    """The row form with few values in a bin, none, and every edge
    equal to every value (all in the last bin)."""
    x, w, live, _ = rows_inputs(63, 150, 300)
    if edges == "collapsed":
        x[:] = 1480.0
        e = np.full(33, 1480.0, np.float32)
    else:
        lo = 100.0 if edges == "narrow" else 1e4
        e = np.linspace(lo, lo + 0.5, 33).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (x, w, live, e)]
    (kh, kc), (ph, pc) = _rows_calls(
        weighted_hist.weighted_hist_rows, ref.weighted_hist_rows, args,
        "row")
    assert torch.equal(kc, pc)
    assert_same_bits(kh, ph, "whist")
    if edges == "collapsed":
        assert float(kc[:, -1].sum()) == float(live.sum())
    if edges == "outside":
        assert float(kc.sum()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,g,bins,form", [
    ("stats", 512, 32, "small"), ("stats", 513, 32, "row"),
    ("whist", 100, 32, "small"), ("whist", 101, 32, "row"),
    ("whist", 1, 4_096, "row"), ("whist", 1, 4_097, "parted")])
def test_cuda_row_entries_take_their_form(cuda_device, kernel, g, bins,
                                          form):
    """Each row entry's form by shape: at the caps the one-launch form on
    the flat view with row ids, the bits of the flat call; past them the
    row form; past MAX_ROW_BINS the parted form; each held to its plain
    version."""
    x, w, live, e = rows_inputs(64, g, 1_000, bins=bins)
    x, w, live, e = (torch.from_numpy(a).to(cuda_device)
                     for a in (x, w, live, e))
    flat = (x.reshape(-1), ref.row_ids(g, 1_000, cuda_device))
    if kernel == "stats":
        assert stratified_stats.stats_form(g) == form
        got, want = _rows_calls(stratified_stats.stratified_stats_rows,
                                ref.stratified_stats_rows, [x, live], form)
        if form == "small":
            for a, b in zip(got, stratified_stats.stratified_stats(
                    *flat, live.reshape(-1), g)):
                assert_same_bits(a, b)
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0.0)
    else:
        assert weighted_hist.hist_form(g, bins) == form
        got, want = _rows_calls(weighted_hist.weighted_hist_rows,
                                ref.weighted_hist_rows, [x, w, live, e],
                                form)
        if form == "small":
            for a, b in zip(got, weighted_hist.weighted_hist(
                    *flat, w.repeat_interleave(1_000),
                    live.reshape(-1), e, g)):
                assert_same_bits(a, b)
        assert torch.equal(got[1], want[1])
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_cuda_stats_rows_past_256_parts(cuda_device):
    """513 rows of 1,100,000 slots (269 parts a row: each row's finisher
    folds two parts on some threads): counts and sums against float64
    sums of the same view, the same bits twice, the scratch clean."""
    g, n = 513, 1_100_000
    gen = torch.Generator(device=cuda_device).manual_seed(65)
    x = 100.0 + 10.0 * torch.randn((g, n), generator=gen, device=cuda_device)
    live = torch.rand((g, n), generator=gen, device=cuda_device) < 0.6
    runs = [stratified_stats.stratified_stats_rows(x, live)
            for _ in range(2)]
    for a, b in zip(runs[1], runs[0]):
        assert_same_bits(a, b)
    assert_workspace_clean(cuda_device)
    xd = torch.where(live, x.double(), 0.0)
    kc, ks, kq = runs[0]
    assert torch.equal(kc, live.sum(1).float())
    torch.testing.assert_close(ks.double(), xd.sum(1), rtol=1e-5, atol=0.0)
    torch.testing.assert_close(kq.double(), (xd * x.double()).sum(1),
                               rtol=1e-5, atol=0.0)


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


def hist_fault_chunks(seed=11, n=12, m=512, s=16):
    """numpy chunks of a disordered 16-stratum stream, a quarter interval
    each at span 1."""
    rng = np.random.default_rng(seed)
    mus = np.resize(np.array([10.0, 100.0, 1000.0, 50.0]), s)
    chunks = []
    for e in range(n):
        sid = rng.integers(0, s, m).astype(np.int32)
        vals = (mus[sid] * (1 + 0.2 * rng.standard_normal(m))).astype(
            np.float32)
        t = ((e * m + np.arange(m)) / (4.0 * m)
             - (rng.random(m) < 0.3) * rng.random(m)).clip(0)
        chunks.append((vals, sid, t.astype(np.float32), rng.random(m) > 0.05))
    return chunks


@pytest.mark.cuda
def test_cuda_hist_quantile_past_the_histogram_cap(cuda_device):
    """K = 8 intervals over S = 16 strata with a hist quantile: each
    refinement round's histogram takes G·B = 128 x 32 = 4,096 keys, past
    the one-launch form's 3,200, so it runs the large-key form (it used to
    raise at the first emission). The card against the CPU: the same state
    bit for bit, answers within rtol."""
    cfg = tex.RuntimeConfig(num_strata=16, capacity=16, num_intervals=8,
                            interval_span=1.0, allowed_lateness=0.5,
                            emit_every=4)
    runs = []
    for dev in ("cpu", cuda_device):
        ops.reset_launch_counts()
        reg = (treg.QueryRegistry().register("total", "sum")
               .register("q_hist", "quantile", qs=(0.25, 0.9),
                         method="hist", num_replicates=4))
        ex = tex.PipelinedExecutor(cfg, reg, prng.PRNGKey(7), device=dev)
        for c in hist_fault_chunks():
            ex.push(TimestampedChunk(*(torch.from_numpy(a).to(dev)
                                       for a in c)))
        ems = ex.finalize()
        runs.append(([convert.results_to_numpy(em.results) for em in ems],
                     convert.state_to_numpy(ex.state), ops.launch_counts()))
    (ce, cs, cl), (ge, gs, gl) = runs
    assert 128 * 32 > weighted_hist.MAX_CELLS_BINS
    assert cl["weighted_hist"] == 0
    assert gl["weighted_hist"] == len(ge) * 2 * 4 > 0
    for part in ("window", "slot_interval", "open_interval", "wm",
                 "metrics"):
        np.testing.assert_equal(gs[part], cs[part])
    assert len(ce) == len(ge) == 3
    for a, b in zip(ce, ge):
        for name in a:
            np.testing.assert_allclose(b[name]["value"], a[name]["value"],
                                       rtol=1e-5)
            np.testing.assert_allclose(b[name]["variance"],
                                       a[name]["variance"], rtol=1e-3,
                                       atol=1e-6)
    assert_workspace_clean(cuda_device)


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
    interval restrictions), through the row entries the emission calls
    (the one-launch form takes the same storage flattened)."""
    from repro_torch.runtime import checkpoint as ckp
    phases = []
    stats, whist = ops.stratified_stats_rows, ops.weighted_histogram_rows

    def stats_at(values, *a, **kw):
        phases.append(("stats", values.data_ptr() % 16))
        return stats(values, *a, **kw)

    def whist_at(values, *a, **kw):
        phases.append(("whist", values.data_ptr() % 16))
        return whist(values, *a, **kw)
    monkeypatch.setattr(ops, "stratified_stats_rows", stats_at)
    monkeypatch.setattr(ops, "weighted_histogram_rows", whist_at)
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
    ``W·K·S`` cells (``fused``), ONE fold call batched over the ``W·K``
    (shard, slot) folds (``masked``) or ONE one-shot call batched over
    the W shards (``onekernel``); two stats calls per emission."""
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
    n = 12
    want = {"fused": (n, 0), "masked": (n, 0), "onekernel": (0, n)}[ingest]
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
