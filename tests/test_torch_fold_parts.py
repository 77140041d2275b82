"""The parted form of the fold's and the one-shot's claim, on the CPU.

Past 1,024 cells the CUDA fold and one-shot split each cell into a part
(its high bits) and its low bits (``_workspace.parted_plan``), partition
the live items stably by part and rank each part's tiles over the low
bits alone (``csrc/parted_claim.cuh``). The kernels run only on the card
(``test_torch_cuda.py`` holds them to their plain versions there); here
the plan is tested as a pure function, and a numpy model of the parted
rank built from it is held to the sequential fold: every tile holds one
part, each item's arrival index is its cell's running count, and the
Vitter decisions over those arrivals give ``ref.reservoir_fold``'s ring
bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _workspace, ref
from repro_torch.kernels._workspace import (LOOKBACK_KEYS, TILE_ITEMS,
                                            parted_plan)

#: The largest cell count the int32 ring index allows (N_max = 1).
MAX_CELLS_INT32 = 2**31 - 2


@pytest.mark.parametrize("cells,m,lo_bits,passes", [
    (1_025, 524_288, 6, 1), (3_840, 131_072, 6, 1),
    (15_360, 524_288, 7, 1), (262_144, 4_194_304, 9, 1),
    (2**20, 524_288, 10, 1), (2**20 + 1, 524_288, 10, 2),
    (MAX_CELLS_INT32, 4_194_304, 10, 3), (1_025, 1, 6, 1),
    (262_144, 0, 9, 1)])
def test_parted_plan(cells, m, lo_bits, passes):
    """The split, the passes, the grid and the scratch of the plan: every
    look-back over at most 1,024 keys, every part id covered by the
    passes' digits, the claim's grid the item tiles plus one tile a part
    at most, and scratch bounded by the items and the cells."""
    p = parted_plan(cells, m)
    assert p == parted_plan(cells, m)                   # a pure function
    assert (p.lo_bits, p.passes) == (lo_bits, passes)
    assert 2**p.lo_bits <= LOOKBACK_KEYS
    assert p.parts == -(-cells // 2**p.lo_bits)
    assert p.parts * 2**p.lo_bits >= cells > (p.parts - 1) * 2**p.lo_bits
    assert all(k <= LOOKBACK_KEYS for k in p.keys)
    assert p.shifts == tuple(sum(p.bits[:d]) for d in range(p.passes))
    assert all(k == 2**b for k, b in zip(p.keys[:-1], p.bits[:-1]))
    assert p.keys[-1] == ((p.parts - 1) >> p.shifts[-1]) + 1
    assert 2**sum(p.bits) >= p.parts
    assert max(p.bits) - min(p.bits) <= 1                # balanced passes
    if passes == 1:                                      # balanced split
        assert abs(p.lo_bits - p.bits[0]) <= 1
    assert p.tiles == max(-(-m // TILE_ITEMS), 1)
    assert p.claim_grid == p.tiles + min(p.parts, m)
    assert len(p.ints()) == 14
    tiles_x_cells = p.tiles * cells
    assert p.status_words <= 2 * m + cells + 5 * LOOKBACK_KEYS
    assert p.status_words < tiles_x_cells or m <= TILE_ITEMS
    assert p.zeroed_words <= 3 * LOOKBACK_KEYS + 2 * p.parts + 1
    assert p.meta_words <= (3 * LOOKBACK_KEYS + p.parts + 1
                            + 4 * p.claim_grid)
    assert p.item_words == 4 * m * (1 if passes == 1 else 2)
    assert p.claim_grid * TILE_ITEMS <= m + TILE_ITEMS + p.parts * TILE_ITEMS


@pytest.mark.parametrize("cells,m", [(1, 10), (2**31, 10), (1_025, -1),
                                    (1_025, 2**31)])
def test_parted_plan_refuses(cells, m):
    """No plan for fewer than two cells, for a cell or item index past
    int32, or for a negative item count."""
    with pytest.raises(ValueError):
        parted_plan(cells, m)


def _stable_pass(seq_j, seq_cell, digit, keys, tiles):
    """One partition pass as the kernel runs it: per tile of TILE_ITEMS
    positions the digit counts and in-order ranks, the earlier tiles'
    counts of each digit (the look-back), the digit's offset; returns
    the scattered (item, cell) pairs."""
    n = len(seq_j)
    live = seq_cell >= 0
    totals = np.bincount(digit[live], minlength=keys)
    off = np.concatenate(([0], np.cumsum(totals)[:-1]))
    out_j = np.full(int(totals.sum()), -1, np.int64)
    out_c = np.full(int(totals.sum()), -1, np.int64)
    before = np.zeros(keys, np.int64)                    # earlier tiles
    for t in range(tiles):
        lo, hi = t * TILE_ITEMS, min((t + 1) * TILE_ITEMS, n)
        if lo >= hi:
            break
        run = np.zeros(keys, np.int64)
        for q in range(lo, hi):
            if not live[q]:
                continue
            d = digit[q]
            pos = off[d] + before[d] + run[d]
            out_j[pos], out_c[pos] = seq_j[q], seq_cell[q]
            run[d] += 1
        before += run
    assert (out_j >= 0).all()
    return out_j, out_c


def parted_arrivals(cell, counts, plan):
    """The parted form's arrival index of each live item (0 for none)
    and the new counts, from ``plan``; asserts the partition is stable
    and that every claim tile holds items of one part."""
    m = len(cell)
    part = np.where(cell >= 0, cell >> plan.lo_bits, -1)
    seq_j, seq_c = np.arange(m), cell.astype(np.int64)
    for d in range(plan.passes):
        digit = np.where(seq_c >= 0, (seq_c >> plan.lo_bits)
                         >> plan.shifts[d], 0) & (2**plan.bits[d] - 1)
        assert digit[seq_c >= 0].max(initial=0) < plan.keys[d]
        seq_j, seq_c = _stable_pass(seq_j, seq_c, digit, plan.keys[d],
                                    plan.tiles)
    live = np.nonzero(cell >= 0)[0]
    want = live[np.argsort(part[live], kind="stable")]
    assert np.array_equal(seq_j, want)                   # stable by part
    n_part = np.bincount(part[live], minlength=plan.parts)
    first = np.concatenate(([0], np.cumsum(n_part)))
    n_tiles = -(-n_part // TILE_ITEMS)
    assert n_tiles.sum() <= plan.claim_grid
    lo_keys = 2**plan.lo_bits
    arrival = np.zeros(m, np.int64)
    new_counts = counts.astype(np.int64).copy()
    for p in range(plan.parts):
        before = np.zeros(lo_keys, np.int64)             # the look-back
        for t in range(n_tiles[p]):
            a = first[p] + t * TILE_ITEMS
            b = min(a + TILE_ITEMS, first[p + 1])
            tile_c = seq_c[a:b]
            assert ((tile_c >> plan.lo_bits) == p).all()  # one part a tile
            run = np.zeros(lo_keys, np.int64)
            for j, c in zip(seq_j[a:b], tile_c):
                k = c & (lo_keys - 1)
                arrival[j] = counts[c] + before[k] + run[k] + 1
                run[k] += 1
            before += run
        cells_p = np.arange(p * lo_keys,
                            min((p + 1) * lo_keys, len(counts)))
        new_counts[cells_p] = counts[cells_p] + before[:len(cells_p)]
    return arrival, new_counts


def vitter_ring(cell, arrival, inp, values):
    """The ring after the Vitter decisions over ``arrival`` (f32 as the
    kernel's: u*c < N, floor(u_slot*N) clamped), the last accepted item
    of a ring cell winning it."""
    ring = values.copy()
    cap = inp["capacity"]
    for j in np.nonzero(cell >= 0)[0]:
        c, s = int(arrival[j]), int(cell[j])
        n = int(cap[s])
        if c <= n:
            slot = c - 1
        elif np.float32(inp["u_accept"][j]) * np.float32(c) < np.float32(n):
            slot = int(np.floor(np.float32(inp["u_slot"][j])
                                * np.float32(n)))
            slot = min(max(slot, 0), max(n - 1, 0))
        else:
            continue
        ring[s, slot] = inp["payload"][j]
    return ring


CASES = {
    "uniform": dict(cells=1_025, m=20_000),
    "zipf": dict(cells=15_360, m=30_001, keys="zipf"),
    "one_cell": dict(cells=3_840, m=9_000, keys="one"),
    "empty_part": dict(cells=3_840, m=12_000, keys="no_part_3"),
    "ragged": dict(cells=2_000, m=2_049),
    "two_passes": dict(cells=2**20 + 1, m=6_000, n_max=1),
}


def _case(cells, m, keys="uniform", n_max=4, seed=5):
    rng = np.random.default_rng(seed)
    sid = rng.integers(0, cells, m)
    if keys == "zipf":
        sid = np.minimum(rng.zipf(1.2, m) - 1, cells - 1)
    elif keys == "one":
        sid[:] = cells // 3
    elif keys == "no_part_3":
        lo = 2**parted_plan(cells, m).lo_bits
        sid = np.where(sid // lo == 3, sid + lo, sid) % cells
    inp = dict(stratum_ids=sid.astype(np.int32),
               payload=rng.normal(size=m).astype(np.float32),
               u_accept=rng.random(m, dtype=np.float32),
               u_slot=rng.random(m, dtype=np.float32),
               mask=rng.random(m) < 0.9,
               counts=rng.integers(0, 3 * n_max, cells).astype(np.int32),
               capacity=rng.integers(1, n_max + 1, cells).astype(np.int32))
    values = rng.normal(size=(cells, n_max)).astype(np.float32)
    return inp, values


@pytest.mark.parametrize("case", sorted(CASES))
def test_parted_rank_is_the_running_count(case):
    """The model's arrivals equal each cell's running count over the
    chunk, its new counts the plain fold's, and the Vitter decisions over
    its arrivals give ``ref.reservoir_fold``'s ring bit for bit."""
    kw = CASES[case]
    inp, values = _case(**kw)
    cells, m = kw["cells"], kw["m"]
    plan = parted_plan(cells, m)
    cell = np.where(inp["mask"], inp["stratum_ids"], -1).astype(np.int64)
    if case == "empty_part":
        assert not ((cell >> plan.lo_bits) == 3).any()
    arrival, new_counts = parted_arrivals(cell, inp["counts"], plan)
    live = cell >= 0
    running = np.zeros(m, np.int64)
    seen = inp["counts"].astype(np.int64).copy()
    for j in np.nonzero(live)[0]:
        seen[cell[j]] += 1
        running[j] = seen[cell[j]]
    assert np.array_equal(arrival[live], running[live])
    ring = vitter_ring(cell, arrival, inp, values)
    vp = torch.from_numpy(values.copy())
    cp = ref.reservoir_fold(values=vp, **{k: torch.from_numpy(v)
                                          for k, v in inp.items()})
    assert np.array_equal(new_counts, cp.numpy())
    assert np.array_equal(ring.view(np.int32), vp.numpy().view(np.int32))


def test_workspace_parted_scratch_is_the_plans():
    """The CPU workspace grows the parted scratch to the plan's words (the
    one-shot's ingested words per stratum after the plan's zeroed ones);
    the zeroed words start at 0 and the pointer array has one slot a
    ``PartedSlot``, the second item buffer only past one pass."""
    ws = _workspace.Workspace(torch.device("cpu"))
    for cells, m, passes in ((15_360, 5_000, 1), (2**20 + 1, 5_000, 2)):
        plan = parted_plan(cells, m)
        plan_c, pt = ws.parted(plan, cells=cells, strata=cells // 4)
        assert tuple(plan_c) == plan.ints()
        assert plan.passes == passes
        assert ws.part_zeroed.numel() >= plan.zeroed_words + cells // 4
        assert not bool(ws.part_zeroed.any())
        assert ws.part_meta.numel() >= plan.meta_words
        assert ws.part_items.numel() >= plan.item_words
        assert ws.base.numel() >= cells and ws.cap.numel() >= cells
        assert len(pt) == 6
        assert (pt[3] is not None) == (passes > 1)


class _Layout:
    """The library's tile answers, as the kernels give them."""

    @staticmethod
    def sa_fold_tile_items():
        return TILE_ITEMS

    @staticmethod
    def sa_fold_tile_lists():
        return 16


@pytest.mark.parametrize("cells,m", [(1_025, 524_288), (262_144, 4_194_304),
                                     (15_360, 1)])
def test_workspace_for_call_holds_the_plan(cells, m):
    """With a plan, a call's look-back words and lists are the plan's:
    its status words, and a tile's entries and counts for each tile of the
    claim's grid."""
    dev = torch.device("cpu")
    _workspace.drop(dev, 13)
    plan = parted_plan(cells, m)
    ws = _workspace.for_call(_Layout, dev, 13, m=m, cells=cells,
                             table=cells, plan=plan)
    assert ws.status.numel() >= plan.status_words
    assert not bool(ws.status.any())
    assert ws.lists.numel() >= 2 * TILE_ITEMS * plan.claim_grid
    assert ws.list_n.numel() >= 16 * plan.claim_grid
    _workspace.drop(dev, 13)
