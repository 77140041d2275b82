"""The plain reference against hand-worked cases and the published
Threefry answers."""
import numpy as np
import torch

import tiny  # noqa: F401  (puts the benchmark on sys.path)
from reference import estimates, replay, threefry


def test_threefry_known_answers():
    # Random123's known-answer vectors for Threefry-2x32, 20 rounds.
    cases = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
             ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
              (0x1CB996FC, 0xBB002BE7)),
             ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
              (0xC4923A9C, 0x483DF7A0))]
    for key, (hi, lo), want in cases:
        assert threefry.hash_int(key, hi, lo) == want
        b0, b1 = threefry.hash_pairs(key, torch.tensor([hi]),
                                     torch.tensor([lo]))
        assert (int(b0), int(b1)) == want


def test_uniforms_are_the_top_bits_of_the_xored_words():
    key = (7, 11)
    u = threefry.uniforms(key, 5, "cpu", block=2)
    for j in range(5):
        b0, b1 = threefry.hash_int(key, 0, j)
        word = ((b0 ^ b1) >> 9) | 0x3F800000
        want = np.array([word], np.uint32).view(np.float32)[0] - 1.0
        assert u[j].item() == want


def layout(**kw):
    base = dict(num_strata=2, num_intervals=2, interval_span=5.0,
                allowed_lateness=0.5, capacity=2, seed=3)
    base.update(kw)
    return replay.Layout(**base)


def test_route_verdicts_by_hand():
    lay = layout()
    # Before: frontier 12.0 (watermark 11.5), newest interval 2.
    times = torch.tensor([11.0, 11.6, 14.9, 15.0, 4.0])
    r = replay.route(lay, times, 12.0, 2)
    # 11.0 is below the watermark: dropped. 15.0 opens interval 3, so
    # the ring holds 2 and 3 and 4.0 (interval 0) is dropped too.
    assert r.accept.tolist() == [False, True, True, True, False]
    assert r.target.tolist() == [2, 2, 2, 3, 0]
    assert r.late.tolist() == [False, False, False, False, False]
    assert r.open_interval == 3 and r.max_time == 15.0
    # A late item: older than the newest interval, above the watermark.
    r2 = replay.route(lay, torch.tensor([14.8]), 15.2, 3)
    assert r2.accept.tolist() == [True] and r2.late.tolist() == [True]


def test_counters_by_hand():
    lay = layout()
    c = replay.Counters(2)
    r = replay.route(lay, torch.tensor([11.0, 11.6, 14.9, 15.0, 4.0]),
                     12.0, 2)
    c.add(torch.tensor([0, 1, 1, 0, 1], dtype=torch.int32), r)
    assert c.ingested.tolist() == [2, 3]
    assert c.accepted.tolist() == [1, 2]
    assert c.dropped.tolist() == [1, 1]
    assert c.late.tolist() == [0, 0]


def test_slot_table():
    lay = layout(num_intervals=3)
    assert replay.initial_slots(lay) == (0, -2, -1)
    assert replay.held_intervals(lay, 4) == (3, 4, 2)


def test_fold_fills_then_replaces_by_hand():
    lay = layout(num_strata=1, num_intervals=1, capacity=2)
    vals = torch.tensor([10.0, 20.0, 30.0, 40.0])
    sids = torch.zeros(4, dtype=torch.int32)
    r = replay.route(lay, torch.tensor([0.1, 0.2, 0.3, 0.4]),
                     replay.NEG_TIME, 0)
    counts = torch.zeros(1, dtype=torch.int64)
    ring = torch.zeros((1, 2))
    key = (5, 9)
    st = replay.fold_chunk(lay, vals, sids, r, counts, key, ring)
    kids = threefry.split_int(key, 3)
    ua = threefry.uniforms(kids[1], 4, "cpu")
    us = threefry.uniforms(kids[2], 4, "cpu")
    want = [10.0, 20.0]
    kept = 2
    for j, c in ((2, 3), (3, 4)):       # arrivals past capacity
        if ua[j].item() * np.float32(c) < 2.0:
            want[int(np.floor(us[j].item() * 2.0))] = vals[j].item()
            kept += 1
    assert ring[0].tolist() == want
    assert counts.tolist() == [4]
    assert st.live == 4 and st.fill == 2 and st.accepted == kept


def test_estimates_by_hand():
    lay = layout(num_strata=2, num_intervals=1, capacity=2)
    ring = torch.tensor([[[1.0, 3.0], [5.0, 0.0]]])      # [K, S, N]
    counts = np.array([[4, 1]])                          # C per cell
    out = estimates.answers(ring, counts, 2, [
        {"name": "s", "kind": "sum"}, {"name": "m", "kind": "mean"},
        {"name": "k", "kind": "sum", "window": "per_key"},
        {"name": "c", "kind": "count", "gt": 2.0}])
    # Cell 0: C=4, Y=2, weight 2, sum 4, s2 = 2; cell 1: C=Y=1.
    assert out["s"][0] == [2 * 4 + 5.0]
    var = 4 * (4 - 2) * 2.0 / 2
    assert np.isclose(out["s"][1][0], 2 * np.sqrt(var))
    assert out["m"][0] == [13.0 / 5]
    var_m = (4 / 5) ** 2 * 2.0 / 2 * (2 / 4)
    assert np.isclose(out["m"][1][0], 2 * np.sqrt(var_m))
    assert out["k"][0] == [8.0, 5.0]
    assert out["c"][0] == [2 * 1 + 1.0]


def test_view_cells_live_slots_and_closed_interval():
    lay = layout(num_intervals=2, num_strata=1)
    counts = np.array([[3], [4]])
    # Newest interval 0: only slot 0 is live.
    assert estimates.view_cells(lay, (0, -1), 0, counts).tolist() == [
        [3], [0]]
    assert estimates.view_cells(lay, (2, 1), 2, counts).tolist() == [
        [3], [4]]
    # Watermark emission of interval 1: slot 1 alone.
    assert estimates.view_cells(lay, (2, 1), 2, counts, 1).tolist() == [
        [0], [4]]
