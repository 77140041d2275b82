"""The bytes that ``chip_smoke.py`` counts for the stats and histogram
kernels' bounds, against a count by hand on small CPU tensors.

A bound counts only what the function needs: every mask byte, then the
fields of the slots that the mask (stats, histogram values) or a bin
(histogram cell ids and weights) lets through, then the outputs."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _workspace

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_bounds", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stats(mask, s=3):
    m = len(mask)
    return (torch.arange(m, dtype=torch.float32),
            torch.arange(m, dtype=torch.int32) % s,
            torch.tensor(mask, dtype=torch.bool), s)


@pytest.mark.parametrize("mask,live", [
    ([1, 1, 0, 1, 0, 0, 1], 4),
    ([0] * 9, 0),
    ([1] * 5, 5),
])
def test_stats_need_counts_mask_live_fields_and_outputs(smoke, mask, live):
    x, sid, m, s = _stats(mask)
    need = smoke.stats_need(torch, x, sid, m, s)
    assert need["live"] == live and need["slots"] == len(mask)
    assert need["bytes"] == len(mask) + 8 * live + 12 * s
    assert need["ops"] == 4 * live


def _whist(values, mask, edges, cells, g):
    return (torch.tensor(values, dtype=torch.float32),
            torch.tensor(cells, dtype=torch.int32),
            torch.full((len(values),), 2.0),
            torch.tensor(mask, dtype=torch.bool),
            torch.tensor(edges, dtype=torch.float32), g)


#: (values, mask, edges, live, in a bin). Bins [0, 1), [1, 2), [2, 4].
WHIST_HAND = {
    "some_out": ([0.5, 1.5, 9.0, 3.0, -1.0, 4.0], [1, 1, 1, 0, 1, 1],
                 [0.0, 1.0, 2.0, 4.0], 5, 3),
    "all_masked": ([0.5, 1.5, 3.0], [0, 0, 0], [0.0, 1.0, 2.0, 4.0], 0, 0),
    "all_outside": ([5.0, 6.0, -3.0, float("nan")], [1, 1, 1, 1],
                    [0.0, 1.0, 2.0, 4.0], 4, 0),
    "collapsed": ([2.0, 2.0, 2.5], [1, 1, 1], [2.0, 2.0, 2.0, 2.0], 3, 2),
}


@pytest.mark.parametrize("case", sorted(WHIST_HAND))
def test_whist_need_counts_mask_live_values_and_in_bin_fields(smoke, case):
    values, mask, edges, live, in_bin = WHIST_HAND[case]
    g, nb = 2, len(edges) - 1
    cells = [i % g for i in range(len(values))]
    need = smoke.whist_need(torch, *_whist(values, mask, edges, cells, g))
    assert (need["live"], need["in_bin"], need["bins"]) == (live, in_bin, nb)
    assert need["bytes"] == (len(values) + 4 * live + 8 * in_bin
                             + 4 * (nb + 1) + 8 * g * nb)
    assert need["ops"] == (int(np.ceil(np.log2(nb))) + 4) * live


def test_whist_need_of_a_narrow_bracket_is_mostly_mask_and_values(smoke):
    """A later refinement round: of 1,000 live values, the 10 inside the
    bracket need their cell id and weight."""
    values = list(range(1000))
    edges = list(np.linspace(500.0, 509.5, 33))
    need = smoke.whist_need(torch, *_whist(values, [1] * 1000, edges,
                                           [0] * 1000, 1))
    assert need["in_bin"] == 10
    assert need["bytes"] == 1000 + 4 * 1000 + 8 * 10 + 4 * 33 + 8 * 32


def test_workspace_reduce_rows_grow_and_tickets_start_at_zero():
    """The stats and histogram kernels' scratch: rows grown on demand and
    kept, zeroed words (tickets, count totals) made 0 and kept."""
    dev = torch.device("cpu")
    _workspace.drop(dev, 5)
    ws = _workspace.get(dev, 5).reserve_rows(words=100, tickets=33)
    assert ws.rows.dtype == torch.float32 and ws.rows.numel() >= 100
    assert ws.tickets.numel() >= 33 and not bool(ws.tickets.any())
    kept = (ws.rows, ws.tickets)
    ws.reserve_rows(words=10, tickets=33)
    assert ws.rows is kept[0] and ws.tickets is kept[1]
    ws.reserve_rows(words=1000, tickets=33)
    assert ws.rows.numel() >= 1000 and ws.tickets is kept[1]
    _workspace.drop(dev, 5)


class _FakeZeroed:
    """The library's count of zeroed words: 33 tickets, then one count
    total per key."""

    @staticmethod
    def sa_reduce_zeroed(keys):
        return 33 + keys


def test_workspace_for_reduce_is_the_stream_workspace():
    dev = torch.device("cpu")
    _workspace.drop(dev, 6)
    ws = _workspace.for_reduce(_FakeZeroed, dev, 6, words=77, keys=192)
    assert ws is _workspace.get(dev, 6)
    assert ws.rows.dtype == torch.float32 and ws.rows.numel() >= 77
    assert ws.tickets.numel() >= 33 + 192 and not bool(ws.tickets.any())
    assert bool((ws.winner == -1).all())
    _workspace.drop(dev, 6)
