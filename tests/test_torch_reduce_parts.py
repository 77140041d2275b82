"""The parted form of the stats and the histogram, on the CPU.

Past the keys a block's shared memory holds (the stats' 512 strata, the
histogram's 3,200 keys ``G·B``, a histogram view's 4,096 bins) the CUDA
wrappers write each key as (part, low bits) by ``_workspace.parted_plan``
with the small form's cap on the low keys, partition the live items
stably by part and sum each part's tiles over its low bits
(``csrc/parted_reduce.cuh``). The kernels run only on the card
(``test_torch_cuda.py`` holds them to their plain versions there); here
the plan is tested as a pure function, the form as a function of shape
alone, and the flat callers that take the parted form on the card
(``query.exact_stats``, ``baselines.sample_stats``, a histogram view past
4,096 bins) run their plain versions against the reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbl
from repro.core import query as jquery
from repro.kernels.weighted_hist import weighted_hist as jwhist
from repro_torch.core import baselines as tbl
from repro_torch.core import query as tquery
from repro_torch.kernels import _workspace, ops, stratified_stats
from repro_torch.kernels import weighted_hist
from repro_torch.kernels._workspace import (LOOKBACK_KEYS,
                                            REDUCE_ENTRY_WORDS, TILE_ITEMS,
                                            parted_plan)
from test_torch_cuda import rows_inputs

STATS_LO = stratified_stats.MAX_STRATA
HIST_LO = weighted_hist.PARTED_LO_KEYS


@pytest.mark.parametrize("keys,lo_keys,lo_bits,passes", [
    (513, STATS_LO, 5, 1), (4_096, STATS_LO, 6, 1),
    (15_360, STATS_LO, 7, 1), (262_144, STATS_LO, 9, 1),
    (2**19, STATS_LO, 9, 1), (2**19 + 1, STATS_LO, 9, 2),
    (2**23, STATS_LO, 9, 2), (3_201, HIST_LO, 6, 1),
    (491_520, HIST_LO, 10, 1), (2**23, HIST_LO, 10, 2)])
def test_reduce_plan(keys, lo_keys, lo_bits, passes):
    """The plan of the parted stats (at most 512 low keys) and histogram
    (1,024): a pure function; every key's part and low bits reassemble
    it and the passes' digits its part; each look-back over at most
    1,024 keys; 3 launches (count, partition, sums) up to 2**19 strata,
    one more for each further partition pass."""
    m = 1_048_576
    p = parted_plan(keys, m, lo_keys)
    assert p == parted_plan(keys, m, lo_keys)
    assert (p.lo_bits, p.passes) == (lo_bits, passes)
    assert 2**p.lo_bits <= lo_keys <= LOOKBACK_KEYS
    assert all(k <= LOOKBACK_KEYS for k in p.keys)
    assert 2 + p.passes == (3 if keys <= 2**19 else 4)
    rng = np.random.default_rng(keys)
    ks = np.unique(np.concatenate([
        [0, 1, keys - 2, keys - 1], rng.integers(0, keys, 4_096)]))
    part, lo = ks >> p.lo_bits, ks & (2**p.lo_bits - 1)
    assert np.array_equal((part << p.lo_bits) | lo, ks)
    assert part.max() < p.parts and lo.max() < 2**p.lo_bits
    whole = np.zeros_like(part)
    for d in range(p.passes):
        digit = (part >> p.shifts[d]) & (2**p.bits[d] - 1)
        assert digit.max() < p.keys[d]
        whole |= digit << p.shifts[d]
    assert np.array_equal(whole, part)


@pytest.mark.parametrize("keys,m", [(513, 1), (262_144, 16_777_216),
                                    (2**23, 16_777_216), (2**19 + 1, 0)])
def test_reduce_scratch_grows_with_items_and_keys(keys, m):
    """The parted form's scratch (``Workspace.parted_reduce``, here on
    CPU tensors): entries of two words, look-back words tiles x digit
    keys, a row a reduce tile over the low keys; each bounded by a
    multiple of ``m + keys``, never tiles x keys."""
    p = parted_plan(keys, m, STATS_LO)
    ws = _workspace.Workspace(torch.device("cpu"))
    if m > 1_000_000:                 # the sizes alone, not the tensors
        items = REDUCE_ENTRY_WORDS * m * (1 if p.passes == 1 else 2)
        rows = 3 * p.claim_grid << p.lo_bits
        look = p.tiles * sum(p.keys)
    else:
        ints, pt = ws.parted_reduce(p, m, 2)
        assert list(ints) == list(p.ints()) and len(pt) == 9
        items, rows, look = (ws.part_items.numel(), ws.rows.numel(),
                             ws.status.numel())
        assert not ws.part_zeroed.any() and not ws.status.any()
    assert items <= 4 * max(m, 1)
    assert look <= max(m, TILE_ITEMS) // TILE_ITEMS * 2 * LOOKBACK_KEYS
    assert rows <= 3 * (max(m, 1) + keys + STATS_LO)
    assert rows < 3 * p.tiles * keys or m <= TILE_ITEMS


@pytest.mark.parametrize("s,form", [(1, "small"), (512, "small"),
                                    (513, "parted"), (65_536, "parted"),
                                    (2**19 + 1, "parted")])
def test_flat_stats_form_by_shape(s, form):
    """A flat stats call's form is a function of S alone: the one-launch
    form up to MAX_STRATA, the parted form past it (no cap)."""
    assert stratified_stats.flat_form(s) == form


@pytest.mark.parametrize("g,bins,form", [(100, 32, "small"),
                                         (1, 3_200, "small"),
                                         (97, 33, "parted"),
                                         (15_360, 32, "parted"),
                                         (1, 4_097, "parted")])
def test_flat_hist_form_by_shape(g, bins, form):
    """A flat histogram call's form is a function of G·B alone."""
    assert weighted_hist.flat_form(g, bins) == form


def _stats_close(got, want):
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert np.array_equal(got.taken.numpy(), np.asarray(want.taken))
    for f in ("sums", "sumsqs"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=0.0, err_msg=f)


def _window(seed, m, s):
    rng = np.random.default_rng(seed)
    values = rng.normal(100.0, 10.0, m).astype(np.float32)
    sid = rng.integers(0, s, m).astype(np.int32)
    return rng, values, sid


def test_exact_stats_past_the_stats_cap():
    """The native baseline's ground truth at S = 1,024 with random ids
    (the parted form on the card) against the reference's: counts bit for
    bit, sums within 1e-5."""
    s = 1_024
    rng, values, sid = _window(81, 20_000, s)
    mask = rng.random(values.shape[0]) < 0.8
    want = jquery.exact_stats(jnp.asarray(values), jnp.asarray(sid), s,
                              jnp.asarray(mask))
    got = tquery.exact_stats(torch.from_numpy(values), torch.from_numpy(sid),
                             s, torch.from_numpy(mask))
    _stats_close(got, want)


@pytest.mark.parametrize("given", [True, False])
def test_sample_stats_past_the_stats_cap(given):
    """STS's per-stratum stats of a sample at S = 1,024 with random ids,
    with pass 1's counts given and as the HT estimate (one weight a
    stratum, as STS's), against the reference's."""
    s, m = 1_024, 6_000
    rng, values, sid = _window(82, m, s)
    sel = rng.random(m) < 0.5
    w_stratum = rng.uniform(1.0, 4.0, s).astype(np.float32)
    weights = np.where(sel, w_stratum[sid], 0.0).astype(np.float32)
    counts = np.bincount(sid, minlength=s).astype(np.int32)
    extra = (counts,) if given else ()
    want = jbl.sample_stats(jnp.asarray(values), jnp.asarray(sid),
                            jbl.WindowSample(jnp.asarray(sel),
                                             jnp.asarray(weights)),
                            s, *(jnp.asarray(c) for c in extra))
    got = tbl.sample_stats(torch.from_numpy(values), torch.from_numpy(sid),
                           tbl.WindowSample(torch.from_numpy(sel),
                                            torch.from_numpy(weights)),
                           s, *(torch.from_numpy(c) for c in extra))
    _stats_close(got, want)


@pytest.mark.parametrize("g,n,mask", [(2, 300, "prefix"), (3, 97, "random")])
def test_histogram_view_past_row_bins(g, n, mask):
    """A ``[G, N]`` view over 4,097 bins (the parted form on the flat view
    on the card) against the reference's kernel in interpret mode: counts
    bit for bit, mass within 1e-5."""
    bins = weighted_hist.MAX_ROW_BINS + 1
    assert weighted_hist.hist_form(g, bins) == "parted"
    x, w, live, e = rows_inputs(83, g, n, mask, bins=bins)
    got = ops.weighted_histogram_rows(*(torch.from_numpy(a)
                                        for a in (x, w, live, e)))
    want = jwhist(jnp.asarray(x.reshape(-1)),
                  jnp.asarray(np.repeat(np.arange(g, dtype=np.int32), n)),
                  jnp.asarray(np.repeat(w, n)), jnp.asarray(live.reshape(-1)),
                  jnp.asarray(e), g, interpret=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5)
