"""The row entries of the stats and histogram kernels on the CPU.

``ops.stratified_stats_rows`` and ``ops.weighted_histogram_rows`` take
the emission's ``[G, N]`` slot view (each row a cell, one weight a row).
On the CPU they run the flat plain versions with row ids and each row's
weight on its slots, so they give the bits of the flat calls the
emission made before, at every ``G``; on the card the wrappers pick the
one-launch form, the row form or the parted form by shape alone
(``stats_form``, ``hist_form``), and ``test_torch_cuda.py`` holds each
against these plain versions. Here: the bits of the flat calls, the
reference's row sums and its histogram kernel in interpret mode, and the
choice of form.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import error as jerr
from repro.kernels.weighted_hist import weighted_hist as jwhist
from repro_torch.core import error as terr
from repro_torch.kernels import ops, ref, stratified_stats, weighted_hist
from test_torch_cuda import rows_inputs

CSRC = Path(stratified_stats.__file__).parent / "csrc"


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("g,n", [(4, 64), (512, 5), (513, 3), (2_000, 17),
                                 (600, 64)])
def test_stats_rows_are_the_flat_call(g, n):
    """Below and past MAX_STRATA: the bits of the flat call with row ids
    (the emission's call before the row entry)."""
    x, _, live, _ = _t(*rows_inputs(71, g, n))
    got = ops.stratified_stats_rows(x, live)
    want = ops.stratified_stats(x.reshape(-1), ref.row_ids(g, n, "cpu"),
                                live.reshape(-1), g)
    for a, b in zip(got, want):
        assert a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("g,bins,n", [(6, 32, 100), (100, 32, 9),
                                      (101, 32, 9), (97, 33, 40),
                                      (2, 4_097, 30)])
def test_histogram_rows_are_the_flat_call(g, bins, n):
    """At and past MAX_CELLS_BINS and past MAX_ROW_BINS: the bits of the
    flat call with row ids and each row's weight on its slots."""
    x, w, live, e = _t(*rows_inputs(72, g, n, bins=bins))
    got = ops.weighted_histogram_rows(x, w, live, e)
    want = ops.weighted_histogram(x.reshape(-1), ref.row_ids(g, n, "cpu"),
                                  w[:, None].expand(g, n).reshape(-1),
                                  live.reshape(-1), e, g)
    for a, b in zip(got, want):
        assert a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("g,n,mask", [(4, 1_000, "prefix"),
                                      (600, 64, "prefix"),
                                      (513, 33, "random"),
                                      (520, 8, "none")])
def test_stats_rows_match_reference_row_sums(g, n, mask):
    """The reference's ``stratum_stats_from_sample`` (``jnp.sum`` of each
    row) bit for bit, through the port's caller of the row entry."""
    x, _, live, _ = rows_inputs(73, g, n, mask)
    counts = np.full(g, 2 * n, np.int32)
    taken = live.sum(1).astype(np.int32)
    want = jerr.stratum_stats_from_sample(jnp.asarray(x), jnp.asarray(counts),
                                          jnp.asarray(taken),
                                          jnp.asarray(live))
    got = terr.stratum_stats_from_sample(*_t(x, counts, taken, live))
    for f in ("sums", "sumsqs"):
        assert (getattr(got, f).numpy().tobytes()
                == np.asarray(getattr(want, f)).tobytes()), f


@pytest.mark.parametrize("g,bins,n,mask", [(101, 32, 40, "prefix"),
                                           (150, 33, 25, "random")])
def test_histogram_rows_match_reference_kernel(g, bins, n, mask):
    """Past G·B = 3,200, against the reference's kernel in interpret mode
    on the flat view: counts bit for bit, mass within 1e-5."""
    x, w, live, e = rows_inputs(74, g, n, mask, bins=bins)
    got = ops.weighted_histogram_rows(*_t(x, w, live, e))
    want = jwhist(jnp.asarray(x.reshape(-1)),
                  jnp.asarray(np.repeat(np.arange(g, dtype=np.int32), n)),
                  jnp.asarray(np.repeat(w, n)), jnp.asarray(live.reshape(-1)),
                  jnp.asarray(e), g, interpret=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5)
    assert g * bins > weighted_hist.MAX_CELLS_BINS


@pytest.mark.parametrize("g,form", [(1, "small"), (512, "small"),
                                    (513, "row"), (15_360, "row"),
                                    (262_144, "row")])
def test_stats_form_by_shape(g, form):
    """The stats' form is a function of G alone: the one-launch form up
    to MAX_STRATA rows, the row form past it (no cap)."""
    assert stratified_stats.MAX_STRATA == 512
    assert stratified_stats.stats_form(g) == form


@pytest.mark.parametrize("g,bins,form", [
    (6, 32, "small"), (100, 32, "small"), (101, 32, "row"),
    (1, 3_200, "small"), (1, 3_201, "row"), (15_360, 32, "row"),
    (1, 4_096, "row"), (1, 4_097, "parted"), (9, 5_000, "parted")])
def test_histogram_form_by_shape(g, bins, form):
    """The histogram's form is a function of (G, B) alone: the one-launch
    form up to MAX_CELLS_BINS keys, the row form up to MAX_ROW_BINS bins,
    the parted form past them; the limit is the CUDA source's."""
    assert weighted_hist.hist_form(g, bins) == form
    src = (CSRC / "row_reduce.cuh").read_text()
    limit = re.search(r"kMaxRowBins = (\d+);", src)
    assert int(limit.group(1)) == weighted_hist.MAX_ROW_BINS


def test_row_entries_make_views_contiguous():
    """A strided ``[G, N]`` view (a column slice) gives the bits of its
    contiguous copy."""
    x, w, live, e = _t(*rows_inputs(75, 600, 40))
    xs, ls = x[:, ::2], live[:, ::2]
    for got, want in ((ops.stratified_stats_rows(xs, ls),
                       ops.stratified_stats_rows(xs.contiguous(),
                                                 ls.contiguous())),
                      (ops.weighted_histogram_rows(xs, w, ls, e),
                       ops.weighted_histogram_rows(xs.contiguous(), w,
                                                   ls.contiguous(), e))):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
