"""The port's plain ``weighted_hist`` against the reference, on the CPU.

Two references: the jnp oracle ``ref.weighted_hist_ref`` (what the
reference's registry runs) and the Pallas kernel in interpret mode.
Counts bit for bit, mass within rtol 1e-5 (the plain version sums in f64
and rounds once; the reference sums in f32). The cases are the ones the
CUDA kernel is held to on the card (``test_torch_cuda.WHIST_CASES``):
collapsed edges, values on interior edges and on the right-closed last
edge, duplicate edges, all masked, ragged M, the largest G·B.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ref as jref
from repro.kernels.weighted_hist import weighted_hist as pallas_whist
from repro_torch.kernels import ops, ref
from repro_torch.kernels import weighted_hist as whist
from test_torch_cuda import WHIST_CASES, whist_inputs

MASS_RTOL = 1e-5


def _both(arrays, g):
    j = jref.weighted_hist_ref(*(jnp.asarray(a) for a in arrays), g)
    t = ref.weighted_hist(*(torch.from_numpy(a) for a in arrays), g)
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


def _assert_same(j, t):
    (jw, jc), (tw, tc) = j, t
    assert tw.dtype == tc.dtype == np.float32
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tw, jw, rtol=MASS_RTOL, atol=0.0)


@pytest.mark.parametrize("case", sorted(WHIST_CASES))
def test_plain_matches_reference_oracle(case):
    kw = WHIST_CASES[case]
    arrays = whist_inputs(3, 1000, **kw)
    j, t = _both(arrays, kw.get("g", 6))
    _assert_same(j, t)
    if case == "collapsed":
        # Every value equals every edge: all of it lands in the last bin.
        assert t[1][:, :-1].sum() == 0 and t[1][:, -1].sum() > 0
    if case == "all_masked":
        assert t[1].sum() == 0 and t[0].sum() == 0


@pytest.mark.parametrize("case", ["uniform", "log2", "collapsed",
                                  "on_edges", "ragged"])
def test_plain_matches_pallas_interpret(case):
    kw = WHIST_CASES[case]
    x, cell, w, mask, e = whist_inputs(4, 300, **kw)
    g = kw.get("g", 6)
    pw, pc = pallas_whist(jnp.asarray(x), jnp.asarray(cell), jnp.asarray(w),
                          jnp.asarray(mask), jnp.asarray(e), g,
                          interpret=True)
    tw, tc = ref.weighted_hist(*(torch.from_numpy(a)
                                 for a in (x, cell, w, mask, e)), g)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(pc))
    np.testing.assert_allclose(tw.numpy(), np.asarray(pw), rtol=MASS_RTOL)


def test_right_closed_last_bin_and_open_interior():
    """``e_B`` itself counts (last bin right-closed); an interior edge
    belongs to the bin it opens; values outside the edges count nowhere."""
    e = np.array([0.0, 1.0, 2.0, 4.0], np.float32)
    x = np.array([0.0, 1.0, 2.0, 4.0, 4.0, -0.5, 4.5, 3.0], np.float32)
    arrays = (x, np.zeros(8, np.int32), np.ones(8, np.float32),
              np.ones(8, bool), e)
    j, t = _both(arrays, 1)
    _assert_same(j, t)
    np.testing.assert_array_equal(t[1], [[1.0, 1.0, 4.0]])


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), m=st.integers(1, 400),
       nb=st.integers(1, 12), g=st.integers(1, 5),
       dup=st.integers(0, 3))
def test_plain_matches_oracle_property(seed, m, nb, g, dup):
    """Random non-decreasing edges with repeats, values drawn partly from
    the edges themselves."""
    rng = np.random.default_rng(seed)
    e = np.sort(rng.uniform(-10, 10, nb + 1)).astype(np.float32)
    for _ in range(dup):
        i = rng.integers(0, nb)
        e[i + 1] = e[i]
    x = np.where(rng.random(m) < 0.3, rng.choice(e, m),
                 rng.uniform(-12, 12, m)).astype(np.float32)
    arrays = (x, rng.integers(0, g, m).astype(np.int32),
              rng.uniform(0.5, 3.0, m).astype(np.float32),
              rng.random(m) < 0.8, e)
    _assert_same(*_both(arrays, g))


def test_ops_dispatch_cpu_runs_plain_version():
    arrays = [torch.from_numpy(a) for a in whist_inputs(5, 500)]
    ops.reset_launch_counts()
    got = ops.weighted_histogram(*arrays, 6)
    want = ref.weighted_hist(*arrays, 6)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts()["weighted_hist"] == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    arrays = [torch.from_numpy(a) for a in whist_inputs(6, 50)]
    with pytest.raises(ValueError, match="CUDA"):
        whist.weighted_hist(*arrays, 6)
