"""The port's kernel plain versions against the reference's Pallas kernels
(interpret mode) and oracles. The CUDA kernels are held against the same
plain versions on the card in ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ref as jref
from repro.kernels.reservoir import reservoir_fold as pallas_fold
from repro.kernels.stratified_stats import stratified_stats as pallas_stats
from repro_torch.kernels import ops, ref, reservoir, stratified_stats
from test_torch_cuda import PHASES, fold_inputs as _fold_inputs
from test_torch_cuda import one_shot_inputs
from test_torch_cuda import stats_inputs as _stats_inputs


def _torch_fold(inp):
    t = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    counts = ref.reservoir_fold(**t)
    return t["values"].numpy(), counts.numpy()


@pytest.mark.parametrize("phase", sorted(PHASES))
@pytest.mark.parametrize("m,mask_p", [(256, 0.9), (300, 0.9), (300, 0.0)])
def test_plain_fold_matches_pallas_and_oracle(phase, m, mask_p):
    """Bitwise against the Pallas kernel (interpret mode) and the literal
    Algorithm-1 oracle; ragged M (300) and all-masked chunks included."""
    inp = _fold_inputs(11, m, *PHASES[phase], mask_p=mask_p)
    values, counts = _torch_fold(inp)
    pv, pc = pallas_fold(*(jnp.asarray(inp[k]) for k in (
        "stratum_ids", "payload", "u_accept", "u_slot", "mask", "counts",
        "capacity", "values")), block_m=128, interpret=True)
    np.testing.assert_array_equal(values.view(np.int32),
                                  np.asarray(pv).view(np.int32))
    np.testing.assert_array_equal(counts, np.asarray(pc))
    ov, oc = jref.reservoir_fold_ref(**inp)
    np.testing.assert_array_equal(values.view(np.int32), ov.view(np.int32))
    np.testing.assert_array_equal(counts, oc)


@settings(deadline=None, max_examples=30)
@given(seed=st.integers(0, 2**16), m=st.integers(1, 400),
       cap=st.integers(0, 64), start=st.integers(0, 200))
def test_plain_fold_matches_oracle_property(seed, m, cap, start):
    rng = np.random.default_rng(seed)
    inp = _fold_inputs(seed, m, rng.integers(0, start + 1, 4),
                       rng.integers(0, cap + 1, 4))
    values, counts = _torch_fold(inp)
    ov, oc = jref.reservoir_fold_ref(**inp)
    np.testing.assert_array_equal(values.view(np.int32), ov.view(np.int32))
    np.testing.assert_array_equal(counts, oc)


def test_plain_fold_int_payload_and_in_place():
    inp = _fold_inputs(5, 200, *PHASES["crossing"])
    inp["payload"] = np.arange(200, dtype=np.int32)
    inp["values"] = np.full((4, 64), -1, np.int32)
    t = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    ring = t["values"]
    counts = ops.reservoir_fold(**t)
    ov, oc = jref.reservoir_fold_ref(**inp)
    np.testing.assert_array_equal(ring.numpy(), ov)     # written in place
    np.testing.assert_array_equal(counts.numpy(), oc)


@pytest.mark.parametrize("m,mask_p", [(1024, 0.8), (1000, 0.8), (999, 1.0),
                                      (500, 0.0)])
def test_plain_stats_matches_pallas(m, mask_p):
    vals, sid, mask = _stats_inputs(3, m, mask_p=mask_p)
    jc, js, jq = pallas_stats(jnp.asarray(vals), jnp.asarray(sid),
                              jnp.asarray(mask), 4, block_m=256,
                              interpret=True)
    tc, ts, tq = ops.stratified_stats(torch.from_numpy(vals),
                                      torch.from_numpy(sid),
                                      torch.from_numpy(mask), 4)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6)
    oc, os_, oq = jref.stratified_stats_ref(jnp.asarray(vals),
                                            jnp.asarray(sid),
                                            jnp.asarray(mask), 4)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(oc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(os_), rtol=1e-6)


def test_kernel_wrappers_refuse_cpu_tensors():
    inp = {k: torch.from_numpy(np.array(v))
           for k, v in _fold_inputs(0, 16, *PHASES["filling"]).items()}
    with pytest.raises(ValueError, match="CUDA"):
        reservoir.reservoir_fold(**inp)
    vals, sid, mask = _stats_inputs(0, 16)
    with pytest.raises(ValueError, match="CUDA"):
        stratified_stats.stratified_stats(torch.from_numpy(vals),
                                          torch.from_numpy(sid),
                                          torch.from_numpy(mask), 4)


def test_cpu_dispatch_counts_no_kernel_launch():
    ops.reset_launch_counts()
    inp = {k: torch.from_numpy(np.array(v))
           for k, v in _fold_inputs(1, 64, *PHASES["filling"]).items()}
    ops.reservoir_fold(**inp)
    vals, sid, mask = _stats_inputs(1, 64)
    ops.stratified_stats(torch.from_numpy(vals), torch.from_numpy(sid),
                         torch.from_numpy(mask), 4)
    items, state = one_shot_inputs(1, m=64)
    ops.one_shot_ingest(
        **{k: torch.from_numpy(np.array(v)) for k, v in items.items()},
        **{k: torch.from_numpy(np.array(v)) for k, v in state.items()},
        span=1.0, allowed_lateness=0.5)
    ops.weighted_histogram(torch.from_numpy(vals), torch.from_numpy(sid),
                           torch.ones(64), torch.from_numpy(mask),
                           torch.linspace(0.0, 1000.0, 9), 4)
    assert ops.launch_counts() == {"reservoir_fold": 0,
                                   "stratified_stats": 0,
                                   "one_shot_ingest": 0,
                                   "weighted_hist": 0}
