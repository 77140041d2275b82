"""The port past the key counts its kernels' shared memory holds, against
the reference on the CPU.

The reference's TPU kernels keep their per-key state as whole VMEM
blocks and refuse no key count; the port's CUDA kernels switch to a
large-key form past the fold's and the one-shot's 1,024 cells, the stats'
512 rows and the histogram's 3,200 keys (``G·B``). On the CPU the port
runs the plain versions, so these tests hold what the card's large-key
forms are held to on the card (``test_torch_cuda.py``): the plain
versions, against the reference, at those sizes.

Bitwise: every emission's integer fields and watermark, and every final
state leaf (sampling state). Within ``test_torch_registry``'s rtol: the
answers (values 1e-5, linear variances 1e-4, bootstrap variances 1e-3).
Each ring's per-shard capacity is a power of two, so the HT weights are
dyadic and the quantiles agree exactly. Chunks stay small (a few
thousand items, ``N_max <= 16``) so the file stays fast.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import reservoir as jres
from repro.kernels.stratified_stats import stratified_stats as jstats
from repro.kernels.weighted_hist import weighted_hist as jwhist
from repro.runtime import executor as jex
from repro.runtime import registry as jreg
from repro_torch import prng
from repro_torch.kernels import ops
from repro_torch.kernels import one_shot, reservoir, stratified_stats
from repro_torch.kernels import weighted_hist
from repro_torch.runtime import executor as tex
from repro_torch.runtime import registry as treg
from test_torch_cuda import (ONE_SHOT_FIELDS, fold_inputs, one_shot_inputs,
                             to_tree, whist_inputs)
from test_torch_one_shot import _assert_bitwise, _np, _pallas
from test_torch_registry import assert_results_close
from test_torch_runtime import _assert_state_bitwise, _jchunk, _tchunk
from test_torch_sharded import sharded_chunks


def _above_500(x):
    return x > 500.0


def registry(module, kinds):
    """The queries of ``kinds`` in ``module``'s registry: ``"linear"``
    (sum, mean, count), ``"quantile"`` (the histogram-refinement method,
    whose every round is one histogram over ``W·K·S`` rows x 32 bins) and
    ``"histogram"`` (7 edges)."""
    reg = module.QueryRegistry()
    if "linear" in kinds:
        reg.register("total", "sum").register("avg", "mean").register(
            "big", "count", predicate=_above_500)
    if "quantile" in kinds:
        reg.register("q_hist", "quantile", qs=(0.25, 0.9), method="hist",
                     num_replicates=4)
    if "histogram" in kinds:
        reg.register("hist", "histogram", edges=(0.0, 10.0, 50.0, 100.0,
                                                 500.0, 1000.0, 2000.0))
    return reg


def run_both(kw, kinds, chunks, seed=7):
    """Pipelined executors of both packages over ``chunks``: the same
    emissions, answers within rtol, the final states bit for bit."""
    je = jex.PipelinedExecutor(jex.RuntimeConfig(**kw),
                               registry(jreg, kinds),
                               jax.random.PRNGKey(seed))
    te = tex.PipelinedExecutor(tex.RuntimeConfig(**kw),
                               registry(treg, kinds), prng.PRNGKey(seed),
                               device="cpu")
    jems = je.run(_jchunk(c) for c in chunks)
    tems = te.run(_tchunk(c) for c in chunks)
    assert len(jems) == len(tems) > 0
    for a, b in zip(jems, tems):
        for f in ("index", "interval", "watermark", "open_interval",
                  "on_time", "late", "dropped", "items"):
            assert getattr(a, f) == getattr(b, f), (a.index, f)
        np.testing.assert_array_equal(a.capacity, b.capacity)
        assert_results_close(a.results, b.results, bootstrap={"q_hist"})
    _assert_state_bitwise(je.state, te.state)
    return te


def stream(seed, n, m, num_strata, w=None):
    """``n`` chunks of ``m`` items (``[W, M]`` when ``w``) over
    ``num_strata`` strata, each a quarter interval, disordered."""
    chunks = sharded_chunks(seed, n, w or 1, m=m, num_strata=num_strata)
    return chunks if w else [tuple(a[0] for a in c) for c in chunks]


#: One window of 8 intervals over 16 strata: the quantile's histograms
#: take G·B = 128 x 32 = 4,096 keys, past the histogram kernel's 3,200,
#: while every other count is inside its kernel's limits. Init always
#: took this configuration; on the card the first nonlinear emission used
#: to raise there.
HIST_FAULT = dict(num_strata=16, capacity=16, num_intervals=8,
                  interval_span=1.0, allowed_lateness=0.5, emit_every=4)


def test_hist_quantile_past_the_histogram_cap_matches_reference():
    assert 8 * 16 * 32 > weighted_hist.MAX_CELLS_BINS
    te = run_both(HIST_FAULT, ("linear", "quantile"), stream(11, 12, 512, 16))
    assert te.state.window.intervals.values.shape == (8, 16, 16)


#: ``(config, query kinds, chunks, items per chunk)`` past each former cap
#: on one shard: 3 x 342 = 1,026 cells (the fused fold's and the
#: one-shot's past 1,024; 1,026 stats rows past 512; 1,026 x 32 histogram
#: keys past 3,200); the masked ingest folds each slot's 1,025 strata.
PAST_CAPS = {
    "fused": (dict(num_strata=342, num_intervals=3, ingest="fused"),
              ("linear", "quantile", "histogram"), 8, 2048),
    "onekernel": (dict(num_strata=342, num_intervals=3,
                       ingest="onekernel"),
                  ("linear", "quantile", "histogram"), 8, 2048),
    "masked": (dict(num_strata=1025, num_intervals=2, ingest="masked"),
               ("linear",), 8, 4096),
}


@pytest.mark.parametrize("ingest", sorted(PAST_CAPS))
def test_ingest_past_the_kernel_caps_matches_reference(ingest):
    kw, kinds, n, m = PAST_CAPS[ingest]
    cfg = dict(kw, capacity=16, interval_span=1.0, allowed_lateness=0.5,
               emit_every=4)
    te = run_both(cfg, kinds, stream(12, n, m, kw["num_strata"]))
    assert te.state.window.intervals.values.shape[:2] == (
        kw["num_intervals"], kw["num_strata"])


def test_init_accepts_the_sliding_deployment_on_every_ingest():
    """A one-minute window sliding every second over 64 sub-streams on 4
    shards (K = 60, S = 64, W = 4: 15,360 cells and stats rows) is taken
    at init on every ingest, as the reference takes it; so are 100
    sub-streams on 4 shards."""
    for ingest in ("fused", "masked", "onekernel"):
        for k, s in ((60, 64), (3, 100)):
            cfg = tex.RuntimeConfig(num_strata=s, num_intervals=k,
                                    capacity=16, num_shards=4,
                                    ingest=ingest)
            state = tex.init_state(cfg, prng.PRNGKey(0), "cpu")
            assert state.window.intervals.values.shape == (4, k, s, 4)


@pytest.mark.parametrize("s", [1_025, 4_096])
def test_fold_past_its_cap_matches_reference(s):
    """``ops.reservoir_fold`` over ``S`` strata past 1,024 against the
    reference's kernel in interpret mode: ring and counts bit for bit."""
    rng = np.random.default_rng(s)
    counts = rng.integers(0, 30, s).astype(np.int32)
    capacity = rng.integers(1, 17, s).astype(np.int32)
    inp = fold_inputs(13, 3000, counts, capacity, s=s, n_max=16)
    t = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    ring = t.pop("values")
    new = ops.reservoir_fold(values=ring, **t)
    jring, jnew = jres.reservoir_fold(
        *(jnp.asarray(inp[k]) for k in ("stratum_ids", "payload",
                                        "u_accept", "u_slot", "mask",
                                        "counts", "capacity", "values")),
        interpret=True)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))
    assert ring.numpy().tobytes() == np.asarray(jring).tobytes()
    assert s > reservoir.MAX_STRATA


@pytest.mark.parametrize("leaves", [1, 10])
def test_one_shot_past_its_caps_matches_pallas(leaves):
    """The plain one-shot at K·S = 5 x 205 = 1,025 cells, with one payload
    leaf and with ten (past the 8 of one write launch), bit for bit the
    reference's kernel in interpret mode on every field and leaf."""
    items, state = one_shot_inputs(14, k=5, s=205, n_max=8, m=600,
                                   counts_hi=20, cap=None)
    if leaves > 1:
        rng = np.random.default_rng(15)
        items = dict(items, payload={
            f"l{i}": (1000 * rng.normal(size=600)).astype(
                np.float32 if i % 2 else np.int32) for i in range(leaves)})
        state = dict(state, values={
            f"l{i}": (1000 * rng.normal(size=(5, 205, 8))).astype(
                np.float32 if i % 2 else np.int32) for i in range(leaves)})
    t = to_tree("cpu", state)
    out = ops.one_shot_ingest(**to_tree("cpu", items), span=1.0,
                              allowed_lateness=0.5, **t)
    port = {f: _np(getattr(out, f)) for f in ONE_SHOT_FIELDS}
    _assert_bitwise(port, _pallas(items, state, 1.0, 0.5, block_m=256))
    assert 5 * 205 > one_shot.MAX_CELLS
    assert leaves == 1 or leaves > one_shot.MAX_LEAVES


@pytest.mark.parametrize("s,rows", [(513, False), (2_000, True)])
def test_stats_past_its_cap_matches_reference(s, rows):
    """``ops.stratified_stats`` over S strata past 512, random and in
    rows (the emission's layout): counts bit for bit, sums within 1e-5
    of the reference's kernel in interpret mode."""
    rng = np.random.default_rng(s)
    m = 8 * s if rows else 5000
    sid = (np.repeat(np.arange(s), m // s) if rows
           else rng.integers(0, s, m)).astype(np.int32)
    x = rng.normal(100.0, 10.0, sid.shape[0]).astype(np.float32)
    mask = rng.random(sid.shape[0]) < 0.8
    got = ops.stratified_stats(*(torch.from_numpy(a) for a in (x, sid, mask)),
                               s)
    want = jstats(jnp.asarray(x), jnp.asarray(sid), jnp.asarray(mask), s,
                  interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    assert s > stratified_stats.MAX_STRATA


@pytest.mark.parametrize("g,bins", [(101, 32), (101, 100)])
def test_histogram_past_its_cap_matches_reference(g, bins):
    """``ops.weighted_histogram`` at G·B past 3,200 against the
    reference's kernel in interpret mode: counts bit for bit, mass within
    1e-5."""
    x, cell, w, mask, e = whist_inputs(16, 4000, g=g, bins=bins)
    got = ops.weighted_histogram(*(torch.from_numpy(a)
                                   for a in (x, cell, w, mask, e)), g)
    want = jwhist(*(jnp.asarray(a) for a in (x, cell, w, mask, e)), g,
                  interpret=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5)
    assert g * bins > weighted_hist.MAX_CELLS_BINS
