"""The port's registry and window queries against the reference, on the
CPU: every kind under every window it takes, through ``evaluate_view``,
``evaluate`` and the window helpers, on a ring state converted from the
reference. Bitwise: ``session_intervals`` and the heavy-hitter keys.
Within rtol: values 1e-5, linear variances 1e-4, bootstrap variances
1e-3. The rings run at capacity 16, so every HT weight C/16 is dyadic and
every cumulative weight is exact in both packages: the quantile answers
agree exactly (``test_torch_quantile`` states the tolerance where they
need not).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import window as jwin
from repro.runtime import executor as jex
from repro.runtime import registry as jreg
from repro_torch import prng
from repro_torch.core import window as twin
from repro_torch.runtime import convert
from repro_torch.runtime import registry as treg
from test_torch_cuda import NONLINEAR_QUERIES, nonlinear_chunks, \
    nonlinear_registry
from test_torch_runtime import CONFIGS, _jchunk, jax_state_dict

BOOTSTRAP = {name for name, kind, _ in NONLINEAR_QUERIES
             if kind in ("quantile", "distinct")}


def assert_results_close(jres, tres, bootstrap=BOOTSTRAP):
    """Answers of the two packages, query by query."""
    a, b = convert.results_to_numpy(jres), convert.results_to_numpy(tres)
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].keys() == b[name].keys(), name
        if "keys" in a[name]:
            np.testing.assert_array_equal(b[name]["keys"], a[name]["keys"])
        for f in ("value", "variance", "sample_weight"):
            if f not in a[name]:
                continue
            x, y = a[name][f], b[name][f]
            assert x.shape == y.shape, (name, f)
            rtol = 1e-5 if f != "variance" else (
                1e-3 if name in bootstrap else 1e-4)
            np.testing.assert_allclose(y, x, rtol=rtol, atol=1e-6,
                                       err_msg=f"{name}.{f}")


def _ring(chunks=10, seed=7):
    """The reference's ring after ``chunks`` disordered chunks, and the
    port's converted from it."""
    je = jex.PipelinedExecutor(jex.RuntimeConfig(**CONFIGS["k3"]),
                               jreg.QueryRegistry().register("s", "sum"),
                               jax.random.PRNGKey(seed))
    for c in nonlinear_chunks(seed, chunks):
        je.push(_jchunk(c))
    return je.state, convert.state_from_numpy(jax_state_dict(je.state),
                                              "cpu")


@pytest.fixture(scope="module")
def ring():
    return _ring()


@pytest.mark.parametrize("gap", [1, 2, 3])
def test_session_intervals_on_the_ring(ring, gap):
    js, ts = ring
    a = jwin.session_intervals(jwin.activity_mask(js.window),
                               js.slot_interval, gap)
    b = twin.session_intervals(twin.activity_mask(ts.window),
                               ts.slot_interval, gap)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), k=st.integers(1, 6),
       s=st.integers(1, 4), gap=st.integers(1, 3))
def test_session_intervals_bitwise_property(seed, k, s, gap):
    rng = np.random.default_rng(seed)
    act = rng.random((k, s)) < 0.6
    slot_iv = rng.permutation(rng.choice(12, k, replace=False)).astype(
        np.int32) - 2
    a = jwin.session_intervals(jnp.asarray(act), jnp.asarray(slot_iv), gap)
    b = twin.session_intervals(torch.from_numpy(act),
                               torch.from_numpy(slot_iv), gap)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_window_queries_match(ring):
    js, ts = ring
    jw, tw = js.window, ts.window
    edges = (0.0, 20.0, 100.0, 1000.0, 5000.0)
    pairs = {
        "per_key_sum": (jwin.query_per_key_sum(jw),
                        twin.query_per_key_sum(tw)),
        "session_sum": (jwin.query_session_sum(jw, 1, js.slot_interval),
                        twin.query_session_sum(tw, 1, ts.slot_interval)),
        "session_sum_ranks": (jwin.query_session_sum(jw, 2),
                              twin.query_session_sum(tw, 2)),
        "histogram": (jwin.query_histogram(jw, jnp.asarray(edges)),
                      twin.query_histogram(tw, torch.tensor(edges))),
        "quantile": (jwin.query_quantile(jw, (0.1, 0.5, 0.95),
                                         num_replicates=6),
                     twin.query_quantile(tw, (0.1, 0.5, 0.95),
                                         num_replicates=6)),
        "heavy_hitters": (jwin.query_heavy_hitters(jw, 5),
                          twin.query_heavy_hitters(tw, 5)),
        "distinct": (jwin.query_distinct(jw, num_replicates=6),
                     twin.query_distinct(tw, num_replicates=6)),
    }
    assert_results_close({k: v[0] for k, v in pairs.items()},
                         {k: v[1] for k, v in pairs.items()},
                         bootstrap={"quantile", "distinct"})


def test_evaluate_every_kind_and_window(ring):
    js, ts = ring
    jr, tr = nonlinear_registry(jreg), nonlinear_registry()
    a = jr.evaluate(js.window, jax.random.PRNGKey(3), interval_span=1.0)
    b = tr.evaluate(ts.window, prng.PRNGKey(3), interval_span=1.0)
    assert_results_close(a, b)
    assert b["per_key"].value.shape == (3,)
    assert b["q_key"].value.shape == (3, 1)


def test_evaluate_view_with_the_runtime_context(ring):
    """The executors' path: the merged view, its stats, the emission key
    and the context with the slots' real event intervals."""
    js, ts = ring
    jr, tr = nonlinear_registry(jreg), nonlinear_registry()
    jcfg = jex.RuntimeConfig(**CONFIGS["k3"])
    from repro_torch.runtime import executor as tex
    tcfg = tex.RuntimeConfig(**CONFIGS["k3"])
    a, _ = jex._evaluate(jcfg, jr, js)
    b, _ = tex._evaluate(tcfg, tr, ts)
    assert_results_close(a, b)
    np.testing.assert_array_equal(
        tex._emission_key(ts).numpy(),
        np.asarray(jex._emission_key(jcfg, js)).astype(np.int64))


def test_grouped_window_needs_a_context(ring):
    _, ts = ring
    view = twin.sample_view(ts.window)
    reg = treg.QueryRegistry().register("pk", "sum", window="per_key")
    with pytest.raises(ValueError, match="EmissionContext"):
        reg.evaluate_view(view, None, prng.PRNGKey(0))


def test_result_summary_and_describe(ring):
    js, ts = ring
    jr, tr = nonlinear_registry(jreg), nonlinear_registry()
    a = jreg.result_summary(jr.evaluate(js.window, jax.random.PRNGKey(1)))
    b = treg.result_summary(tr.evaluate(ts.window, prng.PRNGKey(1)))
    assert a.keys() == b.keys()
    for name in a:
        assert a[name]["kind"] == b[name]["kind"]
        for f in ("value", "counts", "keys", "hw95"):
            if f in a[name]:
                np.testing.assert_allclose(b[name][f], a[name][f],
                                           rtol=1e-3, atol=1e-6)
    assert treg.describe(tr) == jreg.describe(jr)


def test_results_convert_both_ways(ring):
    _, ts = ring
    res = nonlinear_registry().evaluate(ts.window, prng.PRNGKey(2))
    back = convert.results_from_numpy(convert.results_to_numpy(res), "cpu")
    assert_results_close(res, back, bootstrap=set())
    assert type(back["top"]).__name__ == "HeavyHitters"


def test_nonlinear_evaluation_reads_nothing_back(ring, monkeypatch):
    """Every kind and window answered without reading a tensor value back
    to the host: brackets, targets and bootstrap replicates stay on the
    device (the emission's one synchronization is the executor's)."""
    _, ts = ring
    reg = nonlinear_registry()
    reg.evaluate(ts.window, prng.PRNGKey(4))      # constants made once

    def refuse(*_):
        raise AssertionError("evaluation read a tensor value back")
    for name in ("item", "tolist", "__bool__", "__int__", "__float__",
                 "__index__", "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out = reg.evaluate(ts.window, prng.PRNGKey(4))
    monkeypatch.undo()
    assert set(out) == {name for name, _, _ in NONLINEAR_QUERIES}
