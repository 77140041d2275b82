"""The port's ``Server`` and ``launch.serve`` against the reference's, on
the CPU.

Both packages run ``Server.generate`` on the phi4 smoke config (f32, the
reference's weights carried over) with ``time.perf_counter`` replaced by
the same fixed-step clock, so the latencies folded are the same numbers:
the tokens are equal (the reference's top-2 logit gap is asserted above
1e-3 at every step, so a last-ulp difference cannot flip a token), the
telemetry state is bit for bit the reference's, the telemetry queries
and the Prometheus text agree within rtol 1e-5, and so does the next
window. ``python -m repro_torch.launch.serve --device cpu`` prints the
reference's line.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.launch import serve as jlaunch
from repro.models import api as japi
from repro.models import param as jparam
from repro.serve import serve_step as jserve
from repro_torch import configs as tcfgs
from repro_torch.launch import serve as tlaunch
from repro_torch.models import param as tparam
from repro_torch.serve import serve_step as tserve

ARCH = "phi4-mini-3.8b"
RTOL = 1e-5
GAP = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the suite runs several worker
    processes on the same cores, and torch's thread pool contending with
    them makes these many small operations tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FixedStepClock:
    """``perf_counter`` of a ``time`` module stand-in: call ``n`` returns
    the sum of the first ``n`` steps, each a multiple of 2**-12 s that
    varies with ``n``, so every latency is exact and they differ."""

    def __init__(self):
        self.t, self.n = 0.0, 0

    def perf_counter(self) -> float:
        self.n += 1
        self.t += (1 + self.n % 7) * 2.0 ** -12
        return self.t


@pytest.fixture
def clocks(monkeypatch):
    """The same clock sequence in each package's serving module."""
    monkeypatch.setattr(jserve, "time", FixedStepClock())
    monkeypatch.setattr(tserve, "time", FixedStepClock())


def _servers(num_tenants, capacity, seed=3):
    jcfg = jcfgs.get_config(ARCH, smoke=True).replace(dtype=jnp.float32)
    tcfg = tcfgs.get_config(ARCH, smoke=True).replace(dtype=torch.float32)
    jp = jparam.init_params(japi.skeleton(jcfg), jax.random.PRNGKey(0))
    tp = tparam.params_from_reference(jax.device_get(jp), device="cpu")
    return (jserve.Server(jcfg, jp, num_tenants=num_tenants,
                          telemetry_capacity=capacity, seed=seed),
            tserve.Server(tcfg, tp, num_tenants=num_tenants,
                          telemetry_capacity=capacity, seed=seed,
                          device="cpu"))


def _watch_gaps(server):
    """Record the reference's top-2 logit gap at every prefill and
    decode step."""
    gaps = []

    def watched(fn):
        def call(*a, **kw):
            logits, state = fn(*a, **kw)
            top = np.sort(np.asarray(logits)[:, -1], axis=-1)[:, -2:]
            gaps.append(float(np.min(top[:, 1] - top[:, 0])))
            return logits, state
        return call
    server.prefill = watched(server.prefill)
    server.decode = watched(server.decode)
    return gaps


def _same_telemetry(js, ts):
    """The OASRS state bit for bit (the port's key holds the reference's
    two u32 words in int64)."""
    for f in ("values", "counts", "capacity"):
        a = np.asarray(getattr(js.telemetry, f))
        b = getattr(ts.telemetry, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(
            a.view(np.uint8), b.view(np.uint8)), f
    np.testing.assert_array_equal(ts.telemetry.key.numpy(),
                                  np.asarray(js.telemetry.key, np.int64))


def _same_estimates(js, ts):
    for name in ("telemetry_mean", "telemetry_per_tenant"):
        je, te = getattr(js, name)(), getattr(ts, name)()
        for f in ("value", "variance"):
            np.testing.assert_allclose(getattr(te, f).numpy(),
                                       np.asarray(getattr(je, f)),
                                       rtol=RTOL, err_msg=f"{name}.{f}")


def _same_text(jtext, ttext):
    jl, tl = jtext.splitlines(), ttext.splitlines()
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        if a.startswith("#"):
            assert a == b
            continue
        (an, av), (bn, bv) = a.rsplit(" ", 1), b.rsplit(" ", 1)
        assert an == bn
        np.testing.assert_allclose(float(bv), float(av), rtol=RTOL,
                                   err_msg=a)


@pytest.mark.parametrize("capacity", [256, 4], ids=["room", "replacing"])
def test_generate_tokens_and_telemetry_match_reference(clocks, capacity):
    """Capacity 256 holds every record (each tenant's reservoir is its
    records); capacity 4 replaces, so the fold's uniforms matter."""
    js, ts = _servers(num_tenants=4, capacity=capacity)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 512, (6, 24)).astype(np.int32)
    tenants = rng.integers(0, 4, 6).astype(np.int32)
    gaps = _watch_gaps(js)
    jout = js.generate({"tokens": jnp.asarray(toks)}, steps=7,
                       tenant_ids=jnp.asarray(tenants))
    tout = ts.generate({"tokens": torch.from_numpy(toks)}, steps=7,
                       tenant_ids=torch.from_numpy(tenants))
    assert len(gaps) == 8 and min(gaps) > GAP, gaps
    assert tout.dtype == torch.int32 and tuple(tout.shape) == (6, 8)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    _same_telemetry(js, ts)
    assert int(ts.telemetry.counts.sum()) == 6 * 7
    _same_estimates(js, ts)
    _same_text(js.metrics_text(), ts.metrics_text())

    js.new_window()
    ts.new_window()
    _same_telemetry(js, ts)
    js.generate({"tokens": jnp.asarray(toks[:, :9])}, steps=2,
                tenant_ids=jnp.asarray(tenants))
    ts.generate({"tokens": torch.from_numpy(toks[:, :9])}, steps=2,
                tenant_ids=torch.from_numpy(tenants))
    _same_telemetry(js, ts)
    _same_estimates(js, ts)
    _same_text(js.metrics_text(), ts.metrics_text())


def test_decode_rewrites_the_last_prompt_slot_as_the_reference(clocks):
    """``max_len=0``: the cache holds the prompt and each decode step
    rewrites its last slot (XLA clamps the write), leaving the others."""
    js, ts = _servers(num_tenants=2, capacity=8)
    toks = np.random.default_rng(5).integers(0, 512, (2, 8)).astype(
        np.int32)
    _, jst = js.prefill({"tokens": jnp.asarray(toks)})
    _, tst = ts.prefill({"tokens": torch.from_numpy(toks)})
    before = tst.k.clone()
    nxt = np.zeros((2, 1), np.int32)
    _, jst = js.decode(jst, jnp.asarray(nxt))
    _, tst = ts.decode(tst, torch.from_numpy(nxt))
    changed = (tst.k != before).flatten(0, 1).any(-1).any(-1).any(0)
    assert changed.tolist() == [False] * 7 + [True]
    assert int(tst.position) == int(jst.position) == 9
    np.testing.assert_allclose(tst.k.numpy(), np.asarray(jst.k), rtol=1e-4,
                               atol=1e-5)


def test_launch_serve_prints_the_reference_line(clocks, capsys):
    argv = ["--requests", "3", "--prompt-len", "8", "--steps", "3",
            "--tenants", "2"]
    jlaunch.main(argv)
    want = capsys.readouterr().out
    assert tlaunch.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert re.fullmatch(r"\[serve\] generated \(3, 4\) tokens; mean decode "
                        r"latency \d+\.\d\d ± \d+\.\d\d ms \(95% CI, "
                        r"sampled\)\n", got), got
    assert got == want
