"""The port's watermark routing is bitwise the reference's compiled
``route_chunk`` on disordered event times."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import watermark as jwm
from repro_torch.runtime import watermark as wm

SPANS = [1.0, 5.0, 0.3, 0.7, 3.0]


@functools.lru_cache(maxsize=None)
def _jax_route(span, lateness, k):
    # The executor runs routing inside its compiled step, with the span a
    # compile-time constant; the port matches that program.
    return jax.jit(lambda w, o, t, m: jwm.route_chunk(w, o, t, m, span,
                                                      lateness, k))


def _disordered(seed, n_chunks, m, span):
    rng = np.random.default_rng(seed)
    for e in range(n_chunks):
        # A chunk covers a quarter interval, so the frontier sits close
        # enough to an interval start for late-but-accepted items.
        t = (e * m + np.arange(m)) * (span / (4 * m))
        late = rng.random(m) < 0.3
        t = t - late * rng.random(m) * 3.0 * span
        yield (np.maximum(t, 0.0).astype(np.float32), rng.random(m) < 0.95)


@pytest.mark.parametrize("span", SPANS)
def test_interval_of_matches_compiled_reference(span):
    rng = np.random.default_rng(0)
    t = (rng.random(20000) * 200 * span).astype(np.float32)
    ref = jax.jit(lambda x: jwm.interval_of(x, span))(jnp.asarray(t))
    np.testing.assert_array_equal(np.asarray(ref),
                                  wm.interval_of(torch.from_numpy(t),
                                                 span).numpy())


@pytest.mark.parametrize("span,lateness,k", [
    (1.0, 0.5, 3), (5.0, 2.0, 2), (0.3, 0.1, 4), (0.7, 1.2, 3)])
def test_route_chunk_bitwise(span, lateness, k):
    route = _jax_route(span, lateness, k)
    jw, jo = jwm.init(), jnp.zeros((), jnp.int32)
    tw, to = wm.init("cpu"), torch.zeros((), dtype=torch.int32)
    totals = np.zeros(3, np.int64)
    for times, mask in _disordered(1, 16, 200, span):
        jr = route(jw, jo, jnp.asarray(times), jnp.asarray(mask))
        tr = wm.route_chunk(tw, to, torch.from_numpy(times),
                            torch.from_numpy(mask), span, lateness, k)
        np.testing.assert_array_equal(np.asarray(jr.target_interval),
                                      tr.target_interval.numpy())
        np.testing.assert_array_equal(np.asarray(jr.accept),
                                      tr.accept.numpy())
        assert int(jr.open_interval) == int(tr.open_interval)
        for f in ("max_time", "on_time", "late", "dropped"):
            a, b = np.asarray(getattr(jr.wm, f)), getattr(tr.wm, f).numpy()
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
        assert float(jwm.watermark(jr.wm, lateness)) == \
            float(wm.watermark(tr.wm, lateness))
        jw, jo, tw, to = jr.wm, jr.open_interval, tr.wm, tr.open_interval
        totals = np.array([int(tw.on_time), int(tw.late), int(tw.dropped)])
    assert (totals > 0).all(), totals     # every verdict was exercised


def test_init_fresh_buffers():
    a, b = wm.init("cpu"), wm.init("cpu")
    assert a.max_time.data_ptr() != b.max_time.data_ptr()
    assert float(a.max_time) == float(jwm.NEG_TIME)
    assert a.on_time.dtype == torch.int32


@pytest.mark.parametrize("span,lateness", [(1.0, 0.5), (5.0, 2.0),
                                           (3.0, 0.5), (0.3, 0.1)])
def test_host_mirror_matches_reference(span, lateness):
    """The host frontier mirror, its closes, open interval and staleness
    are the reference's numpy arithmetic, true division included."""
    tf = jf = np.full((1,), wm.NEG_TIME, np.float32)
    assert wm.NEG_TIME == jwm.NEG_TIME
    for times, mask in _disordered(4, 12, 100, span):
        tf = wm.host_frontier(tf, times, mask)
        jf = jwm.host_frontier(jf, times, mask)
        assert tf.dtype == jf.dtype and tf.tobytes() == jf.tobytes()
        closed = wm.host_closed_through(tf, lateness, span)
        assert closed == jwm.host_closed_through(jf, lateness, span)
        assert wm.host_open_interval(tf, span) == \
            jwm.host_open_interval(jf, span)
        w = float(tf[0]) - lateness
        assert wm.staleness(w, closed, span) == \
            jwm.staleness(w, closed, span)


def test_next_batch_chunks_matches_reference():
    from repro.runtime import controller as jctl
    from repro_torch.runtime import controller as ctl
    for b in (1, 2, 4, 32):
        for p in (0.1, 0.5, 0.9, 1.0, 1.5):
            for closes in (0, 1, 2, 5):
                assert ctl.next_batch_chunks(b, p, 32, closes) == \
                    jctl.next_batch_chunks(b, p, 32, closes)
