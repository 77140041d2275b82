"""Payloads of several leaves: the port against the reference, on the CPU.

The same numpy-seeded items go through the reference (whose
``update_chunk`` takes its jnp fold for a payload tree) and through the
port on the CPU, for four trees: a dict of an f32 and an i32 leaf, a
tuple of an ``f32 [3]`` and a bf16 leaf, a list of 10 scalar leaves, and
one bool leaf. ``init``, the four fold entry points, ``window.init`` /
``slide`` and ``distributed.local_update`` are bitwise on every values
leaf, on counts and on keys. Every ``extract=`` query of ``core/query``,
``core/window``, ``core/quantile`` and ``core/sketches`` is within the
rtol that the existing query tests state (values 1e-5, variances 1e-4,
bootstrap variances 1e-3); integer outputs are bitwise. The refusals
(a payload of another structure, an extract of the wrong shape) raise
what the reference raises.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core import oasrs as joasrs
from repro.core import quantile as jqt
from repro.core import query as jquery
from repro.core import sketches as jsk
from repro.core import window as jwin
from repro_torch import prng
from repro_torch.core import distributed as tdist
from repro_torch.core import oasrs
from repro_torch.core import quantile as tqt
from repro_torch.core import query as tquery
from repro_torch.core import sketches as tsk
from repro_torch.core import window as twin
from repro_torch.utils import tree_flatten, tree_map


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One item's leaf of a test tree: its shape and kind."""
    shape: tuple
    kind: str


KINDS = {"f32": (jnp.float32, torch.float32),
         "i32": (jnp.int32, torch.int32),
         "bf16": (jnp.bfloat16, torch.bfloat16),
         "bool": (jnp.bool_, torch.bool)}
TREES = {
    "dict": {"val": Leaf((), "f32"), "key": Leaf((), "i32")},
    "tuple": (Leaf((3,), "f32"), Leaf((), "bf16")),
    "list10": [Leaf((), "f32") for _ in range(10)],
    "bool": Leaf((), "bool"),
}
S, CAP, N_MAX = 3, [4, 9, 16], 16


def _specs(name):
    tree = TREES[name]
    return (tree_map(lambda l: jax.ShapeDtypeStruct(l.shape,
                                                    KINDS[l.kind][0]), tree),
            tree_map(lambda l: oasrs.PayloadSpec(l.shape, KINDS[l.kind][1]),
                     tree))


def _payload(name, m, rng):
    """The same ``[M, ...]`` leaves for both packages, as two trees (bf16
    rounded from the same f32 values by each, to nearest even)."""
    def one(leaf):
        shape = (m,) + leaf.shape
        if leaf.kind == "i32":
            x = rng.integers(-1000, 1000, shape).astype(np.int32)
        elif leaf.kind == "bool":
            x = rng.random(shape) < 0.5
        else:
            x = rng.lognormal(3.0, 1.0, shape).astype(np.float32)
        jd, td = KINDS[leaf.kind]
        return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)

    def build(tree):
        if isinstance(tree, Leaf):
            return one(tree)
        if isinstance(tree, dict):
            parts = {k: build(v) for k, v in tree.items()}
            return ({k: p[0] for k, p in parts.items()},
                    {k: p[1] for k, p in parts.items()})
        parts = [build(v) for v in tree]
        return (type(tree)(p[0] for p in parts),
                type(tree)(p[1] for p in parts))
    return build(TREES[name])


def _chunk(name, m, seed):
    rng = np.random.default_rng(seed)
    sid = rng.integers(0, S, m).astype(np.int32)
    mask = rng.random(m) < 0.9
    jp, tp = _payload(name, m, rng)
    return ((jnp.asarray(sid), jp, jnp.asarray(mask)),
            (torch.from_numpy(sid), tp, torch.from_numpy(mask)))


def _bits(a, t):
    a = np.asarray(a)
    t = t.contiguous()
    t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    assert a.shape == tuple(t.shape), (a.shape, t.shape)
    assert a.tobytes() == t.numpy().tobytes()


def _same_state(jst, tst):
    jl = jax.tree_util.tree_leaves(jst.values)
    tl = tree_flatten(tst.values)[0]
    assert len(jl) == len(tl)
    for a, t in zip(jl, tl):
        assert KINDS_OF[str(a.dtype)] == t.dtype
        _bits(a, t)
    _bits(jst.counts, tst.counts)
    _bits(jst.capacity, tst.capacity)
    np.testing.assert_array_equal(np.asarray(jst.key).astype(np.int64),
                                  tst.key.numpy())


KINDS_OF = {str(jnp.dtype(j)): t for j, t in KINDS.values()}


def _init(name, seed):
    jspec, tspec = _specs(name)
    return (joasrs.init(S, jnp.asarray(CAP, jnp.int32), jspec,
                        jax.random.PRNGKey(seed), max_capacity=N_MAX),
            oasrs.init(S, CAP, prng.PRNGKey(seed), max_capacity=N_MAX,
                       payload_spec=tspec, device="cpu"))


_jit_chunk = jax.jit(joasrs.update_chunk)
_jit_item = jax.jit(joasrs.update_item)
_jit_stream = jax.jit(joasrs.update_stream)
_jit_lanes = jax.jit(joasrs.update_pipelined_chunks,
                     static_argnames="lane")
_jit_local = jax.jit(jdist.local_update)


@pytest.mark.parametrize("name", sorted(TREES))
def test_init_bitwise(name):
    jst, tst = _init(name, 0)
    _same_state(jst, tst)
    assert tst.max_capacity == N_MAX and tst.num_strata == S


@pytest.mark.parametrize("name", sorted(TREES))
def test_update_chunk_bitwise(name):
    jst, tst = _init(name, 1)
    for c in range(3):
        (js, jp, jm), (ts, tp, tm) = _chunk(name, 200, 10 + c)
        jst = _jit_chunk(jst, js, jp, jm)
        tst = oasrs.update_chunk(tst, ts, tp, tm)
        _same_state(jst, tst)


@pytest.mark.parametrize("name", sorted(TREES))
def test_update_item_bitwise(name):
    jst, tst = _init(name, 2)
    (js, jp, jm), (ts, tp, tm) = _chunk(name, 30, 20)
    for j in range(30):
        jst = _jit_item(jst, js[j], jax.tree.map(lambda p: p[j], jp), jm[j])
        tst = oasrs.update_item(tst, ts[j:j + 1],
                                tree_map(lambda p: p[j], tp), tm[j:j + 1])
    _same_state(jst, tst)


@pytest.mark.parametrize("name", sorted(TREES))
def test_update_stream_bitwise(name):
    jst, tst = _init(name, 3)
    (js, jp, jm), (ts, tp, tm) = _chunk(name, 60, 30)
    _same_state(_jit_stream(jst, js, jp, jm),
                oasrs.update_stream(tst, ts, tp, tm))


@pytest.mark.parametrize("name", sorted(TREES))
def test_update_pipelined_chunks_bitwise(name):
    jst, tst = _init(name, 4)
    (js, jp, jm), (ts, tp, tm) = _chunk(name, 128, 40)
    _same_state(_jit_lanes(jst, js, jp, lane=32, mask=jm),
                oasrs.update_pipelined_chunks(tst, ts, tp, lane=32,
                                              mask=tm))


@pytest.mark.parametrize("name", sorted(TREES))
def test_local_update_bitwise(name):
    jst, tst = _init(name, 5)
    for c in range(2):
        (js, jp, jm), (ts, tp, tm) = _chunk(name, 150, 50 + c)
        jst = _jit_local(jst, js, jp, jm)
        tst = tdist.local_update(tst, ts, tp, tm)
        _same_state(jst, tst)


@pytest.mark.parametrize("name", sorted(TREES))
def test_window_init_and_slide_bitwise(name):
    """A ring of 3 intervals, 4 fresh intervals slid through it (it
    wraps): every leaf of the ring bit for bit."""
    jspec, tspec = _specs(name)
    jw = jwin.init(3, S, 16, jspec, jax.random.PRNGKey(6))
    tw = twin.init(3, S, 16, prng.PRNGKey(6), payload_spec=tspec,
                   device="cpu")
    _same_state(jw.intervals, tw.intervals)
    for i in range(4):
        jst, tst = _init(name, 60 + i)
        (js, jp, jm), (ts, tp, tm) = _chunk(name, 100, 70 + i)
        jw = jwin.slide(jw, _jit_chunk(jst, js, jp, jm))
        tw = twin.slide(tw, oasrs.update_chunk(tst, ts, tp, tm))
        _same_state(jw.intervals, tw.intervals)
        assert (int(jw.cursor), int(jw.filled)) == \
            (int(tw.cursor), int(tw.filled))


# ---------------------------------------------------------------------------
# extract= through every query.
# ---------------------------------------------------------------------------

def _log2_class(v):
    """The reference example's heavy-hitter key: floor(log2(max(v, 1)))."""
    if isinstance(v, torch.Tensor):
        return torch.floor(torch.log2(torch.clamp(v, min=1.0)))
    return jnp.floor(jnp.log2(jnp.maximum(v, 1.0)))


def _val(v):
    return v["val"]


@functools.lru_cache(maxsize=1)
def _states():
    """One dict-tree state and one window of them in each package (the
    queries read them and write nothing)."""
    jst, tst = _init("dict", 7)
    (js, jp, jm), (ts, tp, tm) = _chunk("dict", 600, 80)
    jst, tst = _jit_chunk(jst, js, jp, jm), oasrs.update_chunk(tst, ts, tp,
                                                               tm)
    jspec, tspec = _specs("dict")
    jw = jwin.init(2, S, 16, jspec, jax.random.PRNGKey(8))
    tw = twin.init(2, S, 16, prng.PRNGKey(8), payload_spec=tspec,
                   device="cpu")
    for i in range(3):
        js0, ts0 = _init("dict", 90 + i)
        (js, jp, jm), (ts, tp, tm) = _chunk("dict", 300, 100 + i)
        jw = jwin.slide(jw, _jit_chunk(js0, js, jp, jm))
        tw = twin.slide(tw, oasrs.update_chunk(ts0, ts, tp, tm))
    return (jst, tst), (jw, tw)


_EDGES = (0.0, 4.0, 16.0, 64.0, 256.0, 1e5)


def _edges(m):
    return jnp.asarray(_EDGES) if m in (jquery, jwin) else \
        torch.tensor(_EDGES)


def _key(m, seed):
    return jax.random.PRNGKey(seed) if m in (jquery, jwin, jqt, jsk) \
        else prng.PRNGKey(seed)


#: name → (query over (module, source), bootstrap, integer outputs)
STATE_QUERIES = {
    "sum": (lambda m, s: m.query_sum(s, extract=_val), False),
    "mean": (lambda m, s: m.query_mean(s, extract=_val), False),
    "count": (lambda m, s: m.query_count(s, lambda x: x > 20.0,
                                         extract=_val), False),
    "linear": (lambda m, s: m.query_linear(s, lambda x: 2.0 * x + 1.0,
                                           extract=_val), False),
    "group_means": (lambda m, s: m.group_means(s, extract=_val), False),
    "histogram": (lambda m, s: m.query_histogram(s, _edges(m),
                                                 extract=_val), False),
    "quantile": (lambda m, s: m.query_quantile(s, (0.5, 0.9), extract=_val,
                                               num_replicates=8), True),
    "distinct": (lambda m, s: m.query_distinct(
        s, extract=lambda v: v["key"] % 50, num_replicates=8), True),
    "key_sum": (lambda m, s: m.query_sum(
        s, extract=lambda v: v["key"]), False),
}
WINDOW_QUERIES = {
    "sum": (lambda m, w: m.query_sum(w, extract=_val), False),
    "mean": (lambda m, w: m.query_mean(w, extract=_val), False),
    "per_key_sum": (lambda m, w: m.query_per_key_sum(w, extract=_val),
                    False),
    "session_sum": (lambda m, w: m.query_session_sum(w, 1, extract=_val),
                    False),
    "histogram": (lambda m, w: m.query_histogram(w, _edges(m),
                                                 extract=_val), False),
    "quantile": (lambda m, w: m.query_quantile(w, (0.5, 0.9), extract=_val,
                                               num_replicates=8), True),
    "distinct": (lambda m, w: m.query_distinct(
        w, extract=lambda v: v["key"] % 50, num_replicates=8), True),
}


def _close(a, b, boot):
    np.testing.assert_allclose(b.value.numpy(), np.asarray(a.value),
                               rtol=1e-5)
    np.testing.assert_allclose(b.variance.numpy(), np.asarray(a.variance),
                               rtol=1e-3 if boot else 1e-4)


@pytest.mark.parametrize("name", sorted(STATE_QUERIES))
def test_state_queries_extract(name):
    (jst, tst), _ = _states()
    fn, boot = STATE_QUERIES[name]
    _close(fn(jquery, jst), fn(tquery, tst), boot)


@pytest.mark.parametrize("name", sorted(WINDOW_QUERIES))
def test_window_queries_extract(name):
    _, (jw, tw) = _states()
    fn, boot = WINDOW_QUERIES[name]
    _close(fn(jwin, jw), fn(twin, tw), boot)


@pytest.mark.parametrize("source", ["state", "window"])
def test_heavy_hitters_log2_classes(source):
    """The reference example's top flow-size classes: the keys and the
    sampled counts behind them bitwise, the estimates within rtol."""
    (jst, tst), (jw, tw) = _states()
    ext = lambda v: _log2_class(v["val"])
    if source == "state":
        a = jquery.query_heavy_hitters(jst, 3, extract=ext)
        b = tquery.query_heavy_hitters(tst, 3, extract=ext)
        c = tsk.query_heavy_hitters(tst, 3, extract=ext)
        _bits(a.keys, c.keys)
    else:
        a = jwin.query_heavy_hitters(jw, 3, extract=ext)
        b = twin.query_heavy_hitters(tw, 3, extract=ext)
    _bits(a.keys, b.keys)
    np.testing.assert_allclose(b.sample_weight.numpy(),
                               np.asarray(a.sample_weight), rtol=1e-5)
    _close(a.estimate, b.estimate, False)


def test_quantile_and_sketch_modules_extract():
    """``core/quantile`` and ``core/sketches`` called directly: the view's
    values bitwise, the estimates within rtol."""
    (jst, tst), (jw, tw) = _states()
    _bits(jqt.sample_view(jst, _val).values, tqt.sample_view(tst,
                                                            _val).values)
    _bits(jwin.sample_view(jw, _val).values, twin.sample_view(tw,
                                                             _val).values)
    _close(jqt.query_quantile(jst, (0.25, 0.75), extract=_val,
                              num_replicates=8),
           tqt.query_quantile(tst, (0.25, 0.75), extract=_val,
                              num_replicates=8), True)
    ext = lambda v: v["key"] % 40
    _close(jsk.query_distinct(jst, extract=ext, num_replicates=8),
           tsk.query_distinct(tst, extract=ext, num_replicates=8), True)
    xs_j, w_j, ok_j = joasrs.sample_with_weights(jst, _val)
    xs_t, w_t, ok_t = oasrs.sample_with_weights(tst, _val)
    for a, t in ((xs_j, xs_t), (w_j, w_t), (ok_j, ok_t)):
        _bits(a, t)


def test_tuple_tree_extract():
    """A component of the ``f32 [3]`` leaf and the bf16 leaf of the tuple
    tree, extracted for a SUM and a MEAN."""
    jst, tst = _init("tuple", 9)
    (js, jp, jm), (ts, tp, tm) = _chunk("tuple", 400, 110)
    jst, tst = _jit_chunk(jst, js, jp, jm), oasrs.update_chunk(tst, ts, tp,
                                                               tm)
    _close(jquery.query_sum(jst, extract=lambda v: v[0][..., 1]),
           tquery.query_sum(tst, extract=lambda v: v[0][..., 1]), False)
    _close(jquery.query_mean(jst, extract=lambda v: v[1]),
           tquery.query_mean(tst, extract=lambda v: v[1]), False)


# ---------------------------------------------------------------------------
# Refusals.
# ---------------------------------------------------------------------------

def test_fold_refuses_another_structure():
    jst, tst = _init("dict", 11)
    (js, jp, jm), (ts, tp, tm) = _chunk("dict", 20, 120)
    with pytest.raises(ValueError):
        joasrs.update_chunk(jst, js, {"val": jp["val"]}, jm)
    with pytest.raises(ValueError):
        oasrs.update_chunk(tst, ts, {"val": tp["val"]}, tm)
    with pytest.raises(ValueError):
        oasrs.update_item(tst, ts[:1], [tp["key"][0], tp["val"][0]])


def test_slide_refuses_another_structure():
    jspec, tspec = _specs("dict")
    jw = jwin.init(2, S, 16, jspec, jax.random.PRNGKey(0))
    tw = twin.init(2, S, 16, prng.PRNGKey(0), payload_spec=tspec,
                   device="cpu")
    jst, tst = _init("tuple", 12)
    with pytest.raises(ValueError):
        jwin.slide(jw, jst)
    with pytest.raises(ValueError):
        twin.slide(tw, tst)


@pytest.mark.parametrize("which", ["query", "quantile", "window"])
def test_wrong_shape_extract_raises(which):
    (jst, tst), (jw, tw) = _states()
    bad = lambda v: v["val"][..., :3]
    if which == "query":
        for m, s in ((jquery, jst), (tquery, tst)):
            with pytest.raises(ValueError, match="N_max"):
                m.query_sum(s, extract=bad)
    elif which == "quantile":
        for m, s in ((jqt, jst), (tqt, tst)):
            with pytest.raises(ValueError, match="N_max"):
                m.sample_view(s, bad)
    else:
        for m, w in ((jwin, jw), (twin, tw)):
            with pytest.raises(ValueError):
                m.query_sum(w, extract=lambda v: v["val"][None])
