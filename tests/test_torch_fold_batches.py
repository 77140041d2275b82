"""The reservoir fold batched over W·K folds, on the CPU.

The reference's masked ingest ``vmap``s its fold's Pallas call over the K
ring slots, and its sharded core ``vmap``s that over the W shards: one
program for all W·K folds, the items batched over the shards and closed
over the slots. The port's batched call (``ops.reservoir_fold`` with
``counts [W, K, S]``, ``mask [W, K, M]``, items ``[W, M]``) is held bit
for bit to that nested ``jax.vmap`` of the reference's kernel in
interpret mode, to W·K unbatched calls of its own, and the masked
executor to one call per chunk. The CUDA kernel is held to the same
plain version on the card in ``test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import reservoir as jres
from repro_torch import prng
from repro_torch.kernels import ops, reservoir
from repro_torch.runtime import convert
from repro_torch.runtime import executor as tex
from repro_torch.runtime.records import TimestampedChunk
from test_torch_cuda import fold_batch_inputs, fold_of, to_tree
from test_torch_runtime import _registries, _tchunk
from test_torch_sharded import sharded_chunks, sharded_kw

#: per form: (S, N_max, M)
FORMS = {"small": (4, 64, 300), "parted": (1_025, 8, 4_096)}


def _leaves(tree):
    return tree if isinstance(tree, dict) else {"": tree}


def _pallas_nested(inp):
    """The reference's kernel in interpret mode under ``jax.vmap`` over
    the shards (items and folds batched) of ``jax.vmap`` over the slots
    (the shard's items closed over), one call a payload leaf: the new
    ring leaves and counts, numpy."""
    def shard(sid, pay, ua, us, mask, counts, cap, vals):
        return jax.vmap(lambda mk, c, cp, v: jres.reservoir_fold(
            sid, pay, ua, us, mk, c, cp, v, block_m=128,
            interpret=True))(mask, counts, cap, vals)
    rings, counts = {}, []
    pays, vals = _leaves(inp["payload"]), _leaves(inp["values"])
    for name in pays:
        ring, new = jax.vmap(shard)(*(jnp.asarray(a) for a in (
            inp["stratum_ids"], pays[name], inp["u_accept"], inp["u_slot"],
            inp["mask"], inp["counts"], inp["capacity"], vals[name])))
        rings[name] = np.asarray(ring)
        counts.append(np.asarray(new))
    return rings, counts


def _port(inp):
    t = to_tree("cpu", inp)
    new = ops.reservoir_fold(**t)
    return {n: v.numpy() for n, v in _leaves(t["values"]).items()}, new


def _same(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, name
    assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("w", [1, 2, 3])
def test_batched_plain_matches_nested_vmapped_pallas(w, k, form):
    s, n_max, m = FORMS[form]
    inp = fold_batch_inputs(80 + w * 10 + k, w, k, s=s, n_max=n_max, m=m)
    rings, new = _port(inp)
    jrings, jcounts = _pallas_nested(inp)
    _same(new.numpy(), jcounts[0], "counts")
    _same(rings[""], jrings[""], "values")
    assert new.shape == (w, k, s)
    assert (rings[""] != inp["values"]).any()


@pytest.mark.parametrize("form", sorted(FORMS))
def test_batched_two_leaves_match_nested_vmapped_pallas(form):
    """A payload of two leaves (``{"val": f32, "key": i32}``): each leaf
    bit for bit the reference's nested vmap on that leaf alone (its
    kernel takes one leaf), the counts the same from both."""
    s, n_max, m = FORMS[form]
    inp = fold_batch_inputs(87, 2, 3, s=s, n_max=n_max, m=m, leaves=2)
    rings, new = _port(inp)
    jrings, jcounts = _pallas_nested(inp)
    for c in jcounts:
        _same(new.numpy(), c, "counts")
    for name in ("val", "key"):
        _same(rings[name], jrings[name], name)
        assert (rings[name] != inp["values"][name]).any(), name


@pytest.mark.parametrize("leaves", [1, 2])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_batched_plain_matches_unbatched(form, leaves):
    """Nine folds (W = 3, K = 3) in one call, bit for bit nine unbatched
    calls, fold after fold, on each fold's views."""
    s, n_max, m = FORMS[form]
    inp = fold_batch_inputs(88, 3, 3, s=s, n_max=n_max, m=m, leaves=leaves)
    rings, new = _port(inp)
    assert (form == "parted") == (s > reservoir.MAX_STRATA)
    one = to_tree("cpu", inp)
    for i in range(3):
        for j in range(3):
            fold = fold_of(one, i, j)
            _same(new[i, j].numpy(), ops.reservoir_fold(**fold).numpy(),
                  f"counts {i, j}")
    for name, ring in _leaves(one["values"]).items():
        _same(rings[name], ring.numpy(), f"values {name}")


@pytest.mark.parametrize("m", [0, 1])
def test_batched_tiny_chunks_match_unbatched(m):
    """A chunk of no item and of one: each fold its unbatched call's
    (no item leaves the ring and the counts as they were)."""
    inp = fold_batch_inputs(94 + m, 2, 3, m=m)
    rings, new = _port(inp)
    one = to_tree("cpu", inp)
    for i in range(2):
        for j in range(3):
            _same(new[i, j].numpy(),
                  ops.reservoir_fold(**fold_of(one, i, j)).numpy(),
                  f"counts {i, j}")
    _same(rings[""], one["values"].numpy(), "values")
    if m == 0:
        _same(new.numpy(), inp["counts"], "counts")
        _same(rings[""], inp["values"], "values")


def _bad(inp, field):
    """``inp`` with ``field`` cut to the first of its leading axis (a
    payload or values tree: its first leaf)."""
    v = inp[field]
    return dict(inp, **{field: dict(v, val=v["val"][:1])
                        if isinstance(v, dict) else v[:1]})


@pytest.mark.parametrize("fn", [ops.reservoir_fold, reservoir.reservoir_fold],
                         ids=["plain", "kernel_wrapper"])
@pytest.mark.parametrize("field,match", [
    ("stratum_ids", "leading fold batch"), ("u_slot", "leading fold batch"),
    ("mask", "leading fold batch"), ("capacity", "leading fold batch"),
    ("counts", "leading fold batch"), ("payload", "does not match items"),
    ("values", r"is not \[2, 3\]")])
def test_leading_axes_that_disagree_raise(fn, field, match):
    """A batched call whose leading axes disagree raises ``ValueError``
    in both versions, before any work (the kernel's wrapper before it
    asks for a CUDA tensor); a tree's leaves too."""
    inp = fold_batch_inputs(89, 2, 3, leaves=2)
    with pytest.raises(ValueError, match=match):
        fn(**to_tree("cpu", _bad(inp, field)))


def test_counts_of_two_axes_raise():
    inp = fold_batch_inputs(90, 2, 3)
    inp["counts"] = inp["counts"][0]
    inp["capacity"] = inp["capacity"][0]
    with pytest.raises(ValueError, match=r"\[S\] or \[W, K, S\]"):
        ops.reservoir_fold(**to_tree("cpu", inp))


def _spy(monkeypatch):
    calls = []
    real = ops.reservoir_fold

    def spy(*a, **kw):
        calls.append((tuple(a[4].shape), tuple(a[7].shape)))
        return real(*a, **kw)
    monkeypatch.setattr(ops, "reservoir_fold", spy)
    return calls


def _assert_states_bitwise(a, b):
    one, two = (dict(convert.named_leaves(convert.host_state(s)))
                for s in (a, b))
    assert one.keys() == two.keys()
    for path in one:
        _same(one[path], two[path], path)


@pytest.mark.parametrize("w", [1, 4])
def test_masked_executor_one_call_per_chunk(w, monkeypatch):
    """The masked executor makes one ``ops.reservoir_fold`` call per
    chunk, batched over the state's ``[W, K]`` folds (an unsharded state
    one shard), and ends bit for bit in the fused path's state (the
    reference's own contract between its paths)."""
    chunks = sharded_chunks(91, 6, w, disorder=0.3)
    states = {}
    calls = _spy(monkeypatch)
    for ingest in ("masked", "fused"):
        ex = tex.PipelinedExecutor(
            tex.RuntimeConfig(**sharded_kw(w, ingest=ingest,
                                           emit_every=100)),
            _registries()[1], prng.PRNGKey(5), device="cpu")
        for c in chunks:
            ex.push(_tchunk(c if w > 1 else tuple(a[0] for a in c)))
        states[ingest] = ex.state
        if ingest == "masked":
            masked = list(calls)
    ring = tuple(states["masked"].window.intervals.values.shape)
    n_max = 16 // w                    # split_capacity(16, W)
    assert ring == ((w, 3, 3, n_max) if w > 1 else (3, 3, 16))
    assert masked == [((w, 3, 64), (w, 3, 3, n_max))] * len(chunks)
    _assert_states_bitwise(states["masked"], states["fused"])
    assert int(states["masked"].wm.late.sum()) > 0


def test_mesh_rank_masked_ingest_one_call_per_chunk(monkeypatch):
    """On the mesh placement each rank's masked ingest of its ``[1, M]``
    row is one call over its ``[1, K]`` folds (no group: the ingest is
    collective-free), and each rank's state is bit for bit its row of
    the vmap placement's state."""
    kw = sharded_kw(4, ingest="masked")
    chunks = [_tchunk(c) for c in sharded_chunks(92, 5, 4)]
    vmap_cfg = tex.RuntimeConfig(**kw)
    whole = tex.init_state(vmap_cfg, prng.PRNGKey(6), "cpu")
    for c in chunks:
        whole = tex._ingest_chunk(vmap_cfg, whole, c)
    mesh_cfg = tex.RuntimeConfig(**kw, placement="mesh")
    calls = _spy(monkeypatch)
    for r in range(4):
        rank = tex.init_state(mesh_cfg, prng.PRNGKey(6), "cpu", shard=r)
        for c in chunks:
            row = TimestampedChunk(*(getattr(c, f.name)[r:r + 1] for f in
                                     dataclasses.fields(TimestampedChunk)))
            rank = tex._ingest_chunk(mesh_cfg, rank, row)
        mine = dict(convert.named_leaves(convert.host_state(rank)))
        for path, leaf in convert.named_leaves(convert.host_state(whole)):
            _same(mine[path], np.asarray(leaf)[r:r + 1], f"rank {r} {path}")
    assert calls == [((1, 3, 64), (1, 3, 3, 4))] * (4 * len(chunks))
