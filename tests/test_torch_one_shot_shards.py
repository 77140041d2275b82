"""The one-shot ingest batched over a leading shard axis, on the CPU.

The reference's sharded core ``vmap``s its one-shot Pallas call, which
batches it into one call whose grid leads with the shard. The port's
batched call (``ops.one_shot_ingest`` on ``[W, ...]`` tensors) is held
bit for bit to ``jax.vmap`` of the reference's kernel in interpret mode,
to W unbatched calls of its own, and the sharded onekernel executor to
one call per chunk. The CUDA kernel is held to the same plain version on
the card in ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import reservoir as jres
from repro_torch import prng
from repro_torch.kernels import one_shot, ops
from repro_torch.runtime import convert
from repro_torch.runtime import executor as tex
from test_torch_cuda import (ONE_SHOT_CASES, ONE_SHOT_FIELDS, SHARDS,
                             one_shot_inputs, shard_inputs, stack_shards,
                             to_tree, two_leaves)
from test_torch_one_shot import _assert_bitwise, _np, _port
from test_torch_runtime import _registries, _tchunk
from test_torch_sharded import sharded_chunks, sharded_kw

ITEM_NAMES = ("times", "stratum_ids", "payload", "mask", "u_accept",
              "u_slot")

def shard_of(tree, w):
    if isinstance(tree, dict):
        return {k: shard_of(v, w) for k, v in tree.items()}
    return tree[w]


def _pallas_vmapped(items, state, span, lateness, block_m=128):
    """``jax.vmap`` of the reference's one-shot Pallas call (interpret
    mode) over the leading shard axis of every input."""
    def one(it, st):
        return jres.one_shot_ingest(
            *(it[n] for n in ITEM_NAMES), span=span,
            allowed_lateness=lateness, block_m=block_m, interpret=True,
            **st)
    out = jax.vmap(one)(jax.tree.map(jnp.asarray, items),
                        jax.tree.map(jnp.asarray, state))
    return {f: _np(jax.device_get(getattr(out, f))) for f in ONE_SHOT_FIELDS}


@pytest.mark.parametrize("leaves", [1, 2])
@pytest.mark.parametrize("w", [2, 3])
def test_batched_plain_matches_vmapped_pallas(w, leaves):
    items, state = shard_inputs(tuple(SHARDS)[:w], 31)
    if leaves == 2:
        items, state = two_leaves(items, state, 32)
    port = _port(items, state, 1.0, 0.5)
    _assert_bitwise(port, _pallas_vmapped(items, state, 1.0, 0.5))
    assert (port["items"] == state["items"])[0]          # all masked out
    assert port["late"][1] > state["late"][1]            # crossing: late,
    assert port["dropped"][1] > state["dropped"][1]      # dropped, reset
    assert (port["slot_interval"][1] != state["slot_interval"][1]).any()
    if w == 3:
        assert (port["counters"][2, 4] > state["counters"][2, 4]).any()


@pytest.mark.parametrize("case", ["crossing", "over_capacity", "ragged"])
def test_one_shard_batched_matches_unbatched(case):
    items, state = one_shot_inputs(41, **ONE_SHOT_CASES[case])
    one = _port({k: v[None] for k, v in items.items()},
                {k: np.asarray(v)[None] for k, v in state.items()}, 1.0, 0.5)
    _assert_bitwise({f: v[0] for f, v in one.items()},
                    _port(items, state, 1.0, 0.5))


def _unbatched(items, state, w):
    """W unbatched plain calls, shard after shard."""
    outs = [_port(shard_of(items, i), shard_of(state, i), 1.0, 0.5)
            for i in range(w)]
    return {f: stack_shards([o[f] for o in outs]) for f in ONE_SHOT_FIELDS}


@pytest.mark.parametrize("leaves", [1, 2])
def test_batched_past_the_small_form_matches_unbatched(leaves):
    """At ``K·S`` = 5 x 205 = 1,025 cells, past the kernel's small form
    (its parted form on the card): one batched call over three shards is
    bit for bit three unbatched calls."""
    kw = dict(k=5, s=205, n_max=8, m=700)
    items, state = shard_inputs(("crossing", "over_capacity", "all_masked"),
                                43, **kw)
    assert kw["k"] * kw["s"] > one_shot.MAX_CELLS
    if leaves == 2:
        items, state = two_leaves(items, state, 44)
    _assert_bitwise(_port(items, state, 1.0, 0.5),
                    _unbatched(items, state, 3))


def _call(fn, items, state):
    return fn(**to_tree("cpu", items), span=1.0, allowed_lateness=0.5,
              **to_tree("cpu", state))


@pytest.mark.parametrize("fn", [ops.one_shot_ingest,
                                one_shot.one_shot_ingest],
                         ids=["plain", "kernel_wrapper"])
@pytest.mark.parametrize("field", ["counts", "max_time", "counters",
                                   "payload", "values", "u_slot"])
def test_leading_axes_that_disagree_raise(fn, field):
    """A batched call whose leading axes disagree raises ``ValueError``
    in both versions, before any work (the kernel's wrapper before it
    asks for a CUDA tensor)."""
    items, state = shard_inputs(("crossing", "filling"), 45)
    if field in items:
        items[field] = items[field][:1]
    else:
        state[field] = np.asarray(state[field])[:1]
    with pytest.raises(ValueError, match="leading shard axis"):
        _call(fn, items, state)


def test_times_of_three_axes_raise():
    items, state = shard_inputs(("crossing", "filling"), 46)
    items["times"] = items["times"][None]
    with pytest.raises(ValueError, match=r"\[M\] or \[W, M\]"):
        _call(ops.one_shot_ingest, items, state)


def test_shards_add_no_refusal():
    """Any W runs, as the reference's vmap does: eight shards of the
    crossing case, each bit for bit its own unbatched call."""
    items, state = shard_inputs(("crossing",) * 8, 47)
    _assert_bitwise(_port(items, state, 1.0, 0.5),
                    _unbatched(items, state, 8))


@pytest.mark.parametrize("w", [2, 4])
def test_sharded_onekernel_executor_one_call_per_chunk(w, monkeypatch):
    """The sharded onekernel executor makes one ``ops.one_shot_ingest``
    call per chunk on the ``[W, ...]`` state, and ends bit for bit in the
    fused path's state (the reference's own contract between its paths)."""
    calls = []
    real = ops.one_shot_ingest

    def spy(*items, **state):
        calls.append((tuple(items[0].shape),
                      tuple(state["values"].shape)))
        return real(*items, **state)
    monkeypatch.setattr(ops, "one_shot_ingest", spy)
    chunks = sharded_chunks(9, 6, w, disorder=0.3)
    states = {}
    for ingest in ("onekernel", "fused"):
        ex = tex.PipelinedExecutor(
            tex.RuntimeConfig(**sharded_kw(w, ingest=ingest,
                                           emit_every=100)),
            _registries()[1], prng.PRNGKey(5), device="cpu")
        for c in chunks:
            ex.push(_tchunk(c))
        states[ingest] = ex.state
    ring = tuple(states["onekernel"].window.intervals.values.shape)
    assert ring[:3] == (w, 3, 3)
    assert calls == [((w, 64), ring)] * len(chunks)
    one, fused = (dict(convert.named_leaves(convert.host_state(states[i])))
                  for i in ("onekernel", "fused"))
    assert one.keys() == fused.keys()
    for path in one:
        a, b = np.asarray(one[path]), np.asarray(fused[path])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    late = states["onekernel"].wm.late
    assert int(late.sum()) > 0 and int(states["onekernel"].wm.dropped.sum())


def test_unsharded_onekernel_executor_one_call_per_chunk(monkeypatch):
    """An unsharded state goes through the same single call, on its
    ``[1]``-leading views."""
    calls = []
    real = ops.one_shot_ingest

    def spy(*items, **state):
        calls.append(tuple(items[0].shape))
        return real(*items, **state)
    monkeypatch.setattr(ops, "one_shot_ingest", spy)
    ex = tex.PipelinedExecutor(
        tex.RuntimeConfig(**sharded_kw(1, ingest="onekernel",
                                       emit_every=100)),
        _registries()[1], prng.PRNGKey(5), device="cpu")
    chunks = sharded_chunks(10, 3, 1)
    for vals, sid, t, mask in chunks:
        ex.push(_tchunk((vals[0], sid[0], t[0], mask[0])))
    assert calls == [(1, 64)] * 3
    assert ex.state.window.intervals.values.shape == (3, 3, 16)
