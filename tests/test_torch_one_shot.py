"""The port's plain one-shot ingest against the reference's Pallas kernel
(interpret mode) and its numpy oracle, bitwise on every output field.
The CUDA kernel is held against the same plain version on the card in
``test_torch_cuda.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import reservoir as jres
from repro.obs import metrics as jobm
from repro.runtime import watermark as jwm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import one_shot
from repro_torch.obs import metrics as obm
from repro_torch.runtime import watermark as wm
from test_torch_cuda import (ONE_SHOT_CASES, ONE_SHOT_FIELDS,
                             one_shot_inputs, to_tree, two_leaves)


def _torch(d):
    return to_tree("cpu", d)


def _np(x):
    """A tensor, array or dict of them as numpy."""
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port(items, state, span, lateness):
    t = _torch(state)
    out = ops.one_shot_ingest(**_torch(items), span=span,
                              allowed_lateness=lateness, **t)
    for f in ONE_SHOT_FIELDS:            # every carried tensor, in place
        assert getattr(out, f) is t[f], f
    return {f: _np(getattr(out, f)) for f in ONE_SHOT_FIELDS}


def _pallas(items, state, span, lateness, block_m=128):
    out = jres.one_shot_ingest(
        *(jax.tree.map(jnp.asarray, items[k])
          for k in ("times", "stratum_ids", "payload", "mask", "u_accept",
                    "u_slot")),
        span=span, allowed_lateness=lateness, block_m=block_m,
        interpret=True, **{k: jax.tree.map(jnp.asarray, v)
                           for k, v in state.items()})
    return {f: _np(jax.device_get(getattr(out, f))) for f in ONE_SHOT_FIELDS}


def _oracle(items, state, span, lateness):
    r = jref.one_shot_ingest_ref(*(items[k] for k in (
        "times", "stratum_ids", "payload", "mask", "u_accept", "u_slot")),
        span=span, allowed_lateness=lateness, **state)
    return {f: np.asarray(r[f]) for f in ONE_SHOT_FIELDS}


def _assert_bitwise(a, b):
    for f in ONE_SHOT_FIELDS:
        pairs = ([(f"{f}.{k}", a[f][k], b[f][k]) for k in a[f]]
                 if isinstance(a[f], dict) else [(f, a[f], b[f])])
        assert not isinstance(b[f], dict) or b[f].keys() == a[f].keys(), f
        for name, x, y in pairs:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert x.tobytes() == y.tobytes(), name


@pytest.mark.parametrize("case", sorted(ONE_SHOT_CASES))
def test_plain_one_shot_matches_pallas(case):
    items, state = one_shot_inputs(21, **ONE_SHOT_CASES[case])
    port = _port(items, state, 1.0, 0.5)
    _assert_bitwise(port, _pallas(items, state, 1.0, 0.5))
    if case == "crossing":
        # late, dropped and a slot reset all happened in this one chunk
        assert port["late"] > state["late"]
        assert port["dropped"] > state["dropped"]
        assert (port["slot_interval"] != state["slot_interval"]).any()
    if case == "over_capacity":
        assert (port["counters"][4] > state["counters"][4]).any()


@pytest.mark.parametrize("span,lateness", [(1.0, 0.5), (5.0, 2.0)])
@pytest.mark.parametrize("case", ["ragged", "crossing", "i32_payload"])
def test_plain_one_shot_matches_oracle(case, span, lateness):
    """The numpy oracle divides by the span; at these spans that agrees
    with the compiled reciprocal product for every float."""
    kw = dict(ONE_SHOT_CASES[case])
    for f in ("t_lo", "t_hi", "max_time"):
        if f in kw:
            kw[f] = kw[f] * span
    items, state = one_shot_inputs(5, **kw)
    _assert_bitwise(_port(items, state, span, lateness),
                    _oracle(items, state, span, lateness))


def test_boundary_times_at_span_three():
    """Times just below ``j·3``: the port takes the interval as the
    reference's compiled code does (``t * f32(1/3)``), equal to the
    Pallas kernel and to the jitted routing; the numpy oracle divides
    and files some of these items one interval lower."""
    span = 3.0
    items, state = one_shot_inputs(8, k=3, s=2, m=600, max_time=0.0,
                                   open_interval=0)
    j = np.arange(1, 601, dtype=np.float32) * np.float32(span)
    items["times"] = np.nextafter(j, np.float32(0)).astype(np.float32)
    items["mask"][:] = True
    state["max_time"] = np.float32(-3.0e38)
    port = _port(items, state, span, 0.5)
    _assert_bitwise(port, _pallas(items, state, span, 0.5))
    tgt = wm.interval_of(torch.from_numpy(items["times"]), span).numpy()
    jit_tgt = jax.jit(lambda t: jwm.interval_of(t, span))(
        jnp.asarray(items["times"]))
    np.testing.assert_array_equal(tgt, np.asarray(jit_tgt))
    true_div = np.floor(items["times"] / np.float32(span)).astype(np.int32)
    assert (tgt != true_div).any()
    oracle = _oracle(items, state, span, 0.5)
    assert port["open_interval"] != oracle["open_interval"]


def test_counters_stack_and_unstack():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 99, (6, 3)).astype(np.int32)
    m = obm.unstack_counters(torch.from_numpy(rows.copy()),
                             torch.tensor(4, dtype=torch.int32),
                             torch.tensor(9, dtype=torch.int32))
    jm = jobm.unstack_counters(jnp.asarray(rows), jnp.int32(4), jnp.int32(9))
    ptrs = {getattr(m, f).data_ptr() for f in obm.COUNTER_FIELDS}
    assert len(ptrs) == 6                   # one buffer per row
    assert obm.COUNTER_FIELDS == jobm.COUNTER_FIELDS
    for f in obm.COUNTER_FIELDS:
        np.testing.assert_array_equal(getattr(m, f).numpy(),
                                      np.asarray(getattr(jm, f)))
    np.testing.assert_array_equal(obm.stack_counters(m).numpy(), rows)


@pytest.mark.parametrize("case", ["ragged", "crossing", "over_capacity"])
def test_plain_one_shot_two_leaves_matches_pallas(case):
    """A dict payload of an f32 and an i32 leaf (the reference's pytree
    payloads, ``tests/test_onekernel.py``'s heavy-hitter keys): the plain
    version bit for bit the reference's kernel in interpret mode on every
    field and both leaves, and its f32 leaf bit for bit a one-leaf call's
    on the same state."""
    one, state = one_shot_inputs(33, **ONE_SHOT_CASES[case])
    items, state2 = two_leaves(one, state, 34)
    port = _port(items, state2, 1.0, 0.5)
    _assert_bitwise(port, _pallas(items, state2, 1.0, 0.5))
    single = _port(one, state, 1.0, 0.5)
    _assert_bitwise(dict(port, values=port["values"]["val"]), single)
    assert (port["values"]["key"] != state2["values"]["key"]).any()


def test_one_shot_refuses_what_it_does_not_take():
    """What the reference refuses (``tests/test_onekernel.py::
    test_kernel_payload_structure_validation``): a payload whose structure
    is not the ring's, a ring leaf that is not ``[K, S, N_max]``, a leaf
    of another dtype than its ring's; and what the port's kernels do not
    take: 8-byte leaves, CPU tensors in the CUDA wrapper."""
    items, state = one_shot_inputs(1, m=32)
    t_items, t_state = _torch(items), _torch(state)
    kw = dict(span=1.0, allowed_lateness=0.5)
    pay = t_items.pop("payload")
    ring = t_state.pop("values")
    with pytest.raises(ValueError, match="structure"):
        ops.one_shot_ingest(payload={"val": pay}, **t_items, **kw,
                            **t_state, values=ring)
    with pytest.raises(ValueError, match="structure"):
        ops.one_shot_ingest(payload={"val": pay, "key": pay.int()},
                            **t_items, **kw, **t_state,
                            values={"val": ring, "k": ring.int()})
    with pytest.raises(ValueError, match="scalar payload"):
        ops.one_shot_ingest(payload={"val": pay}, **t_items, **kw,
                            **t_state, values={"val": ring[..., None]})
    with pytest.raises(ValueError, match="does not match"):
        ops.one_shot_ingest(payload=(pay, pay), **t_items, **kw,
                            **t_state, values=(ring, ring.int()))
    with pytest.raises(TypeError, match="4-byte"):
        ref.one_shot_ingest(payload=pay.double(), **t_items, **kw,
                            **t_state, values=ring.double())
    with pytest.raises(ValueError, match="CUDA"):
        one_shot.one_shot_ingest(payload=pay, **t_items, **kw, **t_state,
                                 values=ring)
    with pytest.raises(ValueError, match="CUDA"):
        one_shot.one_shot_ingest(payload=[pay, pay.int()], **t_items, **kw,
                                 **t_state, values=[ring, ring.int()])
