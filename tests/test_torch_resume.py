"""Both of the port's executors resumed from the reference's state.

For every ingest path and both emission modes, the reference runs two
emission periods (a flush boundary for the batched executor); its state
is converted and its host cursors carried over, and both continue on the
same suffix: bitwise as in ``test_torch_executors.py``.
"""
import numpy as np
import pytest

from repro.runtime import executor as jex
from repro_torch.runtime import convert
from test_torch_executors import CASES, _assert_same_run, _executors
from test_torch_runtime import (CONFIGS, _chunks, _jchunk, _tchunk,
                                jax_state_dict)


@pytest.mark.parametrize("name,ingest,mode,emission", CASES)
def test_executor_carry_over_from_converted_state(name, ingest, mode,
                                                  emission):
    """Run the reference for two emission periods (a flush boundary for
    the batched executor), convert its state and host cursors, continue
    both on the same suffix."""
    kw = CONFIGS[name]
    k = 2 * (kw["emit_every"] if mode == "pipelined"
             else jex.RuntimeConfig(**kw).batch_chunks)
    chunks = _chunks(5, 13, 200, kw["num_strata"], kw["interval_span"])
    je, te = _executors(name, ingest, mode, emission, seed=11)
    for c in chunks[:k]:
        je.push(_jchunk(c))
    assert not getattr(je, "_pending", [])
    done = len(je.emissions)
    cursors = dict(emitted_through=je._emitted_through,
                   emit_base_key=np.asarray(je._emit_base_key),
                   items_since_emit=je._items_since_emit,
                   last_latency=je._last_latency)
    if mode == "batched":
        cursors["batch_chunks"] = je.batch_chunks
    te.resume(convert.state_from_numpy(jax_state_dict(je.state), "cpu"),
              chunks_pushed=k, emissions_done=done, **cursors)
    for c in chunks[k:]:
        je.push(_jchunk(c))
        te.push(_tchunk(c))
    _assert_same_run(je, te, je.finalize()[done:], te.finalize())
