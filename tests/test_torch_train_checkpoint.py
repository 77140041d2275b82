"""Training checkpoints across the packages, on the CPU.

A checkpoint of ``{"state": TrainState, "res": OASRSState, "epoch"}``
written by the port restores with the reference's ``restore`` and the
reverse, every leaf bit for bit, the bf16 params and the reservoirs'
PRNG key included; the port's own ``save`` / ``restore`` /
``AsyncCheckpointer`` / ``latest_step`` / ``_gc`` behave as the
reference's ``tests/test_train_infra.py`` holds them; and a run of
``launch/train`` resumed from its checkpoint continues the uninterrupted
run bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core import oasrs as joasrs
from repro.models import api as japi
from repro.models import param as jparam
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch.core import oasrs as toasrs
from repro_torch.launch import train as tlt
from repro_torch.models import param as tparam
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt

ARCH = "phi4-mini-3.8b"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test (see ``test_torch_train``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.detach().cpu().numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.fixture(scope="module")
def trees():
    """The same run state in both packages: the bf16 smoke model's
    TrainState with distinct f32 master and moments at step 3,
    reservoirs with int32 payloads and a live key, the epoch cursor."""
    jcfg = jcfgs.get_config(ARCH, smoke=True)
    jp = jparam.init_params(japi.skeleton(jcfg), jax.random.PRNGKey(0))
    f32 = jax.tree.map(lambda p: p.astype(jnp.float32), jp)
    js = jopt.TrainState(
        params=jp, master=jax.tree.map(lambda x: x + 1e-3, f32),
        mu=jax.tree.map(lambda x: 0.5 * x, f32),
        nu=jax.tree.map(lambda x: x * x, f32),
        step=jnp.asarray(3, jnp.int32))
    jres = joasrs.init(8, 1, jax.ShapeDtypeStruct((), jnp.int32),
                       jax.random.PRNGKey(7), max_capacity=4)
    jres = joasrs.update_chunk(jres, jnp.arange(16, dtype=jnp.int32) % 8,
                               jnp.arange(16, dtype=jnp.int32))
    jtree = {"state": js, "res": jres, "epoch": jnp.asarray(5, jnp.int32)}
    ts = topt.train_state_from_reference(jax.device_get(js), "cpu")
    tres = toasrs.OASRSState(
        values=torch.from_numpy(np.array(jres.values)),
        counts=torch.from_numpy(np.array(jres.counts)),
        capacity=torch.from_numpy(np.array(jres.capacity)),
        key=torch.from_numpy(np.array(jres.key).astype(np.int64)))
    ttree = {"state": ts, "res": tres,
             "epoch": torch.tensor(5, dtype=torch.int32)}
    return jtree, ttree


def _assert_same(jtree, ttree):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = [leaf for leaf, _ in tckpt._flatten(ttree)]
    assert len(jl) == len(tl) > 10
    for i, (a, b) in enumerate(zip(jl, tl)):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        assert tuple(a.shape) == tuple(b.shape), i
        assert a.tobytes() == _bytes(b), i


def test_flatten_order_is_the_references(trees):
    jtree, ttree = trees
    _assert_same(jtree, ttree)
    assert "bfloat16" in {str(leaf.dtype)
                          for leaf in jax.tree_util.tree_leaves(jtree)}


def test_port_checkpoint_restores_in_the_reference(tmp_path, trees):
    jtree, ttree = trees
    tckpt.save(str(tmp_path), 1, ttree)
    assert jckpt.latest_step(str(tmp_path)) == 1
    target = jax.tree.map(jnp.zeros_like, jtree)
    got = jckpt.restore(str(tmp_path), 1, target)
    for a, b in zip(jax.tree_util.tree_leaves(jtree),
                    jax.tree_util.tree_leaves(got)):
        assert a.dtype == b.dtype and _bytes(a) == _bytes(b)


def test_reference_checkpoint_restores_in_the_port(tmp_path, trees):
    jtree, ttree = trees
    jckpt.save(str(tmp_path), 3, jtree)
    assert tckpt.latest_step(str(tmp_path)) == 3
    got = tckpt.restore(str(tmp_path), 3, ttree)
    assert isinstance(got["state"], topt.TrainState)
    assert isinstance(got["res"], toasrs.OASRSState)
    assert got["res"].key.dtype == torch.int64
    assert got["state"].params["embed"]["tokens"].dtype == torch.bfloat16
    _assert_same(jtree, got)
    with open(os.path.join(str(tmp_path), "step_00000003",
                           "manifest.json")) as f:
        assert '"bfloat16"' in f.read()


def test_checkpoint_roundtrip(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"params": {"w": torch.randn((8, 4), generator=g)},
            "step": torch.tensor(7, dtype=torch.int32),
            "reservoir": torch.randn((3, 16), generator=g)}
    tckpt.save(str(tmp_path), 7, tree)
    assert tckpt.latest_step(str(tmp_path)) == 7
    restored = tckpt.restore(str(tmp_path), 7, tree)
    for (_, a), (_, b) in zip(tparam.leaves(tree), tparam.leaves(restored)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def test_checkpoint_atomicity_and_gc(tmp_path):
    tree = {"w": torch.ones(4)}
    for s in (1, 2, 3, 4, 5):
        tckpt.save(str(tmp_path), s, tree, keep_last=2)
    assert tckpt.latest_step(str(tmp_path)) == 5
    steps = sorted(os.listdir(str(tmp_path)))
    assert len([s for s in steps if s.startswith("step_")]) == 2
    # a dir without COMMIT is ignored
    os.makedirs(str(tmp_path / "step_00000099"))
    assert tckpt.latest_step(str(tmp_path)) == 5
    assert tckpt.latest_step(str(tmp_path / "absent")) is None


def test_async_checkpointer(tmp_path):
    tree = {"w": torch.randn((128, 128), generator=torch.Generator()
                             .manual_seed(1))}
    ac = tckpt.AsyncCheckpointer(str(tmp_path))
    ac.save(1, tree)
    ac.save(2, {"w": tree["w"] + 1})   # waits for save 1
    ac.wait()
    assert tckpt.latest_step(str(tmp_path)) == 2
    restored = tckpt.restore(str(tmp_path), 2, tree)
    torch.testing.assert_close(restored["w"], tree["w"] + 1, rtol=0, atol=0)


def test_restore_shape_mismatch_raises(tmp_path):
    tckpt.save(str(tmp_path), 1, {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(str(tmp_path), 1, {"w": torch.ones(5)})
    with pytest.raises(NotImplementedError, match="12d"):
        tckpt.restore(str(tmp_path), 1, {"w": torch.ones(4)}, shardings=1)


def test_resumed_run_continues_the_uninterrupted_one(tmp_path):
    """Train 6 steps with a checkpoint every 3, then 3 more from the
    checkpoint: the same losses, bit for bit, as steps 7-9 of a 9-step
    run (the state, the reservoirs and the epoch cursor restored)."""
    kw = dict(arch=ARCH, steps=6, batch=4, seq_len=16,
              sampling_fraction=0.5)
    quiet = dict(device="cpu", log=lambda *_: None)
    whole = tlt.train(tlt.RunConfig(**dict(kw, steps=9)), **quiet)
    d = str(tmp_path / "ckpt")
    first = tlt.train(tlt.RunConfig(**kw, checkpoint_dir=d,
                                    checkpoint_every=3), **quiet)
    assert first == whole[:6]
    assert tckpt.latest_step(d) == 6
    lines = []
    rest = tlt.train(tlt.RunConfig(**dict(kw, steps=3), checkpoint_dir=d,
                                   checkpoint_every=100),
                     device="cpu", log=lines.append)
    assert lines[0] == "[train] restored checkpoint step 6 (epoch 6)"
    assert rest == whole[6:]
