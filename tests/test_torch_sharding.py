"""``distributed/sharding`` and ``distributed/compression`` of the port
against the reference's, on the CPU.

Rules, specs and the ZeRO specs are compared entry for entry on the
reference's own abstract meshes (``conftest.abstract_mesh``: the port
reads any mesh whose ``.shape`` maps axis names to sizes). Placements on
a ``DeviceMesh`` run over a fake process group of 8 ranks, set up and
destroyed by the ``fake_mesh`` fixture. The compression runs in 1 and 4
spawned gloo ranks; the ranks import torch and the port only, so this
module imports JAX inside the parent's functions, never at its top.
"""
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from repro_torch import configs as tcfgs
from repro_torch import prng
from repro_torch.core import adaptive as tadaptive
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import param as tparam
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
VARIANTS = ("plain", "pure_dp", "sp_residual")
PG_TIMEOUT_S, JOIN_TIMEOUT_S = 60, 120


def _jmesh(name):
    from conftest import abstract_mesh
    return abstract_mesh(*MESHES[name])


def _cfgs(arch, variant="plain"):
    from repro import configs as jcfgs
    jc, tc = jcfgs.get_config(arch), tcfgs.get_config(arch)
    if variant != "plain":
        jc, tc = jc.replace(**{variant: True}), tc.replace(**{variant: True})
    return jc, tc


@pytest.fixture
def fake_mesh():
    """A (2, 4) ``data × model`` mesh over a fake group of 8 ranks,
    destroyed after the test."""
    with tmesh.fake_group(8):
        yield tmesh._device_mesh((2, 4), ("data", "model"), "cpu")


# ---------------------------------------------------------------------------
# Rules and specs.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_build_rules_match_reference(arch, mesh, variant):
    from repro.distributed import sharding as jshd
    jc, tc = _cfgs(arch, variant)
    m = _jmesh(mesh)
    assert tshd.build_rules(tc, m) == jshd.build_rules(jc, m)
    assert tshd.DEFAULT_RULES == jshd.DEFAULT_RULES
    assert tshd.build_rules(tc, None) == jshd.build_rules(jc, None)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_param_specs_match_reference(arch, mesh):
    """Every leaf of the full skeleton, under the arch's rules: the port's
    spec equals the reference's ``PartitionSpec`` entry for entry, and
    the ZeRO spec of the moments too."""
    from repro.distributed import sharding as jshd
    from repro.models import api as japi
    from repro.models import param as jparam
    from repro.train import optimizer as jopt
    jc, tc = _cfgs(arch)
    m = _jmesh(mesh)
    rules = tshd.build_rules(tc, m)
    jskel, tskel = japi.skeleton(jc), tapi.skeleton(tc)
    prev = jshd._CTX.rules
    jshd._CTX.rules = dict(rules)
    try:
        want = dict(tparam.leaves(jparam.param_specs(jskel, m)))
    finally:
        jshd._CTX.rules = prev
    with tshd.use_mesh(None, rules):
        got = dict(tparam.leaves(tparam.param_specs(tskel, m)))
    assert list(got) == list(want)
    for path, spec in got.items():
        assert spec == tuple(want[path]), path
    zero = ("pod", "data")
    for path, s in tparam.leaves(tskel):
        assert topt.zero_pspec(got[path], s.shape, m, zero) == tuple(
            jopt.zero_pspec(want[path], s.shape, m, zero)), path


def test_rules_refuse_duplicates():
    from repro.distributed import sharding as jshd
    with pytest.raises(ValueError, match="duplicate sharding rule 'kv_seq'"):
        tshd._rules(("kv_seq", None), ("batch", "data"), ("kv_seq", "model"))
    with pytest.raises(ValueError, match="duplicate sharding rule 'kv_seq'"):
        jshd._rules(("kv_seq", None), ("batch", "data"), ("kv_seq", "model"))
    assert tshd._rules(("a", None), ("b", "model")) == {"a": None,
                                                        "b": "model"}


def test_resolve_spec_divisibility_and_placements(fake_mesh):
    """Axes that do not divide are dropped per dim; a tuple entry shards
    the dim on each of its mesh dims; without a mesh every entry is
    None; the shard shape divides each mapped dim."""
    from torch.distributed.tensor import Replicate, Shard
    from repro.distributed import sharding as jshd
    m = tshd.AbstractMesh({"data": 2, "model": 4})
    rules = dict(tshd.DEFAULT_RULES, batch=("data", "model"))
    for logical, shape in ((("batch", None, "mlp"), (8, 3, 12)),
                           (("batch", "vocab"), (6, 8)),
                           (("kv_heads", "q_group"), (4, 4))):
        got = tshd.resolve_spec(logical, shape, m, rules)
        want = jshd.resolve_spec(logical, shape, _jm(), rules)
        assert got == tuple(want)
    assert tshd.resolve_spec(("batch", "mlp"), (4, 4)) == (None, None)
    spec = (("data", "model"), None)
    assert tshd.placements(spec, fake_mesh) == (Shard(0), Shard(0))
    assert tshd.placements((None, "model"), fake_mesh) == (Replicate(),
                                                           Shard(1))
    assert tshd.local_shape(spec, (16, 5), fake_mesh) == (2, 5)
    x = torch.arange(16.0).reshape(8, 2)
    with tshd.use_mesh(fake_mesh):
        d = tshd.shard(x, "batch", None)
    assert d.placements == (Shard(0), Replicate())
    assert torch.equal(d.to_local(), x[:4])
    assert tshd.shard(x, "batch", None) is x


def _jm():
    from conftest import abstract_mesh
    return abstract_mesh((2, 4), ("data", "model"))


def test_throughput_budget_capacity():
    from repro.core import adaptive as jadaptive
    got = tadaptive.throughput_budget_capacity(65_536, 0.5, 4, device="cpu")
    want = np.asarray(jadaptive.throughput_budget_capacity(65_536, 0.5, 4))
    assert got.dtype == torch.int32 and got.tolist() == [8192] * 4
    np.testing.assert_array_equal(got.numpy(), want)
    assert tadaptive.throughput_budget_capacity(
        10, 0.5, 4, device="cpu").tolist() == [8] * 4


def test_attn_seq_single_block_matches_reference():
    """The sequence-parallel mode's single query block (``get_rule(
    "attn_seq")``) against the reference's under the same rules, f32,
    within the reference test's rtol 1e-4 / atol 1e-5; and the port's
    single block against its own chunked blocks."""
    import jax.numpy as jnp
    from repro import configs as jcfgs
    from repro.distributed import sharding as jshd
    from repro.models import attention as jattn
    jc = jcfgs.get_config("phi4-mini-3.8b", smoke=True).replace(
        dtype=jnp.float32)
    tc = tcfgs.get_config("phi4-mini-3.8b", smoke=True).replace(
        dtype=torch.float32)
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 96, 2, 2, 16)).astype(np.float32)
    k = rng.normal(size=(2, 96, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 96, 2, 16)).astype(np.float32)
    rules = dict(tshd.DEFAULT_RULES, attn_seq="model")
    with jshd.use_mesh(None, rules):
        want = np.asarray(jattn.chunked_causal_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jc))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with tshd.use_mesh(None, rules):
        got = tattn.chunked_causal_attention(tq, tk, tv, tc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    chunked = tattn.chunked_causal_attention(tq, tk, tv, tc)
    np.testing.assert_allclose(got.numpy(), chunked.numpy(), rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# The ZeRO state and restore on a fake mesh.
# ---------------------------------------------------------------------------

def _smoke_params(arch):
    tc = tcfgs.get_config(arch, smoke=True)
    skel = tapi.skeleton(tc)
    return tc, skel, tparam.init_params(skel, prng.PRNGKey(0), device="cpu")


def test_init_state_on_mesh_places_every_leaf(fake_mesh, tmp_path):
    """``init_state(params, mesh, skeleton=)`` and ``restore(...,
    shardings=state_shardings(...))``: every leaf's placements are those
    of the reference's specs (params by their logical axes, master and
    moments ZeRO-split), every shard the value's own slice."""
    from repro.distributed import sharding as jshd
    from repro.models import param as jparam
    from repro.train import optimizer as jopt
    tc, skel, params = _smoke_params("phi4-mini-3.8b")
    rules = tshd.build_rules(tc, fake_mesh)
    oc = topt.OptConfig()
    jm = _jm()
    prev = jshd._CTX.rules
    jshd._CTX.rules = dict(rules)
    try:
        jspecs = dict(tparam.leaves(jparam.param_specs(
            _jskel("phi4-mini-3.8b"), jm)))
    finally:
        jshd._CTX.rules = prev
    with tshd.use_mesh(fake_mesh, rules):
        psh = tparam.param_shardings(skel, fake_mesh)
        placed = tparam.map_tree(
            lambda p, t: tshd.distribute(t, dict(tparam.leaves(psh))[p]),
            params)
        state = topt.init_state(placed, fake_mesh, oc, skeleton=skel)
        shardings = topt.state_shardings(skel, fake_mesh, oc)
    for path, t in tparam.leaves(state.params):
        assert t.placements == tshd.placements(tuple(jspecs[path]),
                                               fake_mesh), path
    for path, t in tparam.leaves(state.master):
        want = tuple(jopt.zero_pspec(jspecs[path], t.shape, jm,
                                     oc.zero_axes))
        assert t.placements == tshd.placements(want, fake_mesh), path
        for tree in (state.mu, state.nu):
            assert dict(tparam.leaves(tree))[path].placements == \
                t.placements
        full = dict(tparam.leaves(params))[path].float()
        shape, off = tshd.local_shape_and_offset(t)
        want_local = full[tuple(slice(o, o + n) for o, n in zip(off, shape))]
        assert torch.equal(t.to_local(), want_local), path
    host = topt.TrainState(
        params=params,
        master=tparam.map_tree(lambda _p, t: t.float(), params),
        mu=tparam.map_tree(lambda _p, t: torch.zeros_like(t.float()),
                           params),
        nu=tparam.map_tree(lambda _p, t: torch.zeros_like(t.float()),
                           params),
        step=torch.zeros((), dtype=torch.int32))
    tckpt.save(str(tmp_path), 3, host)
    back = tckpt.restore(str(tmp_path), 3, host, shardings=shardings)
    for tree, sh in ((back.params, shardings.params),
                     (back.master, shardings.master)):
        shs = dict(tparam.leaves(sh))
        for path, t in tparam.leaves(tree):
            assert t.placements == shs[path].placements, path
    for path, t in tparam.leaves(back.master):
        assert torch.equal(t.to_local(),
                           dict(tparam.leaves(state.master))[path]
                           .to_local()), path


def _jskel(arch):
    from repro import configs as jcfgs
    from repro.models import api as japi
    return japi.skeleton(jcfgs.get_config(arch, smoke=True))


# ---------------------------------------------------------------------------
# Compression in gloo ranks against the reference's collectives.
# ---------------------------------------------------------------------------

def _inputs(world, seed=0):
    """Per-rank f32 leaves on a 1/8 grid in [-8, 8]: any sum of four is
    exact in bf16, so the sum's order cannot change a bit."""
    rng = np.random.default_rng(seed)
    return {"a": (rng.integers(-64, 65, (world, 6, 5)) / 8.0).astype(
                np.float32),
            "b": [(rng.integers(-24, 25, (world, 7)) / 4.0 + 1 / 32).astype(
                np.float32)]}


def _rank_compress(rank, world, init, inputs, out_dir):
    tdist.init_process_group(
        "gloo", init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        x = {"a": torch.from_numpy(inputs["a"][rank]),
             "b": [torch.from_numpy(inputs["b"][0][rank])]}
        g = tdist.group.WORLD
        out = {"bf16": tcomp.psum_bf16(x, g), "int8": tcomp.psum_int8(x, g),
               "full": tcomp.psum(x, g)}
        if world == 4:
            from torch.distributed.device_mesh import DeviceMesh
            mesh = DeviceMesh("cpu", torch.arange(4).view(2, 2),
                              mesh_dim_names=("pod", "data"))
            for kind in ("int8", "bf16", "none"):
                out[f"hier_{kind}"] = tcomp.hierarchical_grad_sync(
                    x, mesh, cross_pod=kind)
        assert torch.equal(x["a"], torch.from_numpy(inputs["a"][rank]))
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        tdist.destroy_process_group()


def _reference(inputs, world):
    """The reference's functions in ``jax.vmap`` over named axes (one
    device), as ``shard_map`` runs them per device; one rank's result."""
    import jax
    import jax.numpy as jnp
    from repro.distributed import compression as jcomp
    x = {"a": jnp.asarray(inputs["a"]), "b": [jnp.asarray(inputs["b"][0])]}
    out = {}
    for kind, fn in (("bf16", jcomp.psum_bf16), ("int8", jcomp.psum_int8),
                     ("full", jax.lax.psum)):
        got = jax.vmap(lambda t, fn=fn: fn(t, "r"), axis_name="r")(x)
        out[kind] = jax.tree.map(lambda t: np.asarray(t[0]), got)
    if world == 4:
        xs = jax.tree.map(lambda t: t.reshape((2, 2) + t.shape[1:]), x)
        for kind in ("int8", "bf16", "none"):
            f = jax.vmap(jax.vmap(
                lambda t, kind=kind: jcomp.hierarchical_grad_sync(
                    t, "data", "pod", kind), axis_name="data"),
                axis_name="pod")
            out[f"hier_{kind}"] = jax.tree.map(
                lambda t: np.asarray(t[0, 0]), f(xs))
    return out


@pytest.mark.parametrize("world", [1, 4])
def test_compression_matches_reference(world, tmp_path):
    """bf16 and full sums bit for bit the reference's; int8 bit for bit
    too, and within half a quantum per rank (the group's max / 127 / 2
    each) of the exact float64 sum."""
    inputs = _inputs(world)
    init = f"file://{tmp_path}/pg"
    ctx = mp.start_processes(_rank_compress,
                             args=(world, init, inputs, str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    import time
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks not done in {JOIN_TIMEOUT_S} s")
    want = _reference(inputs, world)
    outs = [torch.load(f"{tmp_path}/rank{r}.pt") for r in range(world)]
    for kind, ref in want.items():
        for r, out in enumerate(outs):
            got = out[kind]
            np.testing.assert_array_equal(got["a"].numpy(), ref["a"])
            np.testing.assert_array_equal(got["b"][0].numpy(), ref["b"][0])
    for leaf in ("a", "b"):
        stack = inputs[leaf] if leaf == "a" else inputs["b"][0]
        exact = stack.astype(np.float64).sum(0)
        quantum = np.abs(stack).max() / 127.0
        got = outs[0]["int8"][leaf]
        got = (got if leaf == "a" else got[0]).numpy()
        assert np.abs(got - exact).max() <= world * quantum / 2 * (1 + 1e-6)


def test_meshes_need_their_process_group():
    """The production and smoke meshes take the default group as it is and
    refuse, with the recipe, a group of another size or none; the fake
    group refuses to replace a live one and is gone after its block."""
    with pytest.raises(ValueError, match="no initialized process group"):
        tmesh.make_production_mesh(device_type="cpu")
    with tmesh.fake_group(8):
        with pytest.raises(ValueError, match="world_size=256"):
            tmesh.make_production_mesh(device_type="cpu")
        with pytest.raises(RuntimeError, match="already initialized"):
            with tmesh.fake_group(8):
                pass
    with tmesh.fake_group(1):
        m = tmesh.make_smoke_mesh(device_type="cpu")
        assert m.mesh_dim_names == ("data", "model") and m.shape == (1, 1)
    with tmesh.fake_group(512):
        m = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
        assert m.mesh_dim_names == ("pod", "data", "model")
        assert tshd.axis_sizes(m) == {"pod": 2, "data": 16, "model": 16}
    assert not tdist.is_initialized()
