"""``placement="mesh"`` of the port: four gloo ranks against the vmap
oracle, on the CPU.

One ``torch.multiprocessing`` spawn for the file runs four ranks
(``test_torch_distributed.spawn_ranks``: a ``file://`` rendezvous, a
60 s group timeout, a bounded join). Rank ``r`` holds shard ``r``;
every push hands it the full ``[W, M]`` chunk. The parent makes the
chunks, runs the reference's vmap executors and the port's, and passes
numpy arrays; the ranks import torch and the port only (this module
imports JAX inside the parent's functions).

Four configurations: pipelined on cadence (fused), pipelined on the
watermark over a disordered stream (onekernel), batched on cadence over
a disordered stream (fused), batched on the watermark (onekernel). The
mesh's emissions are the port's vmap emissions bit for bit (every field
but the wall-clock latency, every answer and width), the ranks' shards
stacked are the vmap state bit for bit, and both are the reference's
vmap oracle's: emission fields, Σ capacity and state bitwise, answers
within ``test_torch_runtime``'s rtol. The collective counter: no
collective while ingesting, one all_gather per emission, per ad hoc
``query()`` and per snapshot.
"""
import pickle

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core import distributed as dist
from repro_torch.launch import mesh as lmesh
from repro_torch.runtime import checkpoint as ckp
from repro_torch.runtime import convert
from repro_torch.runtime import executor as tex
from repro_torch.runtime import registry as treg
from repro_torch.runtime.records import TimestampedChunk
from test_torch_distributed import init_group, spawn_ranks

W = 4
SEED = 7
#: name -> (executor, ingest, emission, disorder)
CONFIGS = {
    "pipelined-cadence": ("pipelined", "fused", "cadence", 0.0),
    "pipelined-watermark": ("pipelined", "onekernel", "watermark", 0.3),
    "batched-cadence": ("batched", "fused", "cadence", 0.3),
    "batched-watermark": ("batched", "onekernel", "watermark", 0.0),
}


def _big(x):
    return x > 500.0


def registry(module=treg):
    """Linear kinds, a quantile and the per-key and session windows,
    which read the mesh's gathered slot tables and activity."""
    return (module.QueryRegistry().register("total", "sum")
            .register("avg", "mean")
            .register("big", "count", predicate=_big)
            .register("p", "quantile", qs=(0.5, 0.9), num_replicates=4)
            .register("bykey", "sum", window="per_key")
            .register("sess", "sum", window="session", session_gap=0.75))


def config_kw(name, placement="mesh"):
    _, ingest, emission, _ = CONFIGS[name]
    return dict(num_strata=3, capacity=16, num_intervals=3,
                interval_span=1.0, allowed_lateness=0.5, emit_every=3,
                batch_chunks=3, num_shards=W, placement=placement,
                ingest=ingest, emission=emission)


def executor(name, placement="mesh", device="cpu", **kw):
    cls = tex.PipelinedExecutor if CONFIGS[name][0] == "pipelined" else \
        tex.BatchedExecutor
    return cls(tex.RuntimeConfig(**config_kw(name, placement)), registry(),
               prng.PRNGKey(SEED), device=device, **kw)


def emission_bits(em) -> tuple:
    """Every field of an emission but the wall-clock latency, answers and
    95% widths as bytes."""
    res = {}
    for name, r in convert.results_to_numpy(em.results).items():
        res[name] = {f: a.tobytes() for f, a in r.items()}
        res[name]["hw95"] = np.asarray(
            2.0 * np.sqrt(np.maximum(r["variance"], 0.0)),
            np.float32).tobytes()
    return (em.index, em.interval, em.watermark, em.open_interval,
            em.on_time, em.late, em.dropped, em.items,
            np.asarray(em.capacity).tolist(), res)


def _torch_chunks(chunks):
    return [TimestampedChunk(*(torch.from_numpy(a) for a in c))
            for c in chunks]


def _rank_main(rank, world, init, streams, out_dir):
    """One rank: the four configurations, the ad hoc query, the ingest's
    collectives, and the refusals that need a process group."""
    init_group(rank, world, init)
    out = {"runs": {}}
    for name, chunks in streams.items():
        ex = executor(name)
        dist.reset_collective_counts()
        ems = ex.run(_torch_chunks(chunks))
        counts = dist.collective_counts()
        dist.reset_collective_counts()
        query = convert.results_to_numpy(ex.query())
        out["runs"][name] = dict(
            emissions=[emission_bits(e) for e in ems],
            state=convert.state_to_numpy(ex.state), counts=counts,
            query=query, query_counts=dist.collective_counts())
    # The ingest alone: pushes between emissions perform no collective.
    name = "pipelined-cadence"
    ex = executor(name)
    chunks = _torch_chunks(streams[name])
    dist.reset_collective_counts()
    for c in chunks[:2]:
        ex.push(c)
    out["ingest_counts"] = dist.collective_counts()
    dist.reset_collective_counts()
    snap = ex.snapshot()
    out["snapshot"] = dict(
        offset=snap.stream_offset, counts=dist.collective_counts(),
        shape=snap.state.window.intervals.values.shape,
        payload=ckp.to_bytes(snap))
    errors = {}
    try:
        tex.PipelinedExecutor(
            tex.RuntimeConfig(**dict(config_kw(name), num_shards=2)),
            registry(), prng.PRNGKey(SEED), device="cpu")
    except ValueError as e:
        errors["world_size"] = str(e)
    out["errors"] = errors
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def _streams():
    from test_torch_sharded import sharded_chunks
    return {name: sharded_chunks(11 + i, 12, W, m=48, disorder=d)
            for i, (name, (_, _, _, d)) in enumerate(CONFIGS.items())}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    spawn_ranks(_rank_main, (_streams(), str(tmp)), tmp)
    out = []
    for r in range(W):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def oracle():
    """Per configuration: the port's vmap run (emission bits, state) and
    the reference's vmap executor and emissions."""
    import jax
    from repro.runtime import executor as jex
    from repro.runtime import registry as jreg
    from test_torch_runtime import _jchunk
    out = {}
    for name, chunks in _streams().items():
        ex = executor(name, placement="vmap")
        ems = ex.run(_torch_chunks(chunks))
        jcls = jex.PipelinedExecutor if CONFIGS[name][0] == "pipelined" \
            else jex.BatchedExecutor
        je = jcls(jex.RuntimeConfig(**config_kw(name, "vmap")),
                  registry(jreg), jax.random.PRNGKey(SEED))
        jems = je.run(_jchunk(c) for c in chunks)
        out[name] = dict(ex=ex, emissions=ems, state=ex.state,
                         query=ex.query(), jex=je, jems=jems,
                         jquery=je.query())
    return out


def _stacked(states):
    """The ranks' ``[1]``-leading states stacked into one ``[W]`` state
    dict."""
    def walk(parts):
        if isinstance(parts[0], dict):
            return {k: walk([p[k] for p in parts]) for k in parts[0]}
        return np.concatenate(parts)
    return walk(states)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mesh_emissions_are_the_vmap_oracles(name, ranks, oracle):
    want = [emission_bits(e) for e in oracle[name]["emissions"]]
    assert len(want) >= 2
    for r in range(W):
        assert ranks[r]["runs"][name]["emissions"] == want, r
    if CONFIGS[name][2] == "watermark":
        assert [e[1] for e in want] == list(range(len(want)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mesh_state_is_the_vmap_oracles(name, ranks, oracle):
    """Rank ``r`` holds shard ``r``: the ranks' states stacked are the
    vmap state, every leaf bit for bit (but the wall-clock EMA)."""
    got = _stacked([ranks[r]["runs"][name]["state"] for r in range(W)])
    want = convert.state_to_numpy(oracle[name]["state"])
    for leaf in ("latency_ema", "pressure"):
        got["ctrl"].pop(leaf), want["ctrl"].pop(leaf)
    np.testing.assert_equal(got, want)
    assert got["window"]["intervals"]["values"].shape[0] == W


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_vmap_oracle_is_the_references(name, oracle):
    """The oracle the mesh is held to is the reference's vmap run:
    emissions (integer fields, watermark, Σ capacity bitwise, answers
    within rtol), final state bit for bit."""
    from test_torch_registry import assert_results_close
    from test_torch_runtime import _assert_state_bitwise
    o = oracle[name]
    assert len(o["jems"]) == len(o["emissions"]) > 0
    for a, b in zip(o["jems"], o["emissions"]):
        for f in ("index", "interval", "watermark", "open_interval",
                  "on_time", "late", "dropped", "items"):
            assert getattr(a, f) == getattr(b, f), (a.index, f)
        np.testing.assert_array_equal(a.capacity, b.capacity)
        assert_results_close(a.results, b.results)
    _assert_state_bitwise(o["jex"].state, o["ex"].state)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mesh_query_is_the_vmap_oracles(name, ranks, oracle):
    """An ad hoc ``query()`` on every rank: the vmap answer bit for bit
    (the reference's within rtol), with one all_gather."""
    want = convert.results_to_numpy(oracle[name]["query"])
    jwant = convert.results_to_numpy(oracle[name]["jquery"])
    for r in range(W):
        run = ranks[r]["runs"][name]
        assert run["query_counts"] == {"all_reduce": 0, "all_gather": 1}
        got = run["query"]
        assert got.keys() == want.keys()
        for q in want:
            for f in want[q]:
                assert got[q][f].tobytes() == want[q][f].tobytes(), (q, f)
    for q in ("total", "avg", "big"):
        np.testing.assert_allclose(want[q]["value"], jwant[q]["value"],
                                   rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_one_all_gather_per_emission(name, ranks):
    for r in range(W):
        run = ranks[r]["runs"][name]
        assert run["counts"] == {"all_reduce": 0,
                                 "all_gather": len(run["emissions"])}


def test_mesh_ingest_is_collective_free(ranks):
    for r in range(W):
        assert ranks[r]["ingest_counts"] == {"all_reduce": 0,
                                             "all_gather": 0}


def test_mesh_refusals_inside_a_group(ranks):
    """A group of 4 ranks refuses ``num_shards=2`` with the recipe; a mesh
    executor's snapshot is no longer refused: every rank gets the same
    ``[W]``-leading payload, with one all_gather."""
    for r in range(W):
        errors = ranks[r]["errors"]
        assert "has 4 ranks" in errors["world_size"]
        assert "init_process_group" in errors["world_size"]
        snap = ranks[r]["snapshot"]
        assert snap["offset"] == 2 and snap["shape"][0] == W
        assert snap["counts"] == {"all_reduce": 0, "all_gather": 1}
        assert snap["payload"] == ranks[0]["snapshot"]["payload"]


def test_mesh_placement_validation():
    """Refused before any process group is needed: a mesh of one shard,
    an unknown placement; and a mesh with no initialized group names the
    recipe, with or without a checkpointer (which the mesh takes)."""
    with pytest.raises(ValueError, match="num_shards > 1"):
        tex.PipelinedExecutor(tex.RuntimeConfig(
            num_strata=3, capacity=8, placement="mesh"), registry(),
            prng.PRNGKey(0), device="cpu")
    with pytest.raises(ValueError, match="placement"):
        tex.PipelinedExecutor(tex.RuntimeConfig(
            num_strata=3, capacity=8, num_shards=2, placement="spmd"),
            registry(), prng.PRNGKey(0), device="cpu")
    with pytest.raises(ValueError, match="init_process_group"):
        executor("pipelined-cadence",
                 checkpointer=ckp.Checkpointer(every_chunks=2))
    with pytest.raises(ValueError, match="init_process_group"):
        executor("pipelined-cadence")
    with pytest.raises(ValueError, match=">= 1"):
        lmesh.make_stream_mesh(0)
