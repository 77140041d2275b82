"""``core/distributed.py`` of the port against the reference's, on the CPU.

The reference's merges run under ``jax.vmap(axis_name="shard")`` over
four shards' stacked inputs; the port's run in four gloo ranks (one
``torch.multiprocessing`` spawn for the whole file, a ``file://``
rendezvous, no ports). The ranks import torch and the port only: this
module imports JAX inside the parent's functions, never at its top.

Bitwise: ``split_capacity``, ``gather_cells`` (integer words above
``2**24`` and ``2**31`` included) and the collective counts (each merge
one all_reduce, each gather one all_gather). Within rtol: the merged
estimates, whose sums the two packages' collectives order differently.
"""
import datetime
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from repro_torch import prng
from repro_torch.core import distributed as dist
from repro_torch.core import error as terr
from repro_torch.core import quantile as tqt

W, G, N = 4, 6, 16
ALIVE = (1.0, 0.0, 1.0, 1.0)
EDGES = (0.0, 50.0, 100.0, 150.0, 400.0)
KEYS = (60.0, 80.0, 100.0, 120.0)
QS = (0.1, 0.5, 0.9)
VALUE_RANGE = (0.0, 200.0)
BINS = 64
REPLICATES = 4
BOOT_SEED = 5
#: Limits of one spawn: the group's timeout and the parent's wait.
PG_TIMEOUT_S, JOIN_TIMEOUT_S = 60, 120


def shard_inputs(seed=0):
    """numpy per-shard inputs, stacked on a leading ``[W]`` axis: a
    sample view of ``G`` cells, its stats, and aux words."""
    rng = np.random.default_rng(seed)
    values = np.round(rng.normal(100.0, 30.0, (W, G, N)) / 20.0) * 20.0
    counts = rng.integers(0, 40, (W, G)).astype(np.int32)
    taken = np.minimum(counts, N).astype(np.int32)
    valid = np.arange(N)[None, None, :] < taken[:, :, None]
    v = np.where(valid, values, 0.0)
    aux = (np.array([1, 2 ** 24 + 1, 2 ** 31 + 5, 2 ** 32 - 1, 7],
                    np.uint64)[None, :]
           + np.arange(W, dtype=np.uint64)[:, None]) % 2 ** 32
    return dict(values=values.astype(np.float32), counts=counts,
                taken=taken, sums=v.sum(-1).astype(np.float32),
                sumsqs=(v * v).sum(-1).astype(np.float32),
                aux=aux.astype(np.uint32))


def spawn_ranks(fn, args, tmp_path, nprocs=W, timeout_s=JOIN_TIMEOUT_S):
    """Run ``fn(rank, nprocs, init_method, *args)`` in ``nprocs`` spawned
    processes with a ``file://`` rendezvous under ``tmp_path``; fails the
    test (and stops the ranks) if they are not done within
    ``timeout_s``."""
    init = f"file://{tmp_path}/pg"
    ctx = mp.start_processes(fn, args=(nprocs, init) + tuple(args),
                             nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{nprocs} ranks not done in {timeout_s} s")


def init_group(rank, world, init):
    tdist.init_process_group(
        "gloo", init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))


def _rank_merges(rank, world, init, inputs, out_dir):
    """One rank: every merge over its shard's inputs, with the
    collectives each performed."""
    init_group(rank, world, init)
    x = {k: torch.from_numpy(np.ascontiguousarray(v[rank]))
         for k, v in inputs.items()}
    view = tqt.SampleView(values=x["values"], counts=x["counts"],
                          taken=x["taken"])
    stats = terr.StratumStats(counts=x["counts"], taken=x["taken"],
                              sums=x["sums"], sumsqs=x["sumsqs"])
    alive = torch.tensor(ALIVE[rank])
    edges = torch.tensor(EDGES)
    keys = torch.tensor(KEYS)
    key = prng.PRNGKey(BOOT_SEED)
    ops = {
        "sum": lambda: dist.global_sum(stats),
        "sum_alive": lambda: dist.global_sum(stats, alive=alive),
        "mean": lambda: dist.global_mean(stats),
        "mean_alive": lambda: dist.global_mean(stats, alive=alive),
        "histogram": lambda: dist.global_histogram(view, edges),
        "histogram_alive": lambda: dist.global_histogram(view, edges,
                                                         alive=alive),
        "key_counts": lambda: dist.global_key_counts(view, keys),
        "key_counts_alive": lambda: dist.global_key_counts(view, keys,
                                                           alive=alive),
        "quantile": lambda: dist.global_quantile(view, QS, VALUE_RANGE,
                                                 num_bins=BINS),
        "quantile_boot": lambda: dist.global_quantile(
            view, QS, VALUE_RANGE, num_bins=BINS,
            num_replicates=REPLICATES, key=key),
        "sts_counts": lambda: dist.sts_global_counts(x["counts"]),
        "gather": lambda: dist.gather_cells(view, x["aux"].to(torch.int64),
                                            num_shards=world),
    }
    out = {}
    for name, op in ops.items():
        dist.reset_collective_counts()
        r = op()
        counts = dist.collective_counts()
        if isinstance(r, terr.Estimate):
            arrays = {"value": r.value.numpy(), "variance": r.variance.numpy()}
        elif isinstance(r, tuple):
            merged, aux_all = r
            arrays = {"values": merged.values.numpy(),
                      "counts": merged.counts.numpy(),
                      "taken": merged.taken.numpy(),
                      "aux": aux_all.numpy()}
        else:
            arrays = {"value": r.numpy()}
        out[name] = (arrays, counts)
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    tdist.destroy_process_group()


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    """Every rank's merges (one spawn for the file)."""
    tmp = tmp_path_factory.mktemp("distributed")
    spawn_ranks(_rank_merges, (shard_inputs(), str(tmp)), tmp)
    out = []
    for r in range(W):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def reference_results():
    """The reference's merges of the same inputs under ``jax.vmap``."""
    import jax
    import jax.numpy as jnp
    from repro.core import distributed as jdist
    from repro.core import error as jerr
    from repro.core import quantile as jqt
    x = {k: jnp.asarray(v) for k, v in shard_inputs().items()}
    alive = jnp.asarray(ALIVE, jnp.float32)
    edges, keys = jnp.asarray(EDGES), jnp.asarray(KEYS)
    key = jax.random.PRNGKey(BOOT_SEED)

    def per_shard(fn):
        def body(values, counts, taken, sums, sumsqs, aux, a):
            view = jqt.SampleView(values=values, counts=counts, taken=taken)
            stats = jerr.StratumStats(counts=counts, taken=taken, sums=sums,
                                      sumsqs=sumsqs)
            return fn(view, stats, aux, a)
        return jax.vmap(body, axis_name="shard")(
            x["values"], x["counts"], x["taken"], x["sums"], x["sumsqs"],
            x["aux"], alive)

    ops = {
        "sum": lambda v, s, x_, a: jdist.global_sum(s, "shard"),
        "sum_alive": lambda v, s, x_, a: jdist.global_sum(s, "shard", a),
        "mean": lambda v, s, x_, a: jdist.global_mean(s, "shard"),
        "mean_alive": lambda v, s, x_, a: jdist.global_mean(s, "shard", a),
        "histogram": lambda v, s, x_, a: jdist.global_histogram(
            v, edges, "shard"),
        "histogram_alive": lambda v, s, x_, a: jdist.global_histogram(
            v, edges, "shard", a),
        "key_counts": lambda v, s, x_, a: jdist.global_key_counts(
            v, keys, "shard"),
        "key_counts_alive": lambda v, s, x_, a: jdist.global_key_counts(
            v, keys, "shard", a),
        "quantile": lambda v, s, x_, a: jdist.global_quantile(
            v, QS, VALUE_RANGE, "shard", num_bins=BINS),
        "quantile_boot": lambda v, s, x_, a: jdist.global_quantile(
            v, QS, VALUE_RANGE, "shard", num_bins=BINS,
            num_replicates=REPLICATES, key=key),
        "sts_counts": lambda v, s, x_, a: jdist.sts_global_counts(
            s.counts, "shard"),
        "gather": lambda v, s, x_, a: jdist.gather_cells(v, x_, "shard", W),
    }
    out = {}
    for name, fn in ops.items():
        r = per_shard(fn)
        if isinstance(r, jerr.Estimate):
            # Replicated: every shard's row is the merged answer.
            out[name] = {"value": np.asarray(r.value)[0],
                         "variance": np.asarray(r.variance)[0]}
        elif isinstance(r, tuple):
            merged, aux_all = r
            out[name] = {"values": np.asarray(merged.values)[0],
                         "counts": np.asarray(merged.counts)[0],
                         "taken": np.asarray(merged.taken)[0],
                         "aux": np.asarray(aux_all)[0].astype(np.int64)}
        else:
            out[name] = {"value": np.asarray(r)[0]}
    return out


@pytest.mark.parametrize("capacity", [0, 1, 2, 3, 4, 5, 7, 8, 17, 1000,
                                      262_144, 1_048_576, 2 ** 31 - 8])
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_split_capacity_matches_reference(capacity, shards):
    """The ceil split, clamped to at least 1, as the reference's."""
    import jax.numpy as jnp
    from repro.core import distributed as jdist
    caps = np.array([capacity, max(capacity - 1, 0), 1], np.int32)
    want = np.asarray(jdist.split_capacity(jnp.asarray(caps), shards))
    got = dist.split_capacity(torch.from_numpy(caps), shards)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got >= 1).all()
    assert (got.long() * shards >= torch.from_numpy(caps)).all()


MERGES = ("sum", "sum_alive", "mean", "mean_alive", "histogram",
          "histogram_alive", "key_counts", "key_counts_alive", "quantile",
          "quantile_boot", "sts_counts")


@pytest.mark.parametrize("name", MERGES)
def test_global_merges_match_reference(name, rank_results,
                                       reference_results):
    """Every rank gets the same merged answer, which is the reference's
    within rtol (counts exactly)."""
    mine = rank_results[0][name][0]
    for other in rank_results[1:]:
        for k, a in other[name][0].items():
            assert a.tobytes() == mine[k].tobytes(), (name, k)
    want = reference_results[name]
    assert mine.keys() == want.keys()
    for k in want:
        a, b = np.asarray(mine[k]), np.asarray(want[k])
        assert a.shape == b.shape, (name, k)
        if name == "sts_counts":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name}.{k}")


def test_straggler_inflates_the_survivors(rank_results):
    """``alive = 0`` on one of four shards: the estimate is the three
    survivors' partials times 4/3, the variance times (4/3)²."""
    full = rank_results[0]["sum"][0]
    part = rank_results[0]["sum_alive"][0]
    assert float(part["value"]) != float(full["value"])
    inputs = shard_inputs()
    est = [terr.estimate_sum(terr.StratumStats(
        **{f: torch.from_numpy(inputs[f][w]) for f in
           ("counts", "taken", "sums", "sumsqs")})) for w in range(W)]
    survivors = sum(float(e.value) for e, a in zip(est, ALIVE) if a)
    np.testing.assert_allclose(float(part["value"]), survivors * 4 / 3,
                               rtol=1e-5)


def test_gather_cells_bitwise(rank_results, reference_results):
    """The merged view is the ranks' views concatenated in rank order,
    bit for bit, and the aux words arrive exact (above ``2**24`` and
    ``2**31`` too): the same as the reference's tiled all_gather."""
    inputs = shard_inputs()
    got = rank_results[0]["gather"][0]
    want = reference_results["gather"]
    for k in ("values", "counts", "taken", "aux"):
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert got["values"].tobytes() == \
        inputs["values"].reshape(W * G, N).tobytes()
    np.testing.assert_array_equal(got["aux"],
                                  inputs["aux"].astype(np.int64))
    assert got["aux"].max() > 2 ** 31


@pytest.mark.parametrize("name", MERGES + ("gather",))
def test_one_collective_per_merge(name, rank_results):
    """Each merge packs its tuple into one buffer: one all_reduce; the
    emission's gather is one all_gather."""
    want = ({"all_reduce": 0, "all_gather": 1} if name == "gather"
            else {"all_reduce": 1, "all_gather": 0})
    for r in range(W):
        assert rank_results[r][name][1] == want, (r, name)


def test_local_update_performs_no_collective():
    """The ingest contract: a local fold, with no process group at all."""
    from repro_torch.core import oasrs
    dist.reset_collective_counts()
    st = oasrs.init(3, 4, prng.PRNGKey(0), device="cpu")
    sid = torch.tensor([0, 1, 2, 0, 0, 0, 0, 1], dtype=torch.int32)
    st = dist.local_update(st, sid, torch.arange(8, dtype=torch.float32))
    assert st.counts.tolist() == [5, 2, 1]
    assert dist.collective_counts() == {"all_reduce": 0, "all_gather": 0}


@pytest.mark.parametrize("route", ["all_gather_single",
                                   "all_gather_into_tensor"])
def test_all_gather_takes_either_torch_name(route, tmp_path, monkeypatch):
    """The gather runs on a torch that has ``all_gather_single`` (2.13)
    and on one that has only ``all_gather_into_tensor`` (2.11): a
    one-rank gloo group in this process, words above ``2**24`` kept."""
    if route == "all_gather_into_tensor":
        monkeypatch.delattr(tdist, "all_gather_single", raising=False)
    init_group(0, 1, f"file://{tmp_path}/pg")
    try:
        dist.reset_collective_counts()
        buf = torch.tensor([[1, 2 ** 24 + 1, -7]], dtype=torch.int32).view(
            torch.float32)
        out = dist._all_gather(buf)
        assert torch.equal(out.view(torch.int32), buf.view(torch.int32))
        assert dist.collective_counts() == {"all_reduce": 0,
                                            "all_gather": 1}
    finally:
        tdist.destroy_process_group()
