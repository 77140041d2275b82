"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
False. This file imports neither JAX nor the reference package, so it
runs on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda.py

It also holds the numpy input makers that ``test_torch_kernels.py``
shares.
"""
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.kernels import ops, ref, reservoir, stratified_stats
from repro_torch.runtime import convert
from repro_torch.runtime import executor as tex
from repro_torch.runtime import registry as treg
from repro_torch.runtime.records import TimestampedChunk

#: phase -> (initial counts, capacity) for S = 4 strata, N_max = 64.
PHASES = {
    "filling": ([0, 0, 0, 0], [64, 32, 16, 8]),
    "crossing": ([10, 30, 14, 0], [16, 32, 16, 8]),
    "replacement": ([100, 400, 70, 9], [16, 64, 5, 8]),
}


def fold_inputs(seed, m, counts, capacity, mask_p=0.9, s=4, n_max=64):
    """numpy inputs of one fold: a chunk, counts, capacity and a ring."""
    rng = np.random.default_rng(seed)
    return dict(
        stratum_ids=rng.integers(0, s, m).astype(np.int32),
        payload=rng.normal(100.0, 30.0, m).astype(np.float32),
        u_accept=rng.random(m, dtype=np.float32),
        u_slot=rng.random(m, dtype=np.float32),
        mask=rng.random(m) < mask_p,
        counts=np.asarray(counts, np.int32),
        capacity=np.asarray(capacity, np.int32),
        values=rng.normal(0.0, 1.0, (s, n_max)).astype(np.float32))


def stats_inputs(seed, m, s=4, mask_p=0.8):
    """numpy ``(values, stratum_ids, mask)`` of one stats pass."""
    rng = np.random.default_rng(seed)
    sid = rng.integers(0, s, m).astype(np.int32)
    mus = np.array([10.0, 1000.0, 50.0, 300.0], np.float32)[:s]
    vals = (mus[sid] * (1.0 + 0.1 * rng.standard_normal(m))).astype(
        np.float32)
    return vals, sid, rng.random(m) < mask_p


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py covers "
                    "the kernels on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("phase", sorted(PHASES))
@pytest.mark.parametrize("m,mask_p", [(256, 0.9), (300, 0.9), (300, 0.0)])
def test_cuda_fold_matches_plain(cuda_device, phase, m, mask_p):
    inp = {k: torch.from_numpy(np.array(v)).to(cuda_device)
           for k, v in fold_inputs(7, m, *PHASES[phase],
                                   mask_p=mask_p).items()}
    ring_k, ring_p = inp["values"].clone(), inp.pop("values")
    before = reservoir.reservoir_fold.launches
    ck = reservoir.reservoir_fold(values=ring_k, **inp)
    cp = ref.reservoir_fold(values=ring_p, **inp)
    assert reservoir.reservoir_fold.launches == before + 1
    assert torch.equal(ring_k.view(torch.int32), ring_p.view(torch.int32))
    assert torch.equal(ck, cp)


@pytest.mark.cuda
@pytest.mark.parametrize("m,mask_p", [(1024, 0.8), (1000, 0.8), (0, 1.0)])
def test_cuda_stats_matches_plain(cuda_device, m, mask_p):
    vals, sid, mask = (torch.from_numpy(a).to(cuda_device)
                       for a in stats_inputs(9, m, mask_p=mask_p))
    kc, ks, kq = stratified_stats.stratified_stats(vals, sid, mask, 4)
    pc, ps, pq = ref.stratified_stats(vals, sid, mask, 4)
    assert torch.equal(kc, pc)
    torch.testing.assert_close(ks, ps, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(kq, pq, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
def test_cuda_executor_matches_cpu_executor(cuda_device):
    """The whole pipelined path on the card (through both kernels) and on
    the CPU (plain versions): the same state bit for bit, the same
    answers within rtol."""
    rng = np.random.default_rng(4)
    cfg = tex.RuntimeConfig(num_strata=3, capacity=16, num_intervals=3,
                            interval_span=1.0, allowed_lateness=0.5,
                            emit_every=4, max_capacity=32)
    chunks = []
    for e in range(12):
        sid = rng.integers(0, 3, 256).astype(np.int32)
        vals = (np.array([10.0, 100.0, 1000.0])[sid]
                * (1 + 0.2 * rng.standard_normal(256))).astype(np.float32)
        t = ((e * 256 + np.arange(256)) / 1024.0
             - (rng.random(256) < 0.3) * rng.random(256)).clip(0)
        chunks.append((vals, sid, t.astype(np.float32),
                       rng.random(256) > 0.05))
    runs = {}
    ops.reset_launch_counts()
    for dev in ("cpu", cuda_device):
        reg = (treg.QueryRegistry().register("total", "sum")
               .register("avg", "mean")
               .register("big", "count", predicate=lambda x: x > 500.0))
        ex = tex.PipelinedExecutor(cfg, reg, prng.PRNGKey(3), device=dev)
        for c in chunks:
            ex.push(TimestampedChunk(*(torch.from_numpy(a).to(dev)
                                       for a in c)))
        runs[str(dev)] = (ex.finalize(), convert.state_to_numpy(ex.state))
    assert ops.launch_counts() == {"reservoir_fold": 12,
                                   "stratified_stats": 6}
    (ce, cs), (ge, gs) = runs["cpu"], runs[str(cuda_device)]
    for part in ("window", "slot_interval", "open_interval", "wm",
                 "metrics"):
        np.testing.assert_equal(gs[part], cs[part])
    for a, b in zip(ce, ge):
        assert (a.index, a.on_time, a.late, a.dropped) == \
            (b.index, b.on_time, b.late, b.dropped)
        for name in a.results:
            np.testing.assert_allclose(float(b.results[name].value),
                                       float(a.results[name].value),
                                       rtol=1e-5)
