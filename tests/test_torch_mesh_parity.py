"""The port's programs on a real (2, 2) ``data × model`` mesh against the
same calls with no mesh, on the CPU.

Four spawned gloo ranks (one spawn for the whole file) place the params
by their logical axes (``param_shardings``), the batch by
``shard_batch`` and the optimizer state by ``init_state``'s ZeRO specs,
and run, under the arch's rules: the loss and its grads, prefill, three
decode steps and one ``apply_updates``. Every output is gathered whole
and held, in f32, against the same calls in the parent with no mesh.
This runs each place the port computes on a rank's own shards with real
values: the vocab-parallel lookup and cross entropy, the per-rank
products and attention blocks (heads, query groups, and the query
sequence in the ``attn_seq`` mode), flash-decode over a sequence-sharded
cache and the writes into it, the MoE dispatch and experts, the
RG-LRU and xLSTM scans, and the ZeRO AdamW.

Tolerance, per field (loss, grads, logits, moments ...): the largest
difference at most ``RTOL`` times the field's largest magnitude. The
two runs sum in different orders (all-reduces over ranks, per-rank
partial products), which moves f32 results by ~1e-6 of their scale. The
optimizer's ``eps`` is 1e-3 here: with the default 1e-8 a grad near
zero makes ``g / sqrt(nu)`` a sign, so one rounding of a ~1e-9 grad
moves its param by a whole step.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro_torch import configs as tcfgs
from repro_torch import prng
from repro_torch.distributed import sharding as tshd
from repro_torch.models import api as tapi
from repro_torch.models import param as tparam
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from test_torch_distributed import init_group, spawn_ranks

#: ``case → (arch, overrides, sequence length)``, at the smoke configs
#: in f32. The attention modes on ``model = 2``: phi4-mini and the MoE
#: shard KV heads; ``attn_seq`` (3 heads, 1 KV head) shards the query
#: sequence and ``kv_seq`` (granite-34b, 4 query heads per KV head) the
#: query groups, both with the decode cache's sequence over ``model``.
CASES = {
    "phi4": ("phi4-mini-3.8b", {}, 64),
    "granite-moe": ("granite-moe-3b-a800m", {}, 64),
    "attn_seq": ("phi4-mini-3.8b", {"num_heads": 3, "num_kv_heads": 1}, 64),
    "kv_seq": ("granite-34b", {}, 64),
    "hybrid": ("recurrentgemma-9b", {}, 32),
    "ssm": ("xlstm-350m", {}, 32),
    "encdec": ("seamless-m4t-large-v2", {}, 32),
    "vlm": ("internvl2-76b", {}, 64),
}
#: The cache dim each case's rules shard over ``model`` (``[L, B, S, Hkv,
#: hd]``: 2 the sequence, 3 the heads).
CACHE_MODEL_DIM = {"phi4": 3, "granite-moe": 3, "attn_seq": 2, "kv_seq": 2,
                   "vlm": 3}
BATCH, STEPS, RTOL = 4, 3, 2e-5
OPT = topt.OptConfig(warmup_steps=1, eps=1e-3)
TIMEOUT_S = 300


def _cfg(case):
    arch, over, _ = CASES[case]
    return tcfgs.get_config(arch, smoke=True).replace(dtype=torch.float32,
                                                      **over)


def _inputs(cfg, seq, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, seq)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens),
             "weights": torch.from_numpy(
                 rng.uniform(0.5, 2.0, BATCH).astype(np.float32))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (BATCH, seq, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["tokens"] = batch["tokens"][:, cfg.num_patches:].contiguous()
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (BATCH, cfg.num_patches, cfg.d_model)).astype(np.float32))
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, 1))
                              .astype(np.int32)) for _ in range(STEPS)]
    return batch, steps


def _whole(x):
    return x.full_tensor() if isinstance(x, tshd.DTensor) else x


def _run(case, mesh):
    """Every output of the case's calls, whole; under ``mesh`` (or none)
    with the arch's rules. The cache's placements are kept as strings."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = _cfg(case)
    seq = CASES[case][2]
    skel = tapi.skeleton(cfg)
    params = tparam.init_params(skel, prng.PRNGKey(0), device="cpu")
    batch, steps = _inputs(cfg, seq)
    out = {}
    with tshd.use_mesh(mesh, tshd.build_rules(cfg, mesh)), \
            implicit_replication():
        if mesh is not None:
            where = dict(tparam.leaves(tparam.param_shardings(skel, mesh)))
            params = tparam.map_tree(
                lambda p, t: tshd.distribute(t, where[p]), params)
        batch = tts.shard_batch(batch)
        loss, _, grads = tts._grads(tapi.loss_fn(cfg), params, batch)
        out["loss"] = _whole(loss)
        out["grads"] = {p: _whole(g).clone()
                        for p, g in tparam.leaves(grads)}
        with torch.no_grad():
            # S + 4 slots: divisible by the mesh's 2, so a sequence rule
            # does shard the cache
            logits, state = tapi.prefill_fn(cfg)(params, batch,
                                                 max_len=seq + 4)
            out["prefill"] = _whole(logits)
            for i, tok in enumerate(steps):
                logits, state = tapi.decode_fn(cfg)(
                    params, state, tts.shard_batch({"t": tok})["t"])
                out[f"decode{i}"] = _whole(logits)
        cache = tapi.state_tree(state)
        if isinstance(cache.get("k"), tshd.DTensor):
            out["cache_placements"] = [str(p) for p in cache["k"].placements]
        state = topt.init_state(params, mesh, OPT,
                                skeleton=skel if mesh is not None else None)
        state, metrics = topt.apply_updates(state, grads, OPT)
        out["grad_norm"] = _whole(metrics["grad_norm"])
        for field in ("params", "master", "mu", "nu"):
            out[field] = {p: _whole(t) for p, t in
                          tparam.leaves(getattr(state, field))}
    return out


def _rank_cases(rank, world, init, out_dir):
    init_group(rank, world, init)
    try:
        from repro_torch.launch import mesh as tmesh
        mesh = tmesh._device_mesh((2, 2), ("data", "model"), "cpu")
        got = {case: _run(case, mesh) for case in CASES}
        if rank == 0:
            torch.save(got, os.path.join(out_dir, "mesh.pt"))
    finally:
        tdist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_parity")
    spawn_ranks(_rank_cases, (str(d),), d, nprocs=4, timeout_s=TIMEOUT_S)
    return torch.load(d / "mesh.pt")


def _fields(out):
    """``field → [(name, tensor)]`` of one run's outputs."""
    res = {}
    for k, v in out.items():
        if k == "cache_placements":
            continue
        field = "decode" if k.startswith("decode") else k
        items = v.items() if isinstance(v, dict) else [(k, v)]
        res.setdefault(field, []).extend(items)
    return res


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_run_matches_no_mesh(case, mesh_runs):
    got, want = mesh_runs[case], _run(case, None)
    if case in CACHE_MODEL_DIM:
        assert got["cache_placements"][1] == (
            f"S({CACHE_MODEL_DIM[case]})"), got["cache_placements"]
    gf, wf = _fields(got), _fields(want)
    assert sorted(gf) == sorted(wf)
    for field, items in wf.items():
        scale = max(float(t.abs().max()) for _, t in items if t.numel())
        g = dict(gf[field])
        assert sorted(g) == sorted(n for n, _ in items), field
        for name, t in items:
            assert g[name].shape == t.shape, (field, name)
            err = float((g[name] - t).abs().max()) if t.numel() else 0.0
            assert err <= RTOL * scale, (field, name, err, scale)
