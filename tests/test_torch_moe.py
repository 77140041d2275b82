"""The port's MoE family (``models/moe.py`` inside ``models/transformer``:
``granite-moe-3b-a800m``, and ``kimi-k2-1t-a32b`` with its shared expert
and one leading dense layer) against the reference's, on the CPU, at the
smoke configs.

``init_params`` bit for bit; the capacities (Python arithmetic), the
router's expert ids, and the dispatch plan's slots, keep mask and
``n_i/C`` scale bit for bit under both overflow policies (the reservoir
policy's uniforms are ``prng``'s, the reference's words); ``moe_ffn``
under both policies, in training / prefill shape (a group per batch row)
and decode shape (the batch one group), and the load-balancing loss in
f32 within rtol 1e-5 / atol 1e-6; ``loss_fn`` and its grads,
``prefill_fn`` / ``decode_fn`` logits and KV caches, and
``Server.generate`` at the tolerances of ``_torch_family``; one bf16 case
(the loss within rtol 2e-3 and the logits within 4e-2 of their largest;
5.4e-5 and 2.7e-3 seen).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_family import (ATOL, RTOL, _one_torch_thread,  # noqa: F401
                           check_bf16, check_generate, check_init_bitwise,
                           check_loss_and_grads, check_prefill_decode, cfgs,
                           models, same_bits)
from repro.models import moe as jmoe
from repro_torch import prng
from repro_torch.models import moe as tmoe

GRANITE, KIMI = "granite-moe-3b-a800m", "kimi-k2-1t-a32b"
_reference_ffn = jax.jit(jmoe.moe_ffn, static_argnums=2)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _moe_params(arch, seed=0):
    """The smoke config's first MoE layer's params in both packages."""
    jcfg, tcfg = cfgs(arch)
    jp, tp = models(jcfg, seed)
    return (jcfg, jax.tree.map(lambda a: a[0], jp["moe_layers"]["moe"]),
            tcfg, {k: v[0] if isinstance(v, torch.Tensor) else
                   {kk: vv[0] for kk, vv in v.items()}
                   for k, v in tp["moe_layers"]["moe"].items()})


@pytest.mark.parametrize("arch,dtype", [(GRANITE, "float32"),
                                        (GRANITE, "bfloat16"),
                                        (KIMI, "float32")])
def test_init_params_bitwise(arch, dtype):
    tp = check_init_bitwise(arch, dtype)
    assert tp["moe_layers"]["moe"]["router"].dtype == torch.float32
    if arch == KIMI:
        assert tp["dense_layers"]["mlp"]["w_in"].shape == (1, 64, 128)
        assert "shared" in tp["moe_layers"]["moe"]
    else:
        assert "dense_layers" not in tp


def test_capacities_match_reference():
    for arch in (GRANITE, KIMI):
        _, tcfg = cfgs(arch)
        for tg in (1, 3, 8, 24, 100, 2048):
            k, e = tcfg.num_experts_per_token, tcfg.num_experts
            assert tmoe.capacity_of(tcfg, tg) == max(
                int(tg * k * tcfg.capacity_factor / e), 4)


@pytest.mark.parametrize("policy", ["positional", "reservoir"])
def test_dispatch_indices_bitwise(policy):
    """Three groups of 60 assignments over 8 experts, capacity 4 (most
    experts overflow): slots, keep and gate scale bit for bit."""
    g, a, e, cap = 3, 60, 8, 4
    rng = np.random.default_rng(5)
    eids = rng.integers(0, e, (g, a)).astype(np.int32)
    gates = rng.uniform(0.1, 1.0, (g, a)).astype(np.float32)
    keys = None
    if policy == "reservoir":
        keys = jax.random.split(jax.random.PRNGKey(0), g)
    plan = jax.jit(jmoe._dispatch_indices, static_argnums=(2, 3))
    want = [plan(jnp.asarray(eids[i]), jnp.asarray(gates[i]), cap, e,
                 None if keys is None else keys[i]) for i in range(g)]
    got = tmoe._dispatch_indices(
        torch.from_numpy(eids), torch.from_numpy(gates), cap, e,
        None if keys is None else prng.split(prng.PRNGKey(0), g))
    for j, name in enumerate(("dst", "keep", "scale")):
        same_bits(np.stack([np.asarray(w[j]) for w in want]), got[j], name)
    assert int(got[1].sum()) < g * a          # some assignments dropped


@functools.partial(jax.jit, static_argnums=0)
def _reference_route(jcfg, jparams, xg):
    """The reference's router, top-k and dispatch plan, as ``moe_ffn``
    computes them."""
    e, k = jcfg.num_experts, jcfg.num_experts_per_token
    g, tg, _ = xg.shape
    logits = jnp.einsum("gtd,de->gte", xg, jparams["router"])
    gates, eids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    gates = gates / jnp.maximum(jnp.sum(gates, -1, keepdims=True), 1e-9)
    cap = max(int(tg * k * jcfg.capacity_factor / e), 4)
    keys = jax.random.split(jax.random.PRNGKey(0), g)
    plan = [jmoe._dispatch_indices(
        eids[i].reshape(-1), gates[i].reshape(-1), cap, e,
        keys[i] if jcfg.reservoir_routing else None) for i in range(g)]
    return eids, gates, [jnp.stack([p[j] for p in plan])
                         for j in range(3)]


@pytest.mark.parametrize("reservoir", [False, True],
                         ids=["positional", "reservoir"])
@pytest.mark.parametrize("shape", [(3, 40), (24, 1)],
                         ids=["prefill", "decode"])
def test_moe_ffn_matches_reference(reservoir, shape):
    """The router's expert ids and the plan bit for bit, the gates and
    the layer's output within rtol 1e-5 / atol 1e-6."""
    jcfg, jparams, tcfg, tparams = _moe_params(GRANITE)
    jcfg = jcfg.replace(reservoir_routing=reservoir)
    tcfg = tcfg.replace(reservoir_routing=reservoir)
    b, s = shape
    x = _normal(7, (b, s, jcfg.d_model))
    groups, tg = (b, s) if s > 1 else (1, b)
    xg = x.reshape(groups, tg, -1)
    eids, gates, plan = _reference_route(jcfg, jparams, jnp.asarray(xg))
    teids, tgates, *tplan = tmoe.route(tparams, torch.from_numpy(xg), tcfg)
    same_bits(eids, teids, "eids")
    np.testing.assert_allclose(tgates.numpy(), np.asarray(gates),
                               rtol=RTOL, atol=ATOL)
    for name, a, t in zip(("dst", "keep"), plan, tplan):
        same_bits(a, t, name)
    np.testing.assert_allclose(tplan[2].numpy(), plan[2], rtol=RTOL,
                               atol=ATOL)
    want = _reference_ffn(jparams, jnp.asarray(x), jcfg)
    got = tmoe.moe_ffn(tparams, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_shared_expert_and_balancing_loss_match_reference():
    jcfg, jparams, tcfg, tparams = _moe_params(KIMI)
    x = _normal(8, (2, 17, jcfg.d_model))
    want = _reference_ffn(jparams, jnp.asarray(x), jcfg)
    got = tmoe.moe_ffn(tparams, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    probs = np.random.default_rng(2).dirichlet(np.ones(8), (5, 6)).astype(
        np.float32)
    eids = np.random.default_rng(3).integers(0, 8, (5, 6, 2)).astype(
        np.int32)
    np.testing.assert_allclose(
        float(tmoe.load_balancing_loss(torch.from_numpy(probs),
                                       torch.from_numpy(eids), 8)),
        float(jmoe.load_balancing_loss(jnp.asarray(probs),
                                       jnp.asarray(eids), 8)), rtol=RTOL)


@pytest.mark.parametrize("arch,kw", [
    (GRANITE, {}), (GRANITE, {"reservoir_routing": True, "remat": "full"}),
    (KIMI, {})], ids=["granite", "granite_reservoir_remat", "kimi"])
def test_loss_and_grads_match_reference(arch, kw):
    check_loss_and_grads(arch, **kw)


@pytest.mark.parametrize("arch", [GRANITE, KIMI])
def test_prefill_and_decode_match_reference(arch):
    check_prefill_decode(arch)


def test_generate_matches_reference(monkeypatch):
    check_generate(GRANITE, monkeypatch)


def test_bf16_matches_reference():
    check_bf16(GRANITE)
