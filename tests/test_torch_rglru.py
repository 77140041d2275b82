"""The port's hybrid family (``models/rglru.py``, ``recurrentgemma-9b``)
against the reference's, on the CPU, at the smoke config (pattern
``(rec, rec, attn)``, local window 16).

``init_params`` bit for bit; the RG-LRU gates, the doubling scan against
``rglru_step`` looped over time and against a plain sequential loop (any
length, powers of two or not), the scan against the reference's
``associative_scan`` (another tree order: within rtol 1e-5 / atol 1e-6,
as the cells), the recurrent block and the local-attention block (prefill
and decode) within the whole model's rtol 1e-4 / atol 1e-5; the ring
layout of the attention caches bit for bit (a prompt shorter than the
window, equal to it and past it: the same K/V give the same ring, and a
decode step writes exactly slot ``position % window``); the positions
bit for bit; ``loss_fn`` and its grads, ``prefill_fn`` / ``decode_fn``
logits and states, and ``Server.generate`` at the tolerances of
``_torch_family``; one bf16 case (the loss within rtol 2e-3 and the
logits within 4e-2 of their largest; 3.4e-4 and 1.31e-2 seen).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_family import (ATOL, MODEL_ATOL, MODEL_RTOL, RTOL,
                           _one_torch_thread,  # noqa: F401
                           check_bf16, check_generate, check_init_bitwise,
                           check_loss_and_grads, check_prefill_decode, cfgs,
                           close_trees, models, same_bits)
from repro.models import api as japi
from repro.models import rglru as jrg
from repro_torch.models import api as tapi
from repro_torch.models import rglru as trg

ARCH = "recurrentgemma-9b"
# The reference's blocks, jitted once per shape (eager, each of their
# operations compiles on its own: seconds per call).
_jscan = jax.jit(jrg.rglru_scan)
_jgates = jax.jit(jrg._rg_gates)
_jrec = jax.jit(jrg._rec_block_fwd, static_argnums=(2, 4))
_jattn = jax.jit(jrg._attn_block_fwd, static_argnums=(3, 5))


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _rec_params(seed=0):
    jcfg, tcfg = cfgs(ARCH)
    jp, tp = models(jcfg, seed)
    return jcfg, jp["blocks"][0], tcfg, tp["blocks"][0]


def test_init_params_bitwise():
    tp = check_init_bitwise(ARCH, "float32")
    assert [("lam" in b, "attn" in b) for b in tp["blocks"]] == [
        (True, False), (True, False), (False, True)]


@pytest.mark.parametrize("s", [1, 2, 7, 16, 33])
def test_linear_scan_is_the_sequential_recurrence(s):
    """f64 inputs: the doubling scan against ``h = a·h + b`` step by
    step, within rtol 1e-12 (every level's products are exact but for
    rounding)."""
    g = torch.Generator().manual_seed(s)
    a = torch.rand(2, s, 5, generator=g, dtype=torch.float64)
    b = torch.randn(2, s, 5, generator=g, dtype=torch.float64)
    h, want = torch.zeros(2, 5, dtype=torch.float64), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(trg.linear_scan(a, b), torch.stack(want, 1),
                               rtol=1e-12, atol=1e-12)


def test_rglru_scan_matches_steps_and_reference():
    _, jbp, _, tbp = _rec_params()
    x = _normal(1, (2, 23, 64))
    h0 = _normal(2, (2, 64))
    jh, jlast = _jscan(jbp, jnp.asarray(x), jnp.asarray(h0))
    th, tlast = trg.rglru_scan(tbp, torch.from_numpy(x),
                               torch.from_numpy(h0))
    _close(th, jh)
    _close(tlast, jlast)
    h, outs = torch.from_numpy(h0), []
    for t in range(x.shape[1]):
        out, h = trg.rglru_step(tbp, torch.from_numpy(x[:, t]), h)
        outs.append(out)
    _close(th, torch.stack(outs, 1).numpy())
    _close(tlast, h.numpy())
    for a, w in zip(trg._rg_gates(tbp, torch.from_numpy(x)),
                    _jgates(jbp, jnp.asarray(x))):
        _close(a, w)


@pytest.mark.parametrize("decode", [False, True], ids=["prefill", "decode"])
def test_rec_block_matches_reference(decode):
    jcfg, jbp, tcfg, tbp = _rec_params()
    s = 1 if decode else 19
    x = _normal(3, (2, s, 64))
    jst = tst = None
    if decode:
        jst = {"h": jnp.asarray(_normal(4, (2, 64))),
               "conv": jnp.asarray(_normal(5, (2, 3, 64)))}
        tst = {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}
    jy, jnew = _jrec(jbp, jnp.asarray(x), jcfg, jst, decode)
    ty, tnew = trg._rec_block_fwd(tbp, torch.from_numpy(x), tcfg, tst,
                                  decode)
    _close(ty, jy, MODEL_RTOL, MODEL_ATOL)
    close_trees(jnew, tnew, MODEL_RTOL, MODEL_ATOL)


@pytest.mark.parametrize("s", [5, 16, 37])
def test_ring_tail_bitwise(s):
    """The same K give the same ring: padded below the window, rolled to
    slot ``p % window`` at and past it."""
    w = 16
    k = _normal(s, (2, s, 1, 4))
    pad = max(w - s, 0)
    want = jnp.pad(jnp.asarray(k)[:, -w:], [(0, 0), (0, pad), (0, 0),
                                             (0, 0)])
    if s >= w:
        want = jnp.roll(want, s % w, axis=1)
    same_bits(want, trg.ring_tail(torch.from_numpy(k), w))


@pytest.mark.parametrize("s", [5, 37])
def test_attn_block_matches_reference(s):
    """The local-attention block: prefill of ``s`` tokens, then three
    decode steps against the ring; outputs and rings within the whole
    model's tolerance, each step writing exactly its slot."""
    jcfg, tcfg = cfgs(ARCH)
    jp, tp = models(jcfg)
    jbp, tbp = jp["blocks"][2], tp["blocks"][2]
    x = _normal(6, (2, s, 64))
    pos = jnp.arange(s, dtype=jnp.int32)
    jy, jst = _jattn(jbp, jnp.asarray(x), pos, jcfg, None, False)
    ty, tst = trg._attn_block_fwd(tbp, torch.from_numpy(x),
                                  torch.arange(s, dtype=torch.int32), tcfg)
    _close(ty, jy, MODEL_RTOL, MODEL_ATOL)
    close_trees(jst, tst, MODEL_RTOL, MODEL_ATOL)
    for t in range(3):
        p = s + t
        xt = _normal(10 + t, (2, 1, 64))
        before = tst["k"].clone()
        jy, jst = _jattn(
            jbp, jnp.asarray(xt), jnp.asarray([p], jnp.int32), jcfg, jst,
            True, jnp.asarray(p, jnp.int32))
        ty, tst = trg._attn_block_fwd(
            tbp, torch.from_numpy(xt), torch.tensor([p], dtype=torch.int32),
            tcfg, tst, True, torch.tensor(p, dtype=torch.int32))
        _close(ty, jy, MODEL_RTOL, MODEL_ATOL)
        close_trees(jst, tst, MODEL_RTOL, MODEL_ATOL)
        written = (tst["k"] != before).flatten(2).any(-1).any(0)
        assert written.tolist() == [i == p % 16 for i in range(16)]


def test_loss_and_grads_match_reference():
    check_loss_and_grads(ARCH, remat="full")


def test_prefill_and_decode_match_reference():
    """A prompt past the window (21 > 16 tokens) and three decode steps:
    logits and states within tolerance; the positions and every ring's
    untouched slots bit for bit the prefill's, in both packages alike."""
    (jpre, tpre), (jdec, tdec) = check_prefill_decode(ARCH, shape=(2, 21))
    for st_j, st_t in ((jpre, tpre), (jdec, tdec)):
        same_bits(st_j["position"], st_t["position"], "position")
    assert int(tdec["position"]) == 24
    for i, (jb, tb) in enumerate(zip(jdec["blocks"], tdec["blocks"])):
        if "k" not in jb:
            continue
        for f in ("k", "v"):
            kept = [slot for slot in range(16) if slot not in (5, 6, 7)]
            same_bits(np.asarray(jb[f])[:, kept],
                      np.asarray(jpre["blocks"][i][f])[:, kept], f)
            same_bits(tb[f][:, kept], tpre["blocks"][i][f][:, kept], f)


def test_init_decode_state_matches_reference():
    jcfg, tcfg = cfgs(ARCH)
    js = japi.init_decode_state(jcfg, 2, 30)
    ts = tapi.init_decode_state(tcfg, 2, 30, device="cpu")
    close_trees(js, ts, 0.0)
    assert int(ts["position"]) == 30


def test_generate_matches_reference(monkeypatch):
    check_generate(ARCH, monkeypatch)


def test_bf16_matches_reference():
    check_bf16(ARCH)
