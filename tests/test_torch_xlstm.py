"""The port's xLSTM family (``models/xlstm.py``, ``xlstm-350m``) against
the reference's, on the CPU, at the smoke config.

``init_params`` bit for bit (f32 and bf16, the ``blocks`` list in the
reference's order); the mLSTM and sLSTM cells, the group norm and the
causal conv in f32 within rtol 1e-5 / atol 1e-6, both blocks (with and
without a carried state) within the whole model's 1e-4 / 1e-5;
``loss_fn`` and its grads (plain and
``remat="full"``), ``prefill_fn`` / ``decode_fn`` logits and states, and
``Server.generate`` at the tolerances of ``_torch_family``; one bf16 case,
where the products ``cpath @ w_if`` (bf16 × f32) and ``cpath @ w_i +
b_i`` (the bf16 product rounded, then the f32 bias) run as the
reference's: the loss within rtol 2e-3 and the logits within 4e-2 of
their largest (5.3e-4 and 1.66e-2 seen).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_family import (ATOL, MODEL_ATOL, MODEL_RTOL, RTOL,
                           _one_torch_thread,  # noqa: F401
                           check_bf16, check_generate, check_init_bitwise,
                           check_loss_and_grads, check_prefill_decode, cfgs,
                           close_trees, models)
from repro.models import api as japi
from repro.models import xlstm as jxl
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.models import xlstm as txl

ARCH = "xlstm-350m"


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_bitwise(dtype):
    tp = check_init_bitwise(ARCH, dtype)
    assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == 2
    assert "w_if" in tp["blocks"][0] and "w_i" in tp["blocks"][1]
    assert tp["blocks"][0]["w_if"].dtype == torch.float32


def test_mlstm_cell_matches_reference():
    b, h, hd = 2, 3, 8
    q, k, v = (_normal(i, (b, h, hd)) for i in range(3))
    i_til, f_til = _normal(3, (b, h), 2.0), _normal(4, (b, h), 2.0) - 1.0
    state = (_normal(5, (b, h, hd, hd)), _normal(6, (b, h, hd)),
             _normal(7, (b, h)))
    for _ in range(3):
        jo, jst = jxl._mlstm_cell(*map(jnp.asarray, (q, k, v, i_til, f_til)),
                                  tuple(map(jnp.asarray, state)))
        to, tst = txl._mlstm_cell(
            *map(torch.from_numpy, (q, k, v, i_til, f_til)),
            tuple(torch.from_numpy(np.array(a)) for a in state))
        _close(to, jo)
        for a, w in zip(tst, jst):
            _close(a, w)
        state = tuple(np.asarray(s) for s in jst)


def test_slstm_cell_matches_reference():
    b, d = 3, 16
    gates = [_normal(i, (b, d), 2.0) for i in range(4)]
    state = (_normal(5, (b, d)), np.abs(_normal(6, (b, d))),
             _normal(7, (b, d)))
    jo, jst = jxl._slstm_cell(*map(jnp.asarray, gates),
                              tuple(map(jnp.asarray, state)))
    to, tst = txl._slstm_cell(*map(torch.from_numpy, gates),
                              tuple(map(torch.from_numpy, state)))
    _close(to, jo)
    for a, w in zip(tst, jst):
        _close(a, w)


def test_groupnorm_and_conv_match_reference():
    x = _normal(0, (2, 5, 16), 3.0) + 1.0
    scale = _normal(1, (16,)) + 1.0
    _close(txl._groupnorm(torch.from_numpy(x), torch.from_numpy(scale), 4),
           jxl._groupnorm(jnp.asarray(x), jnp.asarray(scale), 4))
    w, bias, tail = _normal(2, (4, 16)), _normal(3, (16,)), \
        _normal(4, (2, 3, 16))
    for t in (None, tail):
        jy, jt = jxl._causal_conv(jnp.asarray(w), jnp.asarray(bias),
                                  jnp.asarray(x),
                                  None if t is None else jnp.asarray(t))
        ty, tt = tlayers.causal_conv(
            torch.from_numpy(w), torch.from_numpy(bias), torch.from_numpy(x),
            None if t is None else torch.from_numpy(t))
        _close(ty, jy)
        _close(tt, jt)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_blocks_match_reference(kind, carried):
    """One block over 9 steps, from zero state or from a carried one
    (the decode path's state, here 9 steps at once)."""
    jcfg, tcfg = cfgs(ARCH)
    jp, tp = models(jcfg, seed=2)
    i = 0 if kind == "mlstm" else 1
    x = _normal(8, (2, 9, jcfg.d_model))
    jst = tst = None
    if carried:
        full = japi.init_decode_state(jcfg, 2, 0)["blocks"][i]
        jst = {k: jnp.asarray(_normal(20 + n, v.shape, 0.5))
               for n, (k, v) in enumerate(sorted(full.items()))}
        tst = {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}
    jfn = jxl._mlstm_block if kind == "mlstm" else jxl._slstm_block
    tfn = txl._mlstm_block if kind == "mlstm" else txl._slstm_block
    jy, jnew = jfn(jp["blocks"][i], jnp.asarray(x), jcfg, jst,
                   decode=carried)
    ty, tnew = tfn(tp["blocks"][i], torch.from_numpy(x), tcfg, tst)
    _close(ty, jy, MODEL_RTOL, MODEL_ATOL)
    close_trees(jnew, tnew, MODEL_RTOL, MODEL_ATOL)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_reference(remat):
    check_loss_and_grads(ARCH, remat=remat)


def test_prefill_and_decode_match_reference():
    check_prefill_decode(ARCH)


def test_init_decode_state_matches_reference():
    jcfg, tcfg = cfgs(ARCH)
    js = japi.init_decode_state(jcfg, 3, 40)
    ts = tapi.init_decode_state(tcfg, 3, 40, device="cpu")
    close_trees(js, ts, 0.0)
    assert int(ts["position"]) == 40


def test_generate_matches_reference(monkeypatch):
    check_generate(ARCH, monkeypatch)


def test_bf16_matches_reference():
    check_bf16(ARCH)
