"""The port's vision-language family (``models/vlm.py``,
``internvl2-76b``) against the reference's, on the CPU, at the smoke
config (2 layers, d_model 64, GQA 4/2, 8 patches, attention blocks of
32).

``init_params`` bit for bit (f32 and bf16) and carried across the
packages; the hidden states over the patches and the text within the
whole model's rtol 1e-4 / atol 1e-5; ``loss_fn`` (text positions only)
and its grads (plain and ``remat="full"``), ``prefill_fn`` /
``decode_fn`` logits and the KV cache over patches + prompt (position
``P + S`` bit for bit) for 3 decode steps with the cache allocated to
the prompt (each step rewrites its last slot) and with room,
``init_decode_state``, one ``make_train_step`` step (whole and in two
microbatches), ``Server.generate`` and ``launch/serve --arch`` at the
tolerances of ``_torch_family``; the dense path without patches
unchanged; one bf16 case (the loss within rtol 2e-3 and the logits
within 4e-2 of their largest).
"""
import jax
import numpy as np
import pytest
import torch

from _torch_family import (MODEL_ATOL, MODEL_RTOL,
                           _one_torch_thread,  # noqa: F401
                           batches, cfgs, check_bf16, check_generate,
                           check_init_bitwise, check_launch_serve,
                           check_loss_and_grads, check_prefill_decode,
                           check_train_step, close_trees, models, same_bits,
                           tokens)
from repro.models import api as japi
from repro.models import transformer as jtr
from repro_torch.models import api as tapi
from repro_torch.models import param as tparam
from repro_torch.models import transformer as ttr

ARCH = "internvl2-76b"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_bitwise(dtype):
    tp = check_init_bitwise(ARCH, dtype)
    assert sorted(tp) == ["dense_layers", "embed", "final_ln", "unembed"]
    assert tp["dense_layers"]["attn"]["wq"].shape == (2, 64, 2, 2, 16)


def test_params_carry_over_round_trip():
    jcfg, _ = cfgs(ARCH)
    jp, tp = models(jcfg, seed=5)
    assert [p for p, _ in tparam.leaves(tp)] == \
        [p for p, _ in tparam.leaves(jp)]
    back = tparam.params_to_reference(tp)
    for (p, a), (_, b) in zip(tparam.leaves(jp), tparam.leaves(back)):
        same_bits(a, b, p)


@pytest.mark.parametrize("patches", [True, False],
                         ids=["patches", "text_only"])
def test_hidden_states_match_reference(patches):
    """``hidden_states`` with the 8 patches prepended (positions over
    both: 8 + 30 = 38, two attention blocks) and without them (the dense
    path as it was)."""
    jcfg, tcfg = cfgs(ARCH)
    jp, tp = models(jcfg, seed=2)
    jb, tb = batches(jcfg, tokens(2, (2, 30)), 2)
    je = jb["patches"] if patches else None
    te = tb["patches"] if patches else None
    want = jax.jit(lambda p, t, e: jtr.hidden_states(
        p, t, jcfg, extra_embeds=e))(jp, jb["tokens"], je)
    with torch.inference_mode():
        got = ttr.hidden_states(tp, tb["tokens"], tcfg, extra_embeds=te)
    assert tuple(got.shape) == (2, 38 if patches else 30, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=MODEL_RTOL, atol=MODEL_ATOL)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_reference(remat):
    check_loss_and_grads(ARCH, remat=remat)


def test_loss_covers_the_text_only():
    """``tokens`` in the loss metrics counts the text's targets (the
    patches' positions cut off before the cross entropy)."""
    jcfg, tcfg = cfgs(ARCH)
    _, tp = models(jcfg)
    _, tb = batches(jcfg, tokens(4, (3, 16)), 4)
    with torch.no_grad():
        _, metrics = tapi.loss_fn(tcfg)(tp, tb)
    assert float(metrics["tokens"]) == 3 * 15


@pytest.mark.parametrize("max_len", [0, 40])
def test_prefill_and_decode_match_reference(max_len):
    """The cache holds the 8 patches and the 21 prompt tokens; with
    ``max_len=0`` every decode step rewrites slot 28 in both packages,
    with 40 the steps fill slots 29-31."""
    (_, t0), (j3, t3) = check_prefill_decode(ARCH, max_len=max_len)
    assert t3["k"].shape[2] == max(max_len, 29)
    assert int(t3["position"]) == int(j3["position"]) == 32
    written = [not torch.equal(t3["k"][:, :, i], t0["k"][:, :, i])
               for i in range(t3["k"].shape[2])]
    if max_len == 0:
        assert written == [False] * 28 + [True]
    else:
        assert written == [False] * 29 + [True] * 3 + [False] * 8


def test_init_decode_state_matches_reference():
    jcfg, tcfg = cfgs(ARCH)
    js = japi.init_decode_state(jcfg, 3, 40)
    ts = tapi.init_decode_state(tcfg, 3, 40, device="cpu")
    close_trees(tapi.state_tree(js), tapi.state_tree(ts), 0.0)
    assert ts.k.shape == (2, 3, 56, 2, 16)
    assert int(ts.position) == 40


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    check_train_step(ARCH, microbatches=microbatches)


def test_generate_matches_reference(monkeypatch):
    check_generate(ARCH, monkeypatch)


def test_launch_serve_prints_the_reference_line(monkeypatch, capsys):
    check_launch_serve(ARCH, monkeypatch, capsys)


def test_bf16_matches_reference():
    check_bf16(ARCH)
