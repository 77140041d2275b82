"""The port's encoder-decoder family (``models/encdec.py``,
``seamless-m4t-large-v2``) against the reference's, on the CPU, at the
smoke config (2 + 2 layers, d_model 64, attention blocks of 32).

``init_params`` bit for bit (f32 and bf16: ``encoder`` and ``decoder``
stacked, in the reference's tree order) and carried across the packages;
the encoder (bidirectional attention over frames longer than one
attention block) within the whole model's rtol 1e-4 / atol 1e-5;
``loss_fn`` and its grads (plain and ``remat="full"``), ``prefill_fn`` /
``decode_fn`` logits and every state leaf (``self_k``/``self_v``,
``cross_k``/``cross_v``, the position bit for bit) over 3 decode steps
with the self-attention cache allocated to the prompt (each step
rewrites its last slot, the reference's clamped write) and with room,
``init_decode_state``, one ``make_train_step`` step (whole and in two
microbatches), ``Server.generate`` and ``launch/serve --arch`` at the
tolerances of ``_torch_family``; a training checkpoint crossing between
the packages bit for bit; one bf16 case (the loss within rtol 2e-3 and
the logits within 4e-2 of their largest).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_family import (MODEL_ATOL, MODEL_RTOL,
                           _one_torch_thread,  # noqa: F401
                           batches, cfgs, check_bf16,
                           check_generate, check_init_bitwise,
                           check_launch_serve, check_loss_and_grads,
                           check_prefill_decode, check_train_step,
                           close_trees, models, same_bits, tokens)
from test_torch_train_checkpoint import _assert_same, _bytes, _trees
from repro.models import api as japi
from repro.models import encdec as jed
from repro.train import checkpoint as jckpt
from repro_torch import prng
from repro_torch.models import api as tapi
from repro_torch.models import encdec as ted
from repro_torch.models import param as tparam
from repro_torch.train import checkpoint as tckpt

ARCH = "seamless-m4t-large-v2"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_bitwise(dtype):
    tp = check_init_bitwise(ARCH, dtype)
    assert list(tp) == ["encoder", "enc_final_ln", "embed", "decoder",
                        "final_ln", "unembed"]
    assert sorted(tp["decoder"]) == ["cross_attn", "ln1", "ln2", "ln_x",
                                     "mlp", "self_attn"]
    assert tp["encoder"]["attn"]["wq"].shape == (2, 64, 4, 1, 16)
    assert tp["decoder"]["cross_attn"]["wk"].shape == (2, 64, 4, 16)


def test_params_carry_over_round_trip():
    jcfg, _ = cfgs(ARCH)
    jp, tp = models(jcfg, seed=5)
    assert [p for p, _ in tparam.leaves(tp)] == \
        [p for p, _ in tparam.leaves(jp)]
    back = tparam.params_to_reference(tp)
    for (p, a), (_, b) in zip(tparam.leaves(jp), tparam.leaves(back)):
        same_bits(a, b, p)


def test_encode_matches_reference():
    jcfg, tcfg = cfgs(ARCH)
    jp, tp = models(jcfg, seed=2)
    jb, tb = batches(jcfg, tokens(2, (2, 30)), 2)
    want = jax.jit(lambda p, f: jed.encode(p, f, jcfg))(jp, jb["frames"])
    with torch.inference_mode():
        got = ted.encode(tp, tb["frames"], tcfg)
    assert tuple(got.shape) == (2, 49, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=MODEL_RTOL, atol=MODEL_ATOL)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_reference(remat):
    check_loss_and_grads(ARCH, remat=remat)


@pytest.mark.parametrize("max_len", [0, 30])
def test_prefill_and_decode_match_reference(max_len):
    """With ``max_len=0`` the self-attention cache holds the 21 prompt
    slots and every decode step rewrites slot 20 in both packages; with
    30 the steps fill slots 21-23. The cross-attention K/V stay as the
    prefill left them."""
    (j0, t0), (j3, t3) = check_prefill_decode(ARCH, max_len=max_len)
    assert t3["self_k"].shape[2] == max(max_len, 21)
    assert int(t3["position"]) == int(j3["position"]) == 24
    for f in ("cross_k", "cross_v"):
        assert torch.equal(t3[f], t0[f])
    written = [not torch.equal(t3["self_k"][:, :, i], t0["self_k"][:, :, i])
               for i in range(t3["self_k"].shape[2])]
    if max_len == 0:
        assert written == [False] * 20 + [True]
    else:
        assert written == [False] * 21 + [True] * 3 + [False] * 6


def test_init_decode_state_matches_reference():
    jcfg, tcfg = cfgs(ARCH)
    for frames in (0, 7):
        js = japi.init_decode_state(jcfg.replace(num_frames=frames), 3, 40)
        ts = tapi.init_decode_state(tcfg.replace(num_frames=frames), 3, 40,
                                    device="cpu")
        close_trees(js, ts, 0.0)
        assert ts["self_k"].shape == (2, 3, 56, 4, 16)
        assert ts["cross_v"].shape[2] == (frames or 40)
        assert int(ts["position"]) == 40


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    check_train_step(ARCH, microbatches=microbatches)


def test_generate_matches_reference(monkeypatch):
    check_generate(ARCH, monkeypatch)


def test_launch_serve_prints_the_reference_line(monkeypatch, capsys):
    check_launch_serve(ARCH, monkeypatch, capsys)


def test_checkpoint_crosses_the_packages(tmp_path):
    """``seamless-m4t-large-v2``'s smoke training state (bf16 params,
    ``encoder`` and ``decoder`` stacks): the same leaf order, a port
    checkpoint restored by the reference and a reference checkpoint
    restored by the port, every leaf bit for bit."""
    _, tcfg = cfgs(ARCH, "bfloat16")
    tp = tparam.init_params(tapi.skeleton(tcfg), prng.PRNGKey(0), "cpu")
    jtree, ttree = _trees(jax.tree.map(
        jnp.asarray, tparam.params_to_reference(tp)))
    _assert_same(jtree, ttree)
    tckpt.save(str(tmp_path / "port"), 1, ttree)
    got = jckpt.restore(str(tmp_path / "port"), 1,
                        jax.tree.map(jnp.zeros_like, jtree))
    for a, b in zip(jax.tree_util.tree_leaves(jtree),
                    jax.tree_util.tree_leaves(got)):
        assert a.dtype == b.dtype and _bytes(a) == _bytes(b)
    jckpt.save(str(tmp_path / "ref"), 2, jtree)
    back = tckpt.restore(str(tmp_path / "ref"), 2, ttree)
    wq = back["state"].params["decoder"]["cross_attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and wq.shape[0] == 2
    _assert_same(jtree, back)


def test_bf16_matches_reference():
    check_bf16(ARCH)
