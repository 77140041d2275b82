"""The port's training slice against the reference's, on the CPU, at the
phi4-mini-3.8b smoke config.

The same numpy inputs (made from a seed) and the same state (carried by
``optimizer.train_state_from_reference``) go through both packages:

* ``lm_loss`` and its grads in f32 (plain, with ``remat="full"``, with
  ``logit_chunk``): loss within rtol 1e-5, grads within rtol 1e-4;
* ``lr_at`` and AdamW's ``c1``/``c2`` bit for bit; ``clip_by_global_norm``
  (the norm within rtol 1e-5, the bf16 scale's products within one bf16
  rounding); three ``apply_updates`` steps (master, mu and nu within rtol
  1e-5, step bit for bit);
* ``make_train_step`` with 1 and 2 microbatches, and ``make_eval_step``;
* the straggler helpers bit for bit;
* ``sample_window`` + ``assemble_batch`` (the fold's plain version over
  int32 sequence indices): indices, validity and weights bit for bit;
* one train step of each other decoder-only family (``xlstm-350m``,
  ``granite-moe-3b-a800m``, ``recurrentgemma-9b``) in f32;
* ``launch/train.train`` in both packages, bf16, at phi4 and at the
  default arch (``xlstm-350m``): the same sampled batch every step, the
  losses within rtol 2e-3, and the loss decreasing as the reference's
  ``test_integration.py`` asks.

Each tolerance is stated beside the gap measured on this machine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core import oasrs as joasrs
from repro.launch import train as jlt
from repro.models import api as japi
from repro.models import param as jparam
from repro.models import transformer as jtr
from repro.stream import pipeline as jpipe
from repro.train import optimizer as jopt
from repro.train import straggler as jstr
from repro.train import train_step as jts
from repro_torch import configs as tcfgs
from repro_torch import prng
from repro_torch.core import oasrs as toasrs
from repro_torch.launch import train as tlt
from repro_torch.models import api as tapi
from repro_torch.models import param as tparam
from repro_torch.models import transformer as ttr
from repro_torch.stream import pipeline as tpipe
from repro_torch.distributed import sharding as tshd
from repro_torch.train import optimizer as topt
from repro_torch.train import straggler as tstr
from repro_torch.train import train_step as tts

ARCH = "phi4-mini-3.8b"
LOSS_RTOL = 1e-5          # f32 loss; 0 seen (the same bits)
GRAD_RTOL = 1e-4          # f32 grads (and one step's moments); 7.6e-5 seen
STATE_RTOL = 1e-5         # master / mu / nu after 3 steps; 4.4e-7 seen
NEAR_ZERO = 1e-6          # of a leaf's largest magnitude, where values
                          # cancel to near 0; 4.9e-7 seen
TRAIN_RTOL = 2e-3         # bf16 losses of whole runs; 4.8e-5 seen


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the suite runs several worker
    processes on the same cores, and torch's thread pool contending with
    them makes these many small operations tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    """The smoke config in f32, in both packages."""
    return (jcfgs.get_config(ARCH, smoke=True).replace(dtype=jnp.float32,
                                                       **kw),
            tcfgs.get_config(ARCH, smoke=True).replace(dtype=torch.float32,
                                                       **kw))


def _np(t):
    return tparam.params_to_reference({"x": t})["x"] if isinstance(
        t, torch.Tensor) else np.asarray(t)


def _close(jtree, ttree, rtol, atol=0.0):
    """Every leaf of the two trees within ``rtol``, or within ``atol``
    times the leaf's largest magnitude (values that cancel to near 0 keep
    only the absolute error of their terms); bf16 compared as f32."""
    jl = dict(tparam.leaves(jax.device_get(jtree)))
    tl = dict(tparam.leaves(ttree))
    assert jl.keys() == tl.keys()
    for p in jl:
        a = np.asarray(jl[p], np.float32)
        b = np.asarray(_np(tl[p]), np.float32)
        np.testing.assert_allclose(
            b, a, rtol=rtol, atol=atol * float(np.max(np.abs(a), initial=0)),
            err_msg=p)


def _model(jcfg, seed=0):
    """The reference's params and the port's copy of them."""
    jp = jparam.init_params(japi.skeleton(jcfg), jax.random.PRNGKey(seed))
    return jp, tparam.params_from_reference(jax.device_get(jp), "cpu")


def _batch(vocab, b=4, s=32, seed=3, weights=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    w = rng.uniform(0.5, 3.0, b).astype(np.float32)
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(tokens)}
    if weights:
        jb["weights"], tb["weights"] = jnp.asarray(w), torch.from_numpy(w)
    return jb, tb


# ---------------------------------------------------------------------------
# lm_loss and its grads.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"remat": "full"},
                                {"logit_chunk": 8}],
                         ids=["plain", "remat", "logit_chunk"])
def test_lm_loss_and_grads_f32(kw):
    jcfg, tcfg = _cfg(**kw)
    jp, tp = _model(jcfg)
    jb, tb = _batch(jcfg.vocab_size)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jtr.lm_loss(p, jb["tokens"], jcfg,
                              seq_weights=jb["weights"]), has_aux=True)(jp)
    live = tparam.map_tree(lambda _p, t: t.clone().requires_grad_(True), tp)
    tl, tm = ttr.lm_loss(live, tb["tokens"], tcfg,
                         seq_weights=tb["weights"])
    flat = [t for _, t in tparam.leaves(live)]
    grads = dict(zip([p for p, _ in tparam.leaves(live)],
                     torch.autograd.grad(tl, flat)))
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=LOSS_RTOL)
    assert float(tm["tokens"]) == float(jm["tokens"]) == 4 * 31
    tg = tparam.map_tree(lambda p, _t: grads[p], tp)
    _close(jg, tg, GRAD_RTOL, NEAR_ZERO)


def test_lm_loss_unweighted_and_eval_step():
    jcfg, tcfg = _cfg()
    jp, tp = _model(jcfg, seed=1)
    jb, tb = _batch(jcfg.vocab_size, weights=False)
    want = jts.make_eval_step(jcfg)(jp, jb)
    got = tts.make_eval_step(tcfg)(tp, tb)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=LOSS_RTOL)
    loss, _ = tapi.loss_fn(tcfg)(tp, tb)
    assert not loss.requires_grad


def test_other_families_have_no_loss():
    """The families with a frontend stub (encdec, vlm), without a loss
    until they were ported, now have the reference's: ``loss_fn`` and
    ``make_eval_step`` on a weighted batch with the same frames or
    patches in both packages, within rtol 1e-5 (their grads and train
    steps in ``test_torch_encdec.py`` and ``test_torch_vlm.py``)."""
    from _torch_family import batches
    for arch in ("seamless-m4t-large-v2", "internvl2-76b"):
        jcfg = jcfgs.get_config(arch, smoke=True).replace(dtype=jnp.float32)
        tcfg = tcfgs.get_config(arch, smoke=True).replace(
            dtype=torch.float32)
        jp, tp = _model(jcfg)
        toks = np.random.default_rng(3).integers(0, 512, (4, 16)).astype(
            np.int32)
        w = np.random.default_rng(3).uniform(0.5, 3.0, 4).astype(
            np.float32)
        jb, tb = batches(jcfg, toks, 3, weights=w)
        want = jts.make_eval_step(jcfg)(jp, jb)
        got = tts.make_eval_step(tcfg)(tp, tb)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=LOSS_RTOL)
        loss, _ = tapi.loss_fn(tcfg)(tp, tb)
        np.testing.assert_allclose(float(loss), float(want["loss"]),
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ["xlstm-350m", "granite-moe-3b-a800m",
                                  "recurrentgemma-9b"])
def test_family_train_step_matches_reference(arch):
    """One f32 train step of each decoder-only family beyond dense from
    the same state (the port's weights, carried to the reference, a tree
    with lists of blocks for ssm and hybrid) against the reference's
    jitted step: the loss within 1e-5; the grad norm and the moments
    within the grads' rtol 1e-4 (or 1e-6 of the tree's largest, where
    values cancel to near 0); master and params within rtol 1e-4 where
    the first moment is above 1e-3 of the tree's largest (AdamW's first
    step moves each value by about ``lr`` times the sign of its
    gradient, and a gradient that is rounding noise, such as a gate
    behind the max-stabilizer's winning branch, has a noise sign); step
    bit for bit."""
    jcfg = jcfgs.get_config(arch, smoke=True).replace(dtype=jnp.float32)
    tcfg = tcfgs.get_config(arch, smoke=True).replace(dtype=torch.float32)
    tp = tparam.init_params(tapi.skeleton(tcfg), prng.PRNGKey(0), "cpu")
    oc = dict(warmup_steps=3)
    js = jopt.init_state(tparam.params_to_reference(tp), None,
                         jopt.OptConfig(**oc))
    ts = topt.train_state_from_reference(jax.device_get(js), "cpu")
    assert isinstance(ts.mu.get("blocks", []), list)
    jb, tb = _batch(jcfg.vocab_size, s=16)
    js, jm = jax.jit(jts.make_train_step(jcfg, jopt.OptConfig(**oc)))(js, jb)
    ts, tm = tts.make_train_step(tcfg, topt.OptConfig(**oc))(ts, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=GRAD_RTOL)
    assert int(ts.step) == int(js.step) == 1
    mu = dict(tparam.leaves(jax.device_get(js.mu)))
    mu_top = max(float(np.max(np.abs(a))) for a in mu.values())
    for f in ("mu", "nu", "master", "params"):
        tree = jax.device_get(getattr(js, f))
        largest = max(float(np.max(np.abs(a)))
                      for _, a in tparam.leaves(tree))
        jl, tl = dict(tparam.leaves(tree)), dict(tparam.leaves(
            getattr(ts, f)))
        assert jl.keys() == tl.keys()
        for p in jl:
            want, got = np.asarray(jl[p]), _np(tl[p])
            if f in ("master", "params"):
                moved = np.abs(mu[p]) > 1e-3 * mu_top
                want, got = want[moved], got[moved]
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                       atol=NEAR_ZERO * largest,
                                       err_msg=f"{f}.{p}")


# ---------------------------------------------------------------------------
# The optimizer.
# ---------------------------------------------------------------------------

def test_lr_and_bias_corrections_bitwise():
    cfg_j, cfg_t = jopt.OptConfig(warmup_steps=10), topt.OptConfig(
        warmup_steps=10)
    for step in (0, 1, 5, 10, 11, 100, 999):
        js, ts = jnp.asarray(step, jnp.int32), torch.tensor(
            step, dtype=torch.int32)
        a, b = np.asarray(jopt.lr_at(cfg_j, js)), topt.lr_at(cfg_t, ts)
        assert a.tobytes() == b.numpy().tobytes(), step
        for beta in (cfg_j.b1, cfg_j.b2):
            want = np.asarray(1.0 - beta ** js.astype(jnp.float32))
            sf = ts.float()
            got = 1.0 - prng.xla_pow(torch.full_like(sf, float(
                np.float32(beta))), sf)
            assert want.tobytes() == got.numpy().tobytes(), (step, beta)
    assert float(topt.lr_at(topt.OptConfig(lr=1.0, warmup_steps=10),
                            torch.tensor(5))) == pytest.approx(0.5)


def _grads_like(tree, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {p: (scale * rng.standard_normal(np.shape(a))).astype(np.float32)
            for p, a in tparam.leaves(tree)}


def _nest(flat):
    out = {}
    for p, v in flat.items():
        d = out
        keys = p.split(".")
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = v
    return out


def _both_grads(flat, dtype):
    """The same grads for both packages, in the params' dtype."""
    jg = _nest({p: jnp.asarray(v).astype(dtype) for p, v in flat.items()})
    return jg, tparam.params_from_reference(jax.device_get(jg), "cpu")


@pytest.mark.parametrize("max_norm", [1.0, 1e6])
def test_clip_by_global_norm(max_norm):
    """bf16 grads: the norm within rtol 1e-5 (1.5e-6 seen: the squares
    are summed in another f32 order than XLA's), each scaled grad
    within one bf16 rounding of the reference's (the scale is cast to
    bf16 before the product); unclipped grads are left as they are."""
    jp, _ = _model(jcfgs.get_config(ARCH, smoke=True))
    jg, tg = _both_grads(_grads_like(jp, 5, 0.3), jnp.bfloat16)
    want, wn = jopt.clip_by_global_norm(jg, max_norm)
    before = tparam.params_to_reference(tg)
    got, gn = topt.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-5)
    assert float(wn) > 1.0
    _close(want, got, 2 ** -8)
    if max_norm > float(wn):
        for p, a in tparam.leaves(before):
            assert a.tobytes() == dict(tparam.leaves(
                tparam.params_to_reference(got)))[p].tobytes()


@pytest.mark.parametrize("use_master", [True, False])
def test_apply_updates_three_steps(use_master):
    """bf16 params, the same bf16 grads each step: master, mu and nu
    within rtol 1e-5 (or 1e-6 of the leaf's largest, where a moment
    cancels to near 0), params within one bf16 rounding, step and lr bit
    for bit."""
    jcfg = jcfgs.get_config(ARCH, smoke=True)
    jp, _ = _model(jcfg)
    ocj = jopt.OptConfig(warmup_steps=2, use_master=use_master)
    oct_ = topt.OptConfig(warmup_steps=2, use_master=use_master)
    js = jopt.init_state(jp, None, ocj)
    ts = topt.train_state_from_reference(jax.device_get(js), "cpu")
    for k in range(3):
        flat = _grads_like(jp, 10 + k, 0.05)
        jg, tg = _both_grads(flat, jnp.bfloat16)
        js, jm = jopt.apply_updates(js, jg, ocj)
        ts, tm = topt.apply_updates(ts, tg, oct_)
        assert list(tparam.leaves(tg)) == []
        assert np.asarray(jm["lr"]).tobytes() == tm["lr"].numpy().tobytes()
    assert int(ts.step) == int(js.step) == 3
    assert ts.step.dtype == torch.int32
    for f in ("mu", "nu") + (("master",) if use_master else ()):
        _close(getattr(js, f), getattr(ts, f), STATE_RTOL, NEAR_ZERO)
    _close(js.params, ts.params, 2 ** -8)
    back = topt.train_state_to_reference(ts)
    assert back["step"].dtype == np.int32
    assert str(back["params"]["embed"]["tokens"].dtype) == "bfloat16"


def test_apply_updates_consumes_the_grads_in_place():
    jp, tp = _model(_cfg()[0])
    state = topt.init_state(tp, None, topt.OptConfig())
    assert state.master["embed"]["tokens"].data_ptr() != \
        tp["embed"]["tokens"].data_ptr()
    grads = tparam.map_tree(lambda _p, t: torch.ones_like(t), tp)
    ptr = state.mu["final_ln"]["scale"].data_ptr()
    new, _ = topt.apply_updates(state, grads, topt.OptConfig())
    assert list(tparam.leaves(grads)) == []
    assert new.mu["final_ln"]["scale"].data_ptr() == ptr
    assert new.params is tp and int(new.step) == 1
    # On a mesh the moments fold the data axes into a free divisible dim.
    mesh = tshd.AbstractMesh({"data": 2, "model": 4})
    assert topt.zero_pspec(("model", None), (8, 6), mesh,
                           ("pod", "data")) == ("model", "data")


# ---------------------------------------------------------------------------
# The train step.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("micro", [1, 2])
def test_make_train_step(micro):
    """f32: one step from the same state and batch; the loss within
    1e-5, the new master and the moments within rtol 1e-4 (the grads'
    tolerance; 7.6e-5 seen), lr and step bit for bit."""
    jcfg, tcfg = _cfg()
    jp, _ = _model(jcfg, seed=2)
    oc = dict(warmup_steps=3)
    js = jopt.init_state(jp, None, jopt.OptConfig(**oc))
    ts = topt.train_state_from_reference(jax.device_get(js), "cpu")
    jb, tb = _batch(jcfg.vocab_size, seed=micro)
    js, jm = jts.make_train_step(jcfg, jopt.OptConfig(**oc), micro)(js, jb)
    ts, tm = tts.make_train_step(tcfg, topt.OptConfig(**oc), micro)(ts, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=GRAD_RTOL)
    assert np.asarray(jm["lr"]).tobytes() == tm["lr"].numpy().tobytes()
    assert int(ts.step) == int(js.step) == 1
    for f in ("master", "mu", "nu", "params"):
        _close(getattr(js, f), getattr(ts, f), GRAD_RTOL, NEAR_ZERO)


# ---------------------------------------------------------------------------
# Stragglers.
# ---------------------------------------------------------------------------

def test_straggler_helpers_bitwise():
    w = np.random.default_rng(0).uniform(0.5, 4.0, 8).astype(np.float32)
    alive = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    shard_of = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    want = jstr.reweight_for_stragglers(jnp.asarray(w), jnp.asarray(alive),
                                        jnp.asarray(shard_of))
    got = tstr.reweight_for_stragglers(torch.from_numpy(w),
                                       torch.from_numpy(alive),
                                       torch.from_numpy(shard_of))
    assert np.asarray(want).tobytes() == got.numpy().tobytes()
    for f in (0.0, 0.25, 0.999, 1.0):
        a = jstr.drop_fraction_variance_penalty(jnp.float32(f))
        b = tstr.drop_fraction_variance_penalty(torch.tensor(f))
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    dl = tstr.WindowDeadline(num_shards=3, deadline_sec=60.0)
    dl.mark_arrival(2)
    assert not dl.expired()
    assert dl.alive_mask().tolist() == [0.0, 0.0, 1.0]
    dl.start_window()
    assert dl.alive_mask().sum() == 0
    assert tstr.WindowDeadline(1, -1.0).expired()


# ---------------------------------------------------------------------------
# The sampled batch.
# ---------------------------------------------------------------------------

def test_sample_window_and_batch_bitwise():
    """Six windows through the reference's jitted ``sample_window`` and
    the port's (the fold's plain version, int32 sequence indices), the
    reservoirs carried from window to window: indices, weights, validity
    and the assembled batch bit for bit, whatever the window size."""
    run = tlt.RunConfig(arch=ARCH, batch=8, num_domains=8)
    key = jax.random.PRNGKey(0)
    jres = joasrs.init(8, 1, jax.ShapeDtypeStruct((), jnp.int32),
                       jax.random.fold_in(key, 1), max_capacity=4)
    tres = toasrs.init(8, 1, prng.fold_in(prng.PRNGKey(0), 1),
                       max_capacity=4, dtype=torch.int32, device="cpu")
    jfn = jax.jit(jlt.sample_window)
    for epoch, window in enumerate((16, 16, 64, 5, 16, 64)):
        spec = (window, 32, 8, 512)
        jt, jd = jpipe.synthetic_token_window(jpipe.TokenWindowSpec(*spec),
                                              epoch)
        tt, td = tpipe.synthetic_token_window(tpipe.TokenWindowSpec(*spec),
                                              epoch, device="cpu")
        assert np.asarray(jt).tobytes() == tt.numpy().tobytes()
        jres, ji, jw, jv = jfn(jres, jt, jd)
        tres, ti, tw, tv = tlt.sample_window(tres, tt, td)
        for a, b in ((ji, ti), (jw, tw), (jv, tv), (jres.counts, tres.counts),
                     (jres.values, tres.values)):
            assert np.asarray(a).tobytes() == b.numpy().tobytes(), epoch
        jb = jlt.assemble_batch(jt, ji, jw, jv, run.batch, None)
        tb = tlt.assemble_batch(tt, ti, tw, tv, run.batch)
        for k in ("tokens", "weights"):
            assert np.asarray(jb[k]).tobytes() == tb[k].numpy().tobytes()


# ---------------------------------------------------------------------------
# The launcher, both packages.
# ---------------------------------------------------------------------------

def _recorded(module, monkeypatch):
    """Run ``module.train``'s steps, recording each assembled batch."""
    seen = []
    real = module.assemble_batch

    def record(*a, **kw):
        out = real(*a, **kw)
        seen.append({k: _np(v) for k, v in out.items()})
        return out
    monkeypatch.setattr(module, "assemble_batch", record)
    return seen


@pytest.fixture(scope="module")
def reference_run():
    """The reference's ``train`` for 3 steps (bf16 smoke config): its
    losses and every assembled batch."""
    mp = pytest.MonkeyPatch()
    seen = _recorded(jlt, mp)
    try:
        losses = jlt.train(jlt.RunConfig(arch=ARCH, steps=3))
    finally:
        mp.undo()
    return losses, seen


def test_train_is_the_references(reference_run, monkeypatch, capsys):
    jlosses, jseen = reference_run
    tseen = _recorded(tlt, monkeypatch)
    tlosses = tlt.train(tlt.RunConfig(arch=ARCH, steps=3), device="cpu")
    assert len(tseen) == len(jseen) == 3
    for a, b in zip(jseen, tseen):
        assert a["tokens"].tobytes() == b["tokens"].tobytes()
        assert a["weights"].tobytes() == b["weights"].tobytes()
    np.testing.assert_allclose(tlosses, jlosses, rtol=TRAIN_RTOL)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[train] step    1 epoch 0 loss ")
    assert lines[0].endswith("window 16 → batch 8)")


def test_train_loss_decreases():
    """The reference's ``test_integration.py::test_train_loss_decreases``
    run on the port."""
    losses = tlt.train(tlt.RunConfig(
        arch=ARCH, smoke=True, steps=25, batch=8, seq_len=64,
        sampling_fraction=0.5, checkpoint_dir=""), device="cpu",
        log=lambda *_: None)
    assert len(losses) == 25 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), \
        f"no learning: {losses[:3]} → {losses[-3:]}"


@pytest.fixture(scope="module")
def default_run():
    """The reference's ``train`` at its defaults (``xlstm-350m`` smoke,
    bf16, 20 steps): its losses and every assembled batch."""
    mp = pytest.MonkeyPatch()
    seen = _recorded(jlt, mp)
    try:
        losses = jlt.train(jlt.RunConfig())
    finally:
        mp.undo()
    return losses, seen


def test_default_arch_is_unported(default_run, monkeypatch, capsys):
    """The default ``--arch xlstm-350m`` was unported; it now trains:
    ``train(RunConfig())`` samples the reference's batch every step (bit
    for bit) and its losses are the reference's within rtol 2e-3 (3.5e-4
    seen), and ``main(["--device", "cpu"])`` trains it too."""
    jlosses, jseen = default_run
    tseen = _recorded(tlt, monkeypatch)
    tlosses = tlt.train(tlt.RunConfig(), device="cpu")
    assert len(tseen) == len(jseen) == 20
    for a, b in zip(jseen, tseen):
        assert a["tokens"].tobytes() == b["tokens"].tobytes()
        assert a["weights"].tobytes() == b["weights"].tobytes()
    np.testing.assert_allclose(tlosses, jlosses, rtol=TRAIN_RTOL)
    capsys.readouterr()
    assert tlt.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 21 and out[-1] == (
        f"[train] done; loss {tlosses[0]:.4f} → {tlosses[-1]:.4f}")


def test_cli_on_the_cpu(capsys):
    assert tlt.main(["--arch", ARCH, "--steps", "2", "--batch", "4",
                     "--seq-len", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[train] step    1 epoch 0 loss ")
    assert out[-1].startswith("[train] done; loss ")
