"""Shared parity checks of one model family, reference against port, on
the CPU (``test_torch_xlstm.py``, ``_moe.py``, ``_rglru.py``,
``_encdec.py``, ``_vlm.py``).

The same numpy inputs, made from a seed (with the frontend stubs'
``frames`` or ``patches`` for the encdec and vlm families,
:func:`extras`), and the reference's weights
carried over by ``params_from_reference`` go through both packages at
the family's smoke config; the reference's whole-model calls are jitted,
as its own server and train step jit them. Tolerances are the dense family's
(``test_torch_models.py``, ``test_torch_train.py``): the whole model in
f32 within rtol 1e-4 / atol 1e-5 (logits and states), the loss within
rtol 1e-5, the grads within rtol 1e-4 or 1e-6 of the leaf's largest
magnitude; integer state bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import api as japi
from repro.models import param as jparam
from repro.serve import serve_step as jserve
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs as tcfgs
from repro_torch import prng
from repro_torch.models import api as tapi
from repro_torch.models import param as tparam
from repro_torch.serve import serve_step as tserve
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

RTOL, ATOL = 1e-5, 1e-6              # cells and blocks, f32
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5  # whole model, f32
LOSS_RTOL = 1e-5                     # f32 loss
GRAD_RTOL, NEAR_ZERO = 1e-4, 1e-6    # f32 grads
GAP = 1e-3                           # top-2 logit gap under greedy decode
BF16_LOSS_RTOL = 2e-3                # bf16 loss (the dense bf16 runs')
BF16_LOGIT_TOL = 4e-2                # bf16 logits, of their largest


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the suite runs several worker
    processes on the same cores, and torch's thread pool contending with
    them makes these many small operations tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch, dtype="float32", **kw):
    """The smoke config of ``arch`` in ``dtype``, in both packages."""
    return (jcfgs.get_config(arch, smoke=True).replace(
                dtype=getattr(jnp, dtype), **kw),
            tcfgs.get_config(arch, smoke=True).replace(
                dtype=getattr(torch, dtype), **kw))


@functools.lru_cache(maxsize=None)
def _reference_params(jcfg, seed):
    """The reference's ``init_params`` (eager, as its launchers call it)
    on the host, once per config and seed in a process: its first call
    compiles a draw per leaf shape, seconds per config."""
    return jax.device_get(jparam.init_params(japi.skeleton(jcfg),
                                             jax.random.PRNGKey(seed)))


def models(jcfg, seed=0):
    """The reference's params and a fresh port copy of them."""
    jp = _reference_params(jcfg, seed)
    return jp, tparam.params_from_reference(jp, "cpu")


def tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def extras(jcfg, seed, batch, seq):
    """The frontend stubs' inputs of ``jcfg``'s family, f32 from
    ``seed``: encdec ``frames [B, seq + 19, D]`` (the memory longer than
    the target and a ragged last attention block at the smoke chunks of
    32), vlm ``patches [B, P, D]``; none for the decoder-only ones."""
    rng = np.random.default_rng(seed + 1000)
    if jcfg.family == "encdec":
        return {"frames": rng.normal(size=(batch, seq + 19, jcfg.d_model))
                .astype(np.float32)}
    if jcfg.family == "vlm":
        return {"patches": rng.normal(
            size=(batch, jcfg.num_patches, jcfg.d_model)).astype(np.float32)}
    return {}


def batches(jcfg, toks, seed, **more):
    """One numpy batch (``tokens``, the family's :func:`extras` and
    ``more``) for each package: ``(jax batch, torch batch)``."""
    b = dict(tokens=toks, **extras(jcfg, seed, *toks.shape), **more)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in b.items()})


def as_np(t):
    """A tensor (bf16 included) or array as a numpy array."""
    if isinstance(t, torch.Tensor):
        return tparam.params_to_reference({"x": t})["x"]
    return np.asarray(t)


def same_bits(a, b, what=""):
    a, b = as_np(a), as_np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a.reshape(-1).view(np.uint8),
                          b.reshape(-1).view(np.uint8)), what


def close_trees(jtree, ttree, rtol, atol=0.0, near_zero=0.0):
    """Every leaf of the two trees (the same paths) within ``rtol`` and
    ``atol`` plus ``near_zero`` times the leaf's largest magnitude; bf16
    compared as f32, integer leaves bit for bit."""
    jl = dict(tparam.leaves(jax.device_get(jtree)))
    tl = dict(tparam.leaves(ttree))
    assert jl.keys() == tl.keys()
    for p in jl:
        a, b = np.asarray(jl[p]), as_np(tl[p])
        assert a.shape == b.shape, p
        if np.issubdtype(a.dtype, np.integer):
            same_bits(a, b, p)
            continue
        a, b = a.astype(np.float32), b.astype(np.float32)
        np.testing.assert_allclose(
            b, a, rtol=rtol,
            atol=atol + near_zero * float(np.max(np.abs(a), initial=0)),
            err_msg=p)


def check_init_bitwise(arch, dtype):
    """``init_params`` of the full smoke skeleton bit for bit the
    reference's, with the reference's paths and list structure."""
    jcfg, tcfg = cfgs(arch, dtype)
    jp = _reference_params(jcfg, 0)
    tp = tparam.init_params(tapi.skeleton(tcfg), prng.PRNGKey(0),
                            device="cpu")
    back = tparam.params_to_reference(tp)
    assert [p for p, _ in tparam.leaves(back)] == \
        [p for p, _ in tparam.leaves(jp)]
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jp)
    for (p, a), (_, b) in zip(tparam.leaves(jp), tparam.leaves(back)):
        same_bits(a, b, p)
    return tp


def check_prefill_decode(arch, steps=3, seed=0, shape=(3, 21),
                         rtol=MODEL_RTOL, atol=MODEL_ATOL, dtype="float32",
                         max_len=0):
    """``prefill_fn`` (with ``max_len``: 0 allocates exactly the prompt,
    so every decode step rewrites its last slot in both packages) then
    ``steps`` of ``decode_fn`` on the reference's greedy tokens: logits
    and every leaf of the serving state within the tolerance, integers
    (positions) bit for bit. Returns the reference's and the port's
    states after prefill and after the decode steps."""
    jcfg, tcfg = cfgs(arch, dtype)
    jp, tp = models(jcfg, seed)
    jb, tb = batches(jcfg, tokens(seed, shape), seed)
    prefill = jax.jit(lambda p, b: japi.prefill_fn(jcfg)(p, b,
                                                          max_len=max_len))
    decode = jax.jit(japi.decode_fn(jcfg))
    jl, jst = prefill(jp, jb)
    with torch.inference_mode():
        tl, tst = tapi.prefill_fn(tcfg)(tp, tb, max_len=max_len)
    seen = [(jax.device_get(tapi.state_tree(jst)), tparam.map_tree(
        lambda _p, t: t.clone(), tapi.state_tree(tst)))]

    def check(jl, tl, jst, tst):
        assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=rtol,
                                   atol=atol)
        close_trees(tapi.state_tree(jst), tapi.state_tree(tst), rtol,
                    atol)
    check(jl, tl, jst, tst)
    for _ in range(steps):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jst = decode(jp, jst, jnp.asarray(nxt))
        with torch.inference_mode():
            tl, tst = tapi.decode_fn(tcfg)(tp, tst, torch.from_numpy(nxt))
        check(jl, tl, jst, tst)
    seen.append((jax.device_get(tapi.state_tree(jst)),
                 tapi.state_tree(tst)))
    return seen


def check_loss_and_grads(arch, seed=0, **kw):
    """``loss_fn`` and its grads in f32 on a weighted batch."""
    jcfg, tcfg = cfgs(arch, **kw)
    jp, tp = models(jcfg, seed)
    w = np.random.default_rng(seed).uniform(0.5, 3.0, 3).astype(np.float32)
    jb, tb = batches(jcfg, tokens(seed + 3, (3, 16)), seed, weights=w)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(jcfg)(p, jb), has_aux=True))(jp)
    live = tparam.map_tree(lambda _p, t: t.clone().requires_grad_(True), tp)
    tl, tm = tapi.loss_fn(tcfg)(live, tb)
    flat = [t for _, t in tparam.leaves(live)]
    grads = dict(zip([p for p, _ in tparam.leaves(live)],
                     torch.autograd.grad(tl, flat)))
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=LOSS_RTOL)
    assert float(tm["loss"].detach()) == float(tl.detach())
    # A gate whose true gradient is 0 (the max-stabilizer's winning
    # branch) keeps only rounding noise: NEAR_ZERO of the largest grad of
    # the whole tree bounds it.
    largest = max(float(np.max(np.abs(np.asarray(g))))
                  for _, g in tparam.leaves(jax.device_get(jg)))
    close_trees(jg, tparam.map_tree(lambda p, _t: grads[p], tp),
                GRAD_RTOL, atol=NEAR_ZERO * largest, near_zero=NEAR_ZERO)


def check_train_step(arch, seed=0, microbatches=1):
    """One f32 ``make_train_step`` step of the smoke config from the same
    state (the port's weights carried to the reference) on a weighted
    batch (split into ``microbatches``, every key of it, frames and
    patches included) against the reference's jitted step, as
    ``test_torch_train``'s
    ``test_family_train_step_matches_reference``: the loss within
    ``LOSS_RTOL``, the grad norm and the moments within ``GRAD_RTOL`` (or
    ``NEAR_ZERO`` of the tree's largest), master and params where the
    first moment is above 1e-3 of the tree's largest, the step bit for
    bit."""
    jcfg, tcfg = cfgs(arch)
    tp = tparam.init_params(tapi.skeleton(tcfg), prng.PRNGKey(seed), "cpu")
    oc = dict(warmup_steps=3)
    js = jopt.init_state(tparam.params_to_reference(tp), None,
                         jopt.OptConfig(**oc))
    ts = topt.train_state_from_reference(jax.device_get(js), "cpu")
    w = np.random.default_rng(seed).uniform(0.5, 3.0, 4).astype(np.float32)
    jb, tb = batches(jcfg, tokens(seed + 5, (4, 16)), seed, weights=w)
    js, jm = jax.jit(jts.make_train_step(jcfg, jopt.OptConfig(**oc),
                                         microbatches))(js, jb)
    ts, tm = tts.make_train_step(tcfg, topt.OptConfig(**oc),
                                 microbatches)(ts, tb)
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
            want, got = np.asarray(jl[p]), as_np(tl[p])
            if f in ("master", "params"):
                moved = np.abs(mu[p]) > 1e-3 * mu_top
                want, got = want[moved], got[moved]
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                       atol=NEAR_ZERO * largest,
                                       err_msg=f"{f}.{p}")


def check_launch_serve(arch, monkeypatch, capsys):
    """``launch/serve --arch`` in both packages under the same fixed-step
    clock, the port on the CPU: the same output line (the prompts,
    frames, patches and tenants the same bits, so the same tokens)."""
    from repro.launch import serve as jlaunch
    from repro_torch.launch import serve as tlaunch
    monkeypatch.setattr(jserve, "time", FixedStepClock())
    monkeypatch.setattr(tserve, "time", FixedStepClock())
    argv = ["--arch", arch, "--requests", "3", "--prompt-len", "8",
            "--steps", "2", "--tenants", "2"]
    jlaunch.main(argv)
    want = capsys.readouterr().out
    assert tlaunch.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.startswith("[serve] generated (3, 3) tokens; ")
    assert got == want


def check_bf16(arch, seed=0):
    """The family in bf16 in both packages: the loss within
    ``BF16_LOSS_RTOL`` and the prefill's logits within ``BF16_LOGIT_TOL``
    of their largest magnitude. Every product of a bf16 activation and an
    f32 weight runs (``torch.matmul`` refuses mixed dtypes where JAX
    promotes); the places the reference rounds to bf16 and the places it
    widens to f32 each move the result by bf16 steps, inside these
    bounds. Returns the two gaps."""
    jcfg, tcfg = cfgs(arch, "bfloat16")
    jp, tp = models(jcfg, seed)
    jb, tb = batches(jcfg, tokens(seed + 1, (2, 24)), seed)
    jl = float(jax.jit(japi.loss_fn(jcfg))(jp, jb)[0])
    with torch.no_grad():
        tl = float(tapi.loss_fn(tcfg)(tp, tb)[0])
    np.testing.assert_allclose(tl, jl, rtol=BF16_LOSS_RTOL)
    jlog, _ = jax.jit(japi.prefill_fn(jcfg))(jp, jb)
    with torch.inference_mode():
        tlog, _ = tapi.prefill_fn(tcfg)(tp, tb)
    a = np.asarray(jlog)
    err = float(np.max(np.abs(tlog.numpy() - a)) / np.max(np.abs(a)))
    assert err <= BF16_LOGIT_TOL, err
    return abs(tl - jl) / abs(jl), err


class FixedStepClock:
    """``perf_counter`` of a ``time`` module stand-in: call ``n`` returns
    the sum of the first ``n`` steps, each a multiple of 2**-12 s that
    varies with ``n``, so every latency is exact and they differ."""

    def __init__(self):
        self.t, self.n = 0.0, 0

    def perf_counter(self) -> float:
        self.n += 1
        self.t += (1 + self.n % 7) * 2.0 ** -12
        return self.t


def check_generate(arch, monkeypatch, capacity=4, steps=6, seed=11):
    """``Server.generate`` in both packages under the same fixed-step
    clock: the tokens equal (the reference's top-2 logit gap above
    ``GAP`` at every step), the telemetry state bit for bit (the port's
    key holds the reference's two u32 words in int64), the telemetry
    mean within rtol 1e-5."""
    monkeypatch.setattr(jserve, "time", FixedStepClock())
    monkeypatch.setattr(tserve, "time", FixedStepClock())
    jcfg, tcfg = cfgs(arch)
    jp, tp = models(jcfg)
    js = jserve.Server(jcfg, jp, num_tenants=4, telemetry_capacity=capacity,
                       seed=3)
    ts = tserve.Server(tcfg, tp, num_tenants=4, telemetry_capacity=capacity,
                       seed=3, device="cpu")
    gaps = []

    def watched(fn):
        def call(*a, **kw):
            logits, state = fn(*a, **kw)
            top = np.sort(np.asarray(logits)[:, -1], axis=-1)[:, -2:]
            gaps.append(float(np.min(top[:, 1] - top[:, 0])))
            return logits, state
        return call
    js.prefill, js.decode = watched(js.prefill), watched(js.decode)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (5, 12)).astype(np.int32)
    tenants = rng.integers(0, 4, 5).astype(np.int32)
    jb, tb = batches(jcfg, toks, seed)
    jout = js.generate(jb, steps=steps, tenant_ids=jnp.asarray(tenants))
    tout = ts.generate(tb, steps=steps,
                       tenant_ids=torch.from_numpy(tenants))
    assert len(gaps) == steps + 1 and min(gaps) > GAP, gaps
    assert tout.dtype == torch.int32
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    for f in ("values", "counts", "capacity"):
        same_bits(getattr(js.telemetry, f), getattr(ts.telemetry, f), f)
    np.testing.assert_array_equal(ts.telemetry.key.numpy(),
                                  np.asarray(js.telemetry.key, np.int64))
    assert int(ts.telemetry.counts.sum()) == 5 * steps
    np.testing.assert_allclose(float(ts.telemetry_mean().value),
                               float(js.telemetry_mean().value), rtol=1e-5)
